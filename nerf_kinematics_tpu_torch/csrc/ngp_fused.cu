// Fused NGP point pipeline, the forward kernels.
//
// Replaces the TPU kernels of nerf_kinematics_tpu/ops/ngp_fused_pallas.py:
//   ngp_fused_sigma_cf  (_fwd_sigma_kernel)  -> nkt_fused_sigma_kernel
//   ngp_fused_apply_cf forward (_fwd_kernel) -> nkt_fused_apply_kernel
// The device code is in ngp_fused.cuh (shared with the gradient kernels of
// ngp_fused_bwd.cu), where the arithmetic contract is written down.
//
// Bound on this card: operations. 2 * (256*64 + 64*64 + 64*16) = 43.0 kFLOP
// of MLP work per point for sigma and 63.9 kFLOP with the color MLP, against
// 28 / 40 B of device traffic.
#include "ngp_fused.cuh"

__global__ void __launch_bounds__(NKT_THREADS, 1)
    nkt_fused_sigma_kernel(FusedArgs a, FusedLayout lay) {
  const SaveRows none = SaveRows();
  nkt_fused_body<false, false>(a, lay, none, nullptr);
}

__global__ void __launch_bounds__(NKT_THREADS, 1)
    nkt_fused_apply_kernel(FusedArgs a, FusedLayout lay) {
  const SaveRows none = SaveRows();
  nkt_fused_body<true, false>(a, lay, none, nullptr);
}

// Bytes of dynamic shared memory a launch with these arguments asks for.
extern "C" long long nkt_fused_smem_bytes(const FusedArgs* args, int color) {
  return (long long)make_layout(*args, color != 0).total * sizeof(float);
}

// color = 0: sigma kernel (rows 0-2 zero); color = 1: full forward.
// Returns the cudaError_t of the attribute call or the launch, 0 = success.
extern "C" int nkt_fused_forward(const FusedArgs* args, int color, int n_sm,
                                 void* stream) {
  const FusedLayout lay = make_layout(*args, color != 0);
  const size_t bytes = (size_t)lay.total * sizeof(float);
  long long blocks = (args->n + NKT_THREADS - 1) / NKT_THREADS;
  if (blocks > n_sm) blocks = n_sm;
  cudaError_t err;
  if (color) {
    err = cudaFuncSetAttribute(nkt_fused_apply_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    nkt_fused_apply_kernel<<<(unsigned)blocks, NKT_THREADS, bytes,
                             (cudaStream_t)stream>>>(*args, lay);
  } else {
    err = cudaFuncSetAttribute(nkt_fused_sigma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    nkt_fused_sigma_kernel<<<(unsigned)blocks, NKT_THREADS, bytes,
                             (cudaStream_t)stream>>>(*args, lay);
  }
  return (int)cudaGetLastError();
}
