// Fused NGP point pipeline, the forward kernels.
//
// Replaces the TPU kernels of nerf_kinematics_tpu/ops/ngp_fused_pallas.py:
//   ngp_fused_sigma_cf  (_fwd_sigma_kernel)  -> nkt_mma_sigma_kernel (bf16)
//                                               nkt_fused_sigma_kernel (f32)
//   ngp_fused_apply_cf forward (_fwd_kernel) -> nkt_apply_tile_kernel (bf16,
//                                               ngp_apply.cu)
//                                               nkt_fused_apply_kernel (f32)
// The device code is in nkt_mma.cuh (row 2's bf16 body, tensor cores),
// ngp_apply.cu (row 3's bf16 kernel) and ngp_fused.cuh (f32 mode, FMA pipe;
// the arithmetic contract of all).
//
// Bound on this card: operations. 2 * (256*64 + 64*64 + 64*16) = 43.0 kFLOP
// of MLP work per point for sigma and 63.9 kFLOP with the color MLP, against
// 28 / 40 B of device traffic. In bf16 mode those products run on the tensor
// cores; what remains is the encoder's 6 table rows per point and level
// (768 B of L2 traffic per level at machina's widths), its tap arithmetic
// and the exact re-sums: the bf16 kernels hide the gathers behind other
// warps' (row 3: also their own) products; ngp_apply.cu says how row 3's
// kernel takes the rest.
#include "nkt_mma.cuh"

__global__ void __launch_bounds__(NKT_THREADS, 1)
    nkt_fused_sigma_kernel(FusedArgs a, FusedLayout lay) {
  const SaveRows none = SaveRows();
  nkt_fused_body<false, false>(a, lay, none, nullptr, nullptr);
}

__global__ void __launch_bounds__(NKT_THREADS, 1)
    nkt_fused_apply_kernel(FusedArgs a, FusedLayout lay) {
  const SaveRows none = SaveRows();
  nkt_fused_body<true, false>(a, lay, none, nullptr, nullptr);
}

__global__ void __launch_bounds__(NKT_MMA_MAX_WARPS * 32, 1)
    nkt_mma_sigma_kernel(FusedArgs a, MmaLayout lay) {
  nkt_mma_body(a, lay);
}

// Row 3's bf16 kernel (ngp_apply.cu).
int nkt_apply_forward(const FusedArgs& a, int n_sm, cudaStream_t st);
long long nkt_apply_smem_bytes(const FusedArgs& a);

// Bytes of dynamic shared memory a launch with these arguments asks for.
extern "C" long long nkt_fused_smem_bytes(const FusedArgs* args, int color) {
  if (args->cp.use_bf16)
    return color ? nkt_apply_smem_bytes(*args) : make_mma_layout_fwd(*args).total;
  return (long long)make_layout(*args, color != 0).total * sizeof(float);
}

// The bf16 forward: row 3's kernel with color; else one warp per 16 points,
// lay.warps warps a block.
static int mma_forward(const FusedArgs& a, bool color, int n_sm,
                       cudaStream_t st) {
  if (color) return nkt_apply_forward(a, n_sm, st);
  if (!mma_dims_ok(a, false)) return (int)cudaErrorInvalidValue;
  const MmaLayout lay = make_mma_layout_fwd(a);
  const size_t bytes = (size_t)lay.total;
  const long long tiles = (a.n + NKT_MT - 1) / NKT_MT;
  const int threads = lay.warps * 32;
  const long long want = (tiles + lay.warps - 1) / lay.warps;
  if (want < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      nkt_mma_sigma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      persistent_blocks(nkt_mma_sigma_kernel, threads, bytes, want, n_sm);
  nkt_mma_sigma_kernel<<<(unsigned)blocks, threads, bytes, st>>>(a, lay);
  return (int)cudaGetLastError();
}

// color = 0: sigma kernel (rows 0-2 zero); color = 1: full forward.
// Returns the cudaError_t of the attribute call or the launch, 0 = success.
extern "C" int nkt_fused_forward(const FusedArgs* args, int color, int n_sm,
                                 void* stream) {
  const cudaError_t scan = nkt_table_scan(args->lines, args->cp, true, (cudaStream_t)stream);
  if (scan != cudaSuccess) return (int)scan;
  if (args->cp.use_bf16)
    return mma_forward(*args, color != 0, n_sm, (cudaStream_t)stream);
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
