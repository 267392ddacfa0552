"""Sinusoidal positional encoding gamma(p) of the classic engine.

For L=10 with the raw input included, the xyz encoding is 3 + 3*2*10 = 63
wide (the reference checkpoints' ``layer1.weight (128, 63)``); directions at
L=4 give 27. Row order: the raw input first, then for each frequency f
``[sin(f x), sin(f y), sin(f z), cos(f x), cos(f y), cos(f z)]``.
"""

from __future__ import annotations

import torch


def encoding_dim(in_dim: int, num_freqs: int, include_input: bool = True) -> int:
    return in_dim * (2 * num_freqs + (1 if include_input else 0))


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True,
                        log_sampling: bool = True) -> torch.Tensor:
    """gamma(x), channels last: (..., D) -> (..., encoding_dim(D, L)).
    Frequencies 2^0 .. 2^(L-1) with ``log_sampling``, else L values evenly
    spaced from 1 to 2^(L-1)."""
    if num_freqs == 0:
        return x if include_input else x[..., :0]
    freqs = torch.tensor(frequencies(num_freqs, log_sampling), dtype=x.dtype,
                         device=x.device)
    xb = x[..., None, :] * freqs[:, None]  # (..., L, D)
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def frequencies(num_freqs: int, log_sampling: bool):
    """The frequencies as Python floats: exact powers of two, or
    ``1 + (2^(L-1) - 1) k / (L - 1)`` in double precision, which rounds to
    the reference's f32 ``linspace`` values (a last-bit difference of a
    frequency moves sin(f x) by 2e-4 at f x ~ 3000)."""
    if log_sampling:
        return [2.0**k for k in range(num_freqs)]
    lo, hi = 1.0, 2.0 ** (num_freqs - 1)
    return [lo + (hi - lo) * k / max(num_freqs - 1, 1) for k in range(num_freqs)]


def encoding_rows(xt: torch.Tensor, num_freqs: int, include_input: bool,
                  log_sampling: bool) -> torch.Tensor:
    """Channels-first gamma: (3, N) -> (encoding_dim, N), the same row order
    as :func:`positional_encoding`, with the fused kernel's frequencies."""
    rows = [xt] if include_input else []
    for f in frequencies(num_freqs, log_sampling):
        xb = xt * f
        rows.append(torch.sin(xb))
        rows.append(torch.cos(xb))
    if not rows:
        return xt[:0]
    return torch.cat(rows, dim=0)
