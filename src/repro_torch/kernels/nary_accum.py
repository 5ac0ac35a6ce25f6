"""B1 nary_accum: out = base + sum_i w_i * (x_i - base), fp32 accumulation.

Replaces the TPU kernel `repro/kernels/nary_accum.py:nary_accum_pallas`
with the CUDA kernel in `csrc/nary_accum.cu`. It covers the linear
family in one pass over the stack: weight averaging (w = 1/k, base = 0),
linear interpolation, task arithmetic (w = lambda) and negative merge
(w = -lambda/k). The merge engine sends each fused batch of same-dtype
leaves here once (`ops.nary_flat_merge`).

Bound: device-memory bytes (one read of the [k, Np] stack and the base,
one write of the output, 3 flops per stacked element). The kernel reads
bf16 stacks as bf16 and widens in registers, halving the read traffic
of an fp32 copy; each thread loads 16 bytes per row.

`nary_accum` takes the kernel for CUDA tensors and `nary_accum_plain`
for CPU tensors. Both sum over k in index order with fp32 rounding at
every step, so they agree bitwise. The reference's Pallas kernel sums
with `jnp.sum`, whose order XLA does not pin: against it the port holds
a tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def nary_accum_plain(stacked: torch.Tensor, base: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """stacked [k, Np] fp32|bf16, base [Np] fp32, weights [k] fp32 ->
    [Np] fp32, summing over k in index order."""
    acc = torch.zeros_like(base)
    for i in range(stacked.shape[0]):
        acc = acc + weights[i] * (stacked[i].to(torch.float32) - base)
    return base + acc


def _check(stacked, base, weights) -> None:
    if stacked.dim() != 2 or base.dim() != 1 or weights.dim() != 1:
        raise ValueError("expected stacked [k, Np], base [Np], weights [k]")
    k, np_ = stacked.shape
    if base.shape[0] != np_ or weights.shape[0] != k:
        raise ValueError(f"shape mismatch: stacked {tuple(stacked.shape)}, "
                         f"base {tuple(base.shape)}, weights "
                         f"{tuple(weights.shape)}")
    if stacked.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stacked must be fp32 or bf16, got {stacked.dtype}")
    if base.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("base and weights must be fp32")


def nary_accum(stacked: torch.Tensor, base: torch.Tensor,
               weights: torch.Tensor) -> torch.Tensor:
    """The fused n-ary accumulate: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check(stacked, base, weights)
    if build.on_host(stacked, base, weights):
        return nary_accum_plain(stacked, base, weights)
    k, np_ = stacked.shape
    if np_ % 8:
        raise ValueError(f"Np must be a multiple of 8, got {np_}")
    if stacked.data_ptr() % 16 or base.data_ptr() % 16:
        raise ValueError("stacked and base must be 16-byte aligned")
    out = torch.empty_like(base)
    symbol = "nary_accum_bf16" if stacked.dtype == torch.bfloat16 \
        else "nary_accum_f32"
    fn = build.function(symbol)
    code = fn(stacked.data_ptr(), base.data_ptr(), weights.data_ptr(),
              out.data_ptr(), k, np_,
              torch.cuda.current_stream(stacked.device).cuda_stream)
    nary_accum.launches += 1
    build.check(code, symbol)
    return out


nary_accum.launches = 0
