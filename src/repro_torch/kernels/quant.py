"""B2 quant_nary: int8 merge-on-arrival over a block-aligned flat batch.

    x_i = f32(q_i) * scale_i            (core.compression's dequantize)
    out = base + sum_i w_i * (x_i - base)

Replaces the TPU kernel `repro/kernels/quant.py:quant_nary_pallas` with
the CUDA kernel in `csrc/quant.cu`. The merge engine sends a
linear-family group here when every slice arrived as a `CompressedLeaf`,
so the k int8 rows are read as they came off the wire and never
densified in device memory.

Bound: device-memory bytes (one byte per stacked element, the fp32 base
read and the fp32 output written once; 4 flops per stacked element).

`quant_nary` takes the kernel for CUDA tensors and `quant_nary_plain`
for CPU tensors. Both dequantize with one fp32 multiply and sum over k
in `nary_accum`'s order (index order from zero, fp32 rounding at every
step), so they agree bitwise. Against the reference's Pallas kernel,
whose `jnp.sum` order XLA does not pin, the port holds a tolerance.

Layout: `q` [k, Np] int8 holds L leaves, each zero-padded to a multiple
of `block`; `scale_meta` [Np / block, k] fp32 is each tile's leaf's
per-contribution scale; `base` [Np] fp32; `weights` [k] fp32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# columns per chunk of the plain version (bounds its temporaries)
_PLAIN_CHUNK = 1 << 24


def quant_nary_plain(q: torch.Tensor, base: torch.Tensor,
                     scale_meta: torch.Tensor, weights: torch.Tensor,
                     block: int) -> torch.Tensor:
    """[Np] fp32; `nary_accum_plain` on the rows dequantized per tile."""
    out = torch.empty_like(base)
    nb = q.shape[1] // block
    step = max(1, _PLAIN_CHUNK // block)
    for t0 in range(0, nb, step):
        t1 = min(nb, t0 + step)
        sl = slice(t0 * block, t1 * block)
        scale = scale_meta[t0:t1].T.repeat_interleave(block, dim=1)
        b = base[sl]
        acc = torch.zeros_like(b)
        for i in range(q.shape[0]):
            x = q[i, sl].to(torch.float32) * scale[i]
            acc = acc + weights[i] * (x - b)
        out[sl] = b + acc
    return out


def _check(q, base, scale_meta, weights, block) -> None:
    if q.dim() != 2 or base.dim() != 1 or weights.dim() != 1 \
            or scale_meta.dim() != 2:
        raise ValueError("expected q [k, Np], base [Np], scale_meta "
                         "[nb, k], weights [k]")
    k, np_ = q.shape
    if np_ % block or block % 16:
        raise ValueError(f"Np={np_} must be a multiple of block={block}, "
                         "itself a multiple of 16")
    if base.shape[0] != np_ or weights.shape[0] != k \
            or tuple(scale_meta.shape) != (np_ // block, k):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, base "
                         f"{tuple(base.shape)}, scale_meta "
                         f"{tuple(scale_meta.shape)}, weights "
                         f"{tuple(weights.shape)}")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    if not all(t.dtype == torch.float32 for t in (base, scale_meta,
                                                  weights)):
        raise TypeError("base, scale_meta and weights must be fp32")


def quant_nary(q: torch.Tensor, base: torch.Tensor, scale_meta: torch.Tensor,
               weights: torch.Tensor, block: int) -> torch.Tensor:
    """The int8 n-ary accumulate: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    _check(q, base, scale_meta, weights, block)
    if build.on_host(q, base, scale_meta, weights):
        return quant_nary_plain(q, base, scale_meta, weights, block)
    if q.data_ptr() % 16 or base.data_ptr() % 16:
        raise ValueError("q and base must be 16-byte aligned")
    out = torch.empty_like(base)
    fn = build.function("quant_nary")
    code = fn(q.data_ptr(), base.data_ptr(), scale_meta.data_ptr(),
              weights.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1],
              block, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "quant_nary")
    quant_nary.launches += 1
    return out


quant_nary.launches = 0
