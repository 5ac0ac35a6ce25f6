"""B6 dare_block: DARE with a counter-hash RNG over a block-aligned flat
batch.

    idx = row * npad + start + col      (uint32, wrapping)
    keep = hash_uniform(idx, seed) >= f32(p)
    tau_i = (x_i - base) * keep * f32(1 / (1 - p))
    out = base + (sum_i tau_i) * f32(1 / k)

Replaces the TPU kernel `repro/kernels/dare.py:dare_block_pallas` (and
`dare_pallas` over it) with the CUDA kernel in `csrc/dare.cu`. Each tile
reads its leaf's (seed, padded length, start column) from a metadata row,
so a tile draws the mask a standalone launch over its leaf would draw:
the flat batch equals per-leaf dispatch bitwise, and both equal the
reference's masks bitwise (the hash is exact uint32 arithmetic). The
merge engine takes this route for DARE when `kernel_env.dare_kernel_rng`
is set; its sampler is not the catalog's threefry.

Bound: device-memory bytes (the [k, Np] stack once, bf16 read as bf16;
base read and output written once). The hash adds about 17 integer
operations per stacked element, fewer than the bytes take at the card's
scalar rate.

`dare_block` takes the kernel for CUDA tensors and `dare_block_plain`
for CPU tensors; both sum over k in index order and multiply once by
the fp32 reciprocal of k (XLA lowers the reference's `jnp.mean` that
way), so they agree bitwise. Against the reference's Pallas kernel the
masks are bitwise, and so are the merged values where XLA sums the k
rows in index order (k <= 4 in the tests); above that they are held to
a tolerance.

Seeds are uint32. The engine's per-leaf seed is `plan.seed + leaf
index`, and a Merkle seed has 63 bits: the port keeps its low 32 bits
(`leaf_meta`), where the reference's `jnp.uint32(seed)` raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import hash_uniform, M32

# columns per chunk of the plain version (bounds its temporaries)
_PLAIN_CHUNK = 1 << 23


def _f32(v: float) -> float:
    """`v` rounded once to fp32 (returned as the exact Python float)."""
    return torch.tensor(v, dtype=torch.float32).item()


def rescale_of(p: float) -> float:
    """f32(1 / (1 - p)): the quotient in double, rounded once, as the
    reference's `jnp.float32(1.0 / (1.0 - p))` (not an fp32 division)."""
    return _f32(1.0 / (1.0 - p))


def leaf_meta(seed: int, npad: int, block: int, *,
              device) -> torch.Tensor:
    """[npad / block, 3] int64 rows (seed, npad, start) of one leaf
    padded to `npad` columns; uint32 values, the seed masked to its low
    32 bits."""
    nb = npad // block
    starts = torch.arange(nb, dtype=torch.int64, device=device) * block
    return torch.stack([torch.full_like(starts, seed & M32),
                        torch.full_like(starts, npad & M32), starts], dim=1)


def dare_block_plain(stacked: torch.Tensor, base: torch.Tensor,
                     meta: torch.Tensor, p: float,
                     block: int) -> torch.Tensor:
    """[Np] fp32: the kernel's computation in PyTorch (int64 hash)."""
    k, np_ = stacked.shape
    out = torch.empty_like(base)
    f32 = dict(dtype=torch.float32, device=base.device)
    p32, rs, fk = (torch.tensor(v, **f32) for v in
                   (p, rescale_of(p), float(k)))
    rk = torch.tensor(1.0, **f32) / fk
    nb = np_ // block
    step = max(1, _PLAIN_CHUNK // block)
    col = torch.arange(block, dtype=torch.int64, device=base.device)
    for t0 in range(0, nb, step):
        t1 = min(nb, t0 + step)
        sl = slice(t0 * block, t1 * block)
        m = meta[t0:t1].to(torch.int64)
        seed = m[:, 0:1]
        pos = (m[:, 2:3] + col).reshape(-1)
        npad = m[:, 1:2].expand(-1, block).reshape(-1)
        seed = seed.expand(-1, block).reshape(-1)
        b = base[sl]
        acc = torch.zeros_like(b)
        for i in range(k):
            u = hash_uniform((i * npad + pos) & M32, seed)
            keep = (u >= p32).to(torch.float32)
            acc = acc + ((stacked[i, sl].to(torch.float32) - b) * keep) * rs
        out[sl] = b + acc * rk
    return out


def _check(stacked, base, meta, p, block) -> None:
    if stacked.dim() != 2 or base.dim() != 1 or meta.dim() != 2:
        raise ValueError("expected stacked [k, Np], base [Np], meta [nb, 3]")
    k, np_ = stacked.shape
    if np_ % block or block % 8:
        raise ValueError(f"Np={np_} must be a multiple of block={block}, "
                         "itself a multiple of 8")
    if base.shape[0] != np_ or tuple(meta.shape) != (np_ // block, 3):
        raise ValueError(f"shape mismatch: stacked {tuple(stacked.shape)}, "
                         f"base {tuple(base.shape)}, meta "
                         f"{tuple(meta.shape)}")
    if stacked.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stacked must be fp32 or bf16, got {stacked.dtype}")
    if base.dtype != torch.float32:
        raise TypeError("base must be fp32")
    if meta.dtype != torch.int64:
        raise TypeError("meta must be int64 rows of uint32 values")
    if not 0.0 <= p < 1.0:
        raise ValueError(f"p must lie in [0, 1), got {p}")


def dare_block(stacked: torch.Tensor, base: torch.Tensor, meta: torch.Tensor,
               p: float, block: int) -> torch.Tensor:
    """Meta-driven DARE: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. `meta` [nb, 3] int64 of uint32 values."""
    _check(stacked, base, meta, p, block)
    if build.on_host(stacked, base, meta):
        return dare_block_plain(stacked, base, meta, p, block)
    if stacked.data_ptr() % 16 or base.data_ptr() % 16:
        raise ValueError("stacked and base must be 16-byte aligned")
    # the kernel reads uint32: pass the same 32 bits as int32
    meta32 = torch.where(meta >= 1 << 31, meta - (1 << 32), meta).to(
        torch.int32).contiguous()
    out = torch.empty_like(base)
    symbol = "dare_block_bf16" if stacked.dtype == torch.bfloat16 \
        else "dare_block_f32"
    fn = build.function(symbol)
    code = fn(stacked.data_ptr(), base.data_ptr(), meta32.data_ptr(),
              out.data_ptr(), stacked.shape[0], stacked.shape[1], block,
              _f32(p), rescale_of(p),
              torch.cuda.current_stream(stacked.device).cuda_stream)
    build.check(code, symbol)
    dare_block.launches += 1
    return out


dare_block.launches = 0
