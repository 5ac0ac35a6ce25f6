"""B8 two-pass SLERP (`repro/kernels/slerp.py:slerp_pallas`, in CUDA:
`csrc/slerp.cu`).

  pass 1  `slerp_reduce`   per tile of `block` columns, the partial sums
          (u.v, u.u, v.v) -> [nb, 3] fp32
  glue    `slerp_scalars`  the sums over tiles (`tile_sum`, one pinned
          order for both devices) and the trig scalars, torch ops on the
          device with no host sync -> c [2] fp32
  pass 2  `slerp_combine`  out = c[0] * u + c[1] * v -> [Np] fp32

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version, in this module, for CPU tensors; the two agree bitwise. Both
passes are bound by device-memory bytes (two reads of u and v in all, one
fp32 write). They read fp32 or bf16 rows and widen in registers (the
reference pads an fp32 copy; widening is exact, so the result is the
same).

The reduce's in-tile order is pinned: thread t of block / 8 adds the
products of its 8 adjacent columns in index order, then a stride-halving
tree adds p[t] + p[t + h] for h = threads / 2 down to 1. The reference
sums each tile with `jnp.sum`, whose order XLA does not pin: against it
the port holds a tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

VEC = 8                 # adjacent columns per thread
# tiles per chunk of the plain versions (bounds their temporaries)
_PLAIN_TILES = 1 << 13


def _check_rows(u, v, block: int) -> None:
    if u.dim() != 1 or v.shape != u.shape:
        raise ValueError("expected u and v of one length [Np]")
    if u.dtype not in (torch.float32, torch.bfloat16) or v.dtype != u.dtype:
        raise TypeError(f"u and v must be both fp32 or both bf16, got "
                        f"{u.dtype} and {v.dtype}")
    threads = block // VEC
    if block % VEC or threads & (threads - 1) or not 1 <= threads <= 1024:
        raise ValueError(f"block={block}: block / {VEC} must be a power of "
                         "two of at most 1024")
    if u.shape[0] % block:
        raise ValueError(f"Np={u.shape[0]} is not a multiple of "
                         f"block={block}")


def _check_aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel operands must be 16-byte aligned")


def _suffix(t: torch.Tensor) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------- pass 1


def slerp_reduce_plain(u, v, block: int) -> torch.Tensor:
    """[nb, 3] fp32 partial sums (u.v, u.u, v.v) per tile, in the
    kernel's order."""
    nb = u.shape[0] // block
    threads = block // VEC
    out = torch.empty((nb, 3), dtype=torch.float32, device=u.device)
    for t0 in range(0, nb, _PLAIN_TILES):
        t1 = min(nb, t0 + _PLAIN_TILES)
        sl = slice(t0 * block, t1 * block)
        a = u[sl].to(torch.float32).reshape(t1 - t0, threads, VEC)
        b = v[sl].to(torch.float32).reshape(t1 - t0, threads, VEC)
        for col, (x, y) in enumerate(((a, b), (a, a), (b, b))):
            p = x * y
            s = p[..., 0]
            for j in range(1, VEC):
                s = s + p[..., j]
            h = threads // 2
            while h:
                s = s[:, :h] + s[:, h:]
                h //= 2
            out[t0:t1, col] = s[:, 0]
    return out


def slerp_reduce(u, v, block: int) -> torch.Tensor:
    """Pass 1: u, v [Np] fp32|bf16 -> [Np / block, 3] fp32."""
    _check_rows(u, v, block)
    if build.on_host(u, v):
        return slerp_reduce_plain(u, v, block)
    _check_aligned(u, v)
    out = torch.empty((u.shape[0] // block, 3), dtype=torch.float32,
                      device=u.device)
    symbol = f"slerp_reduce_{_suffix(u)}"
    code = build.function(symbol)(u.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), u.shape[0], block,
                                  _stream(u))
    slerp_reduce.launches += 1
    build.check(code, symbol)
    return out


slerp_reduce.launches = 0


# ---------------------------------------------------------------- glue


def tile_sum(partials: torch.Tensor) -> torch.Tensor:
    """[nb, m] -> [m]: the sum over tiles in one pinned order on every
    device (zero-padded to a power of two, then x[:h] + x[h:] halvings),
    so the card and the CPU reach the same bits."""
    n = partials.shape[0]
    p = 1 << max(0, (n - 1).bit_length())
    x = partials
    if p != n:
        x = torch.cat([x, x.new_zeros((p - n,) + tuple(x.shape[1:]))])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def slerp_scalars(partials: torch.Tensor, t: float) -> torch.Tensor:
    """c [2] fp32 = (w1 * mag / nu, w2 * mag / nv) from the partial sums,
    as `slerp_pallas` computes them between its passes; Python constants
    round to fp32 as JAX's weakly typed scalars do."""
    f32 = dict(dtype=torch.float32, device=partials.device)
    dot, uu, vv = tile_sum(partials).unbind()
    eps = torch.tensor(1e-12, **f32)
    one_t, tt = torch.tensor(1.0 - t, **f32), torch.tensor(t, **f32)
    nu, nv = torch.sqrt(uu) + eps, torch.sqrt(vv) + eps
    cos = torch.clamp(dot / (nu * nv), -1.0, 1.0)
    omega = torch.arccos(cos)
    so = torch.sin(omega)
    small = so < torch.tensor(1e-6, **f32)
    w1 = torch.where(small, one_t, torch.sin(one_t * omega) / so)
    w2 = torch.where(small, tt, torch.sin(tt * omega) / so)
    mag = one_t * nu + tt * nv
    return torch.stack([w1 * mag / nu, w2 * mag / nv])


# ---------------------------------------------------------------- pass 2


def slerp_combine_plain(u, v, c, block: int) -> torch.Tensor:
    """[Np] fp32: c[0] * u + c[1] * v."""
    out = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    step = _PLAIN_TILES * block
    for c0 in range(0, u.shape[0], step):
        sl = slice(c0, c0 + step)
        out[sl] = c[0] * u[sl].to(torch.float32) \
            + c[1] * v[sl].to(torch.float32)
    return out


def slerp_combine(u, v, c, block: int) -> torch.Tensor:
    """Pass 2: u, v [Np] fp32|bf16, c [2] fp32 -> [Np] fp32."""
    _check_rows(u, v, block)
    if c.shape != (2,) or c.dtype != torch.float32:
        raise ValueError("c must be [2] fp32")
    if build.on_host(u, v, c):
        return slerp_combine_plain(u, v, c, block)
    out = torch.empty(u.shape, dtype=torch.float32, device=u.device)
    _check_aligned(u, v, out)
    symbol = f"slerp_combine_{_suffix(u)}"
    code = build.function(symbol)(u.data_ptr(), v.data_ptr(), c.data_ptr(),
                                  out.data_ptr(), u.shape[0], _stream(u))
    slerp_combine.launches += 1
    build.check(code, symbol)
    return out


slerp_combine.launches = 0
