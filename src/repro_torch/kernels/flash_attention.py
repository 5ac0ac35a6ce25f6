"""B9 flash attention (`repro/kernels/flash_attention.py:flash_attention`,
in CUDA: `csrc/flash_attention.cu`).

    flash_attention(q, k, v, causal=True, scale=0.0, q_offset=0,
                    window=0, softcap=0.0)

q [B, Sq, H, D]; k, v [B, Sk, HK, D] with H a multiple of HK (query head
h reads KV head h // (H / HK)); all fp32 or all bf16. Returns
[B, Sq, H, D] in q's dtype: softmax(logits) . v with logits = (q . k) *
scale, scale 0 meaning D^-0.5, and with a `softcap` c > 0 logits = c *
tanh(logits / c) (gemma2's attention softcap); logits, softmax and the
p . v accumulator in fp32. Query row i sits at position q_offset + i;
with `causal` it sees keys 0 .. q_offset + i, and with a `window` W > 0
only those with q_offset + i - key < W (gemma2's local layers): the
reference's `_attn_core` mask (`models/layers.py:121-146`). A window
needs `causal` (`ValueError` otherwise: gemma2 attends causally only,
and without a causal bound the window would reach forward). So one
function serves prefill (q_offset 0) and a decode step (Sq = 1, q_offset
= its position, k and v the whole cache: the keys past the position,
and below the window, are never read). Two departures from the
reference's kernel, both needed by the serving path: `q_offset` (the
reference has none; at 0 the function is the reference's), and keys
past Sk are masked with or without `causal` (the reference pads them
with zeros and leaves those in its non-causal softmax, ROADMAP C).

The wrapper launches a CUDA kernel for CUDA tensors, reading q, k and
v in place through their strides (the reference transposes to
[B*H, S, D]; a layer's slice of the KV cache is read the same way), and
runs `flash_attention_plain` for CPU tensors. Above DECODE_ROWS queries
it launches the prefill design (bf16 on the tensor cores; fp32 on the
scalar pipes); at DECODE_ROWS or fewer, the decode design, whose keys
are split over `decode_splits(...)` chunks, chosen from the shapes
alone, so two devices make the same partials and the same bits. Every
design skips the key tiles that no row of a block can see: above the
diagonal under `causal`, and wholly below every row's window. Kernel
and plain version sum in different orders and exponentiate with
different code, so they agree within a tolerance, not bitwise
(`chip_smoke.py` states it). A row that sees no key gives 0 in both.

The gradient. When autograd records the call (grad mode on and q, k
or v requiring grad), `flash_attention` runs `FlashAttentionFn`: its
forward is the prefill design at any Sq, which also writes each row's
log-sum-exp of its logits (capped, under a softcap; [B, H, Sq] fp32; 0
for a row that sees no key); it saves q, k, v, the output and the LSE.
Its backward, `flash_attention_backward`, computes dQ, dK and dV of
causal (or full) GQA attention at q_offset 0, with gemma2's softcap and
sliding window, what XLA's autodiff of the reference's
`chunked_attention` computes, with three CUDA kernels and no atomics
(`csrc/flash_attention_bwd.cuh`, head dims BWD_HEAD_DIMS: bf16 on the
tensor cores, fp32 on the scalar pipes); on CPU tensors it runs
`flash_attention_backward_plain`, the same quantities step by step in
fp32 (dP - Dd in float64). `flash_attention_grad_plain` runs the
autograd function with the plain forward and backward on any device
(the chip smoke compares a train step with it). The reference's Pallas
kernel has no gradient: its model trains through `chunked_attention`.
Under autograd a `q_offset` other than 0 raises `NotImplementedError`
(training's forward is a prefill).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 96, 128)     # instantiated in the CUDA source
BWD_HEAD_DIMS = (16, 64, 96, 128)     # the gradient's: configs and smoke
DECODE_ROWS = 16      # queries up to which a call takes the decode design
DECODE_TILE = 32      # keys per tile of the decode kernel
# blocks a decode call aims at, and the fewest elements of K a chunk
# reads (128 keys at D = 96). On an H100 the fastest key split at 32 KV
# heads of 96 was 256 blocks at batch 1, 2 and 4 over 4064 keys, and
# chunks of 128 keys at batch 1 over 1024 (`tools/b9_time.py --sweep`).
# Constants: the split never depends on the device it runs on.
DECODE_TARGET_BLOCKS = 256
DECODE_MIN_CHUNK_ELEMS = 128 * 96
# queries per chunk of the plain version: [B, H, chunk, Sk] fp32 logits
# stay under 2^28 elements (1 GiB)
_PLAIN_ELEMS = 1 << 28


def _options(causal: bool, window: int, softcap: float
             ) -> Tuple[int, float]:
    """(window, softcap) as the kernels take them: 0 where off (the
    reference applies each only when it is > 0)."""
    window = max(int(window), 0)
    if window and not causal:
        raise ValueError("a sliding window needs causal attention")
    return window, max(float(softcap), 0.0)


def _check(q, k, v, q_offset: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("expected q [B, Sq, H, D] and k, v [B, Sk, HK, D]")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    hk = k.shape[2]
    if hk == 0 or h % hk:
        raise ValueError(f"H={h} is not a multiple of HK={hk}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be all fp32 or all bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q_offset < 0:
        raise ValueError(f"q_offset={q_offset} < 0")


def _check_strided(*tensors) -> None:
    """The kernel reads 8 elements (16 bytes of bf16, 32 of fp32) at a
    time from rows with a contiguous last dimension."""
    for t in tensors:
        st = t.stride()
        if st[3] != 1 or st[0] % 8 or st[1] % 8 or st[2] % 8 \
                or t.data_ptr() % 16:
            raise ValueError(
                "kernel operands need a contiguous last dimension, strides "
                "that are multiples of 8 elements and 16-byte alignment; got "
                f"strides {t.stride()}")


def visible_keys(sq: int, sk: int, causal: bool, q_offset: int,
                 window: int = 0) -> Tuple[int, int]:
    """[kbeg, kend): the keys that some query row of a call sees (the
    CUDA source's `visible_keys`)."""
    kend = max(0, min(sk, q_offset + sq)) if causal else sk
    kbeg = min(max(0, q_offset - window + 1), kend) if window else 0
    return kbeg, kend


def decode_splits(b: int, hk: int, kend: int, d: int) -> Tuple[int, int]:
    """(splits, chunk) of a decode call over `kend` visible keys (from
    the first one a row sees, `visible_keys`): chunk c covers keys
    [c * chunk, min((c + 1) * chunk, kend)) of them. About
    DECODE_TARGET_BLOCKS blocks over the b * hk (batch, KV head) pairs,
    chunks of whole tiles and at least DECODE_MIN_CHUNK_ELEMS elements;
    one chunk (no scratch, no combine) when the prefix is short."""
    min_keys = -(-DECODE_MIN_CHUNK_ELEMS // d)
    if kend < 2 * min_keys:
        return 1, max(kend, 1)
    want = -(-DECODE_TARGET_BLOCKS // max(1, b * hk))
    n = max(1, min(want, kend // min_keys))
    chunk = -(-kend // n)
    chunk = -(-chunk // DECODE_TILE) * DECODE_TILE
    return -(-kend // chunk), chunk


def _decode_rows(nrows: int) -> int:
    """Query rows per decode block, for the `nrows` = Sq x H / HK query
    rows of one KV head: an instance of 1 or 16 rows."""
    return 1 if nrows <= 1 else DECODE_ROWS


# per (device, stream): the decode design's fp32 scratch and int32
# tickets, grown on demand and reused (calls on one stream run in order);
# the tickets are zeroed once, and each call's last block of a group puts
# its ticket back to 0
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, floats: int,
             groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    part, tickets = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < groups:
        tickets = torch.zeros(max(groups, 1024), dtype=torch.int32,
                              device=device)
    _SCRATCH[key] = part, tickets
    return part, tickets


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float = 0.0, q_offset: int = 0,
                          window: int = 0, softcap: float = 0.0,
                          return_lse: bool = False):
    """The same function in fp32 torch ops, chunked over queries:
    logits, softcap, mask, a max-subtracted softmax, p @ v, cast to q's
    dtype. With `return_lse`, also each row's log-sum-exp [B, H, Sq]
    fp32 (0 for a row that sees no key)."""
    window, softcap = _options(causal, window, softcap)
    _check(q, k, v, q_offset)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    if scale <= 0.0:
        scale = d ** -0.5
    out = torch.zeros((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    if sk == 0:
        return (out, lse) if return_lse else out
    kt = k.to(torch.float32).permute(0, 2, 3, 1).unsqueeze(2)  # B,HK,1,D,Sk
    vf = v.to(torch.float32).permute(0, 2, 1, 3).unsqueeze(2)  # B,HK,1,Sk,D
    kpos = torch.arange(sk, device=q.device)
    chunk = max(1, _PLAIN_ELEMS // max(1, b * h * sk))
    for s0 in range(0, sq, chunk):
        c = min(chunk, sq - s0)
        qc = q[:, s0:s0 + c].to(torch.float32).reshape(b, c, hk, g, d) \
            .permute(0, 2, 3, 1, 4)                           # B,HK,G,c,D
        logits = torch.matmul(qc, kt) * scale                 # B,HK,G,c,Sk
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        if causal:
            qpos = q_offset + s0 + torch.arange(c, device=q.device)
            hidden = kpos[None, :] > qpos[:, None]
            if window:
                hidden |= qpos[:, None] - kpos[None, :] >= window
            logits.masked_fill_(hidden, float("-inf"))
        m = logits.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(logits - m)
        del logits
        total = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vf) / total.clamp_min(1e-30)     # B,HK,G,c,D
        out[:, s0:s0 + c] = o.permute(0, 3, 1, 2, 4).reshape(b, c, h, d) \
            .to(q.dtype)
        if return_lse:
            row = torch.where(total > 0, m + torch.log(total),
                              torch.zeros_like(m))
            lse[:, :, s0:s0 + c] = row.reshape(b, h, c)
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal: bool = True, scale: float = 0.0,
                    q_offset: int = 0, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [B, Sq, H, D], k, v [B, Sk, HK, D] -> [B, Sq, H, D]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        window, softcap = _grad_supported(q, k, v, causal, q_offset, window,
                                          softcap)
        return FlashAttentionFn.apply(q, k, v, causal, scale, window,
                                      softcap, False)
    if build.on_host(q, k, v, contiguous=False):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, window=window,
                                     softcap=softcap)
    window, softcap = _options(causal, window, softcap)
    _check(q, k, v, q_offset)
    d = q.shape[3]
    if scale <= 0.0:
        scale = d ** -0.5
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel instance; have "
                         f"{HEAD_DIMS}")
    _check_strided(q, k, v)
    b, sq, h, _ = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    bf16 = q.dtype == torch.bfloat16
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, h, hk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)), int(q_offset), softcap,
            window)
    if sq > DECODE_ROWS:
        symbol = "flash_attention_bf16" if bf16 else "flash_attention_f32"
        code = build.function(symbol)(*args, stream)
    else:
        symbol = "flash_decode_bf16" if bf16 else "flash_decode_f32"
        kbeg, kend = visible_keys(sq, sk, causal, q_offset, window)
        splits, chunk = decode_splits(b, hk, kend - kbeg, d)
        rows = _decode_rows(sq * (h // hk))
        part = tickets = None
        if splits > 1:
            groups = b * hk * -(-sq * (h // hk) // rows)
            part, tickets = _scratch(q.device, stream,
                                     groups * splits * rows * (d + 2),
                                     groups)
            part, tickets = part.data_ptr(), tickets.data_ptr()
        code = build.function(symbol)(*args, rows, splits, chunk, part,
                                      tickets, stream)
    flash_attention.launches += 1
    build.check(code, symbol)
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# The gradient
# ---------------------------------------------------------------------------


def _grad_supported(q, k, v, causal: bool, q_offset: int, window: int,
                    softcap: float) -> Tuple[int, float]:
    """(window, softcap) as the kernels take them, for a call under
    autograd; raises on a q_offset other than 0."""
    window, softcap = _options(causal, window, softcap)
    _check(q, k, v, q_offset)
    if q_offset:
        raise NotImplementedError(
            "B9's gradient covers q_offset 0 (training's causal prefill)")
    return window, softcap


def _kernel_args(q, scale: float, dims=HEAD_DIMS):
    d = q.shape[3]
    if d not in dims:
        raise ValueError(f"head dim {d} has no kernel instance; have "
                         f"{dims}")
    return d, (scale if scale > 0.0 else d ** -0.5)


def flash_attention_lse(q, k, v, *, causal: bool = True, scale: float = 0.0,
                        window: int = 0, softcap: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the prefill design at q_offset 0 for any Sq, with each
    row's log-sum-exp [B, H, Sq] fp32 (of the capped logits under a
    softcap). CUDA tensors launch the kernel (counted in
    `flash_attention.launches`); CPU tensors run the plain version."""
    if build.on_host(q, k, v, contiguous=False):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     window=window, softcap=softcap,
                                     return_lse=True)
    window, softcap = _options(causal, window, softcap)
    _check(q, k, v, 0)
    d, scale = _kernel_args(q, scale)
    _check_strided(q, k, v)
    b, sq, h, _ = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    symbol = ("flash_attention_lse_bf16" if q.dtype == torch.bfloat16
              else "flash_attention_lse_f32")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = build.function(symbol)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, hk, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(bool(causal)), 0, softcap, window, lse.data_ptr(),
        stream)
    flash_attention.launches += 1
    build.check(code, symbol)
    return out, lse


def flash_attention_backward_plain(q, k, v, o, lse, dout, *,
                                   causal: bool = True, scale: float = 0.0,
                                   window: int = 0, softcap: float = 0.0
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """(dq, dk, dv) step by step in fp32 torch ops, chunked over
    queries: Dd = rowsum(dO * O), x = q.k scale, the logit s = x, or
    with a softcap c, s = c tanh(x / c) (the plain forward's), P =
    exp(s - lse) (0 where masked: causally and, with a window W, where
    q - key >= W), dP = dO V^T, dS = P (dP - Dd), times (1 - t)(1 + t)
    with t = tanh(x / c) under the softcap, dV = P^T dO, dK = dS^T Q
    scale, dQ = dS K scale; each cast to its input's dtype. dP and Dd,
    and their difference, are taken in float64: that difference is the
    step that cancels (in a row that sees one key O is that key's V, and
    dS is 0 in exact arithmetic), and float64 rounds it 2^29 times finer
    than the kernels' fp32, so the reference adds no noise of its own
    there."""
    window, softcap = _options(causal, window, softcap)
    _check(q, k, v, 0)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    if scale <= 0.0:
        scale = d ** -0.5
    f32, f64 = torch.float32, torch.float64
    dq = torch.zeros((b, sq, h, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, hk, sk, d), dtype=f32, device=q.device)
    dv = torch.zeros((b, hk, sk, d), dtype=f32, device=q.device)
    if sk and sq:
        dd = (dout.to(f64) * o.to(f64)).sum(dim=-1)            # B,Sq,H
        kf = k.to(f32).permute(0, 2, 1, 3).unsqueeze(2)        # B,HK,1,Sk,D
        vd = v.to(f64).permute(0, 2, 1, 3).unsqueeze(2)
        kpos = torch.arange(sk, device=q.device)
        chunk = max(1, _PLAIN_ELEMS // max(1, b * h * sk))
        for s0 in range(0, sq, chunk):
            c = min(chunk, sq - s0)

            def heads(x):                                      # B,HK,G,c,D
                return x[:, s0:s0 + c].to(f32).reshape(b, c, hk, g, d) \
                    .permute(0, 2, 3, 1, 4)

            qc, gc = heads(q), heads(dout)
            lc = lse[:, :, s0:s0 + c].reshape(b, hk, g, c, 1)
            x = torch.matmul(qc, kf.transpose(-1, -2)) * scale
            if softcap:
                t = torch.tanh(x / softcap)
                x = softcap * t
            p = torch.exp(x - lc)
            del x
            if causal:
                qpos = s0 + torch.arange(c, device=q.device)
                hidden = kpos[None, :] > qpos[:, None]
                if window:
                    hidden |= qpos[:, None] - kpos[None, :] >= window
                p.masked_fill_(hidden, 0.0)
            ddc = dd[:, s0:s0 + c].reshape(b, c, hk, g) \
                .permute(0, 2, 3, 1).unsqueeze(-1)
            ds = p * (torch.matmul(gc.to(f64), vd.transpose(-1, -2))
                      - ddc).to(f32)
            if softcap:
                ds *= (1 - t) * (1 + t)
                del t
            dv += torch.matmul(p.transpose(-1, -2), gc).sum(dim=2)
            dk += torch.matmul(ds.transpose(-1, -2), qc).sum(dim=2)
            dq[:, s0:s0 + c] = (torch.matmul(ds, kf) * scale) \
                .permute(0, 3, 1, 2, 4).reshape(b, c, h, d)
            del p, ds
    dk = (dk * scale).permute(0, 2, 1, 3)
    return (dq.to(q.dtype), dk.to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_backward(q, k, v, o, lse, dout, *, causal: bool = True,
                             scale: float = 0.0, window: int = 0,
                             softcap: float = 0.0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` at q_offset 0, given its output
    `o` and `lse` (`flash_attention_lse` with the same window and
    softcap) and the output's gradient. CUDA tensors launch the three
    backward kernels (one count in `flash_attention_backward.launches`);
    CPU tensors run the plain version. The kernels read contiguous
    tensors: non-contiguous ones are copied first."""
    if build.on_host(q, k, v, o, lse, dout, contiguous=False):
        return flash_attention_backward_plain(q, k, v, o, lse, dout,
                                              causal=causal, scale=scale,
                                              window=window, softcap=softcap)
    window, softcap = _options(causal, window, softcap)
    _check(q, k, v, 0)
    d, scale = _kernel_args(q, scale, BWD_HEAD_DIMS)
    b, sq, h, _ = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if o.shape != q.shape or dout.shape != q.shape \
            or tuple(lse.shape) != (b, h, sq) or lse.dtype != torch.float32 \
            or o.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError("o and dout must match q, lse be [B, H, Sq] fp32")
    q, k, v, o, dout, lse = (t.contiguous() for t in (q, k, v, o, dout, lse))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # Dd for the dQ kernel, and (bf16) again for the dK / dV kernel
    dd = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device)
    symbol = ("flash_attention_bwd_bf16" if q.dtype == torch.bfloat16
              else "flash_attention_bwd_f32")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if sq == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    code = build.function(symbol)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, hk, d, float(scale),
        int(bool(causal)), softcap, window, stream)
    flash_attention_backward.launches += 1
    build.check(code, symbol)
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """B9 with its gradient: forward `flash_attention_lse`, backward
    `flash_attention_backward` (or, with `plain`, both plain versions on
    any device)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, window: int,
                softcap: float, plain: bool):
        kw = dict(causal=causal, scale=scale, window=window,
                  softcap=softcap)
        if plain:
            out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
        else:
            out, lse = flash_attention_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw, ctx.plain = kw, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        fn = (flash_attention_backward_plain if ctx.plain
              else flash_attention_backward)
        dq, dk, dv = fn(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_grad_plain(q, k, v, *, causal: bool = True,
                               scale: float = 0.0, q_offset: int = 0,
                               window: int = 0,
                               softcap: float = 0.0) -> torch.Tensor:
    """`flash_attention`'s signature, computed by the plain forward and,
    under autograd, the plain backward, on whatever device q lies on."""
    window, softcap = _grad_supported(q, k, v, causal, q_offset, window,
                                      softcap)
    return FlashAttentionFn.apply(q, k, v, causal, scale, window, softcap,
                                  True)
