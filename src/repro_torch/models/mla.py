"""Multi-head Latent Attention, DeepSeek-V2's (`repro.models.mla`,
arXiv:2405.04434).

Keys and values are compressed into a `kv_lora_rank` latent plus one rope
key shared by every head, so a decode cache holds only [B, S, kv_lora +
d_rope] a layer. Two paths, the reference's:

  * `mla_attention`, training and prefill, non-absorbed: the latent is
    expanded into per-head keys (d_nope) and values (d_v), the queries
    (d_nope + d_rope) attend in chunks of queries. As in the reference
    it is plain products and a softmax, not a flash kernel (no B9
    instance has q/k of 192 and v of 128). The logits of each chunk are
    fp32: the reference asks for `preferred_element_type=float32` from
    compute-dtype operands, and the port multiplies fp32 copies of them
    (a product of two bf16 values is exact in fp32, so the two differ
    only in the order of the fp32 sums). One chunk's logits are alive
    at a time, and a chunk reads only the keys up to its last query:
    the reference computes every key column and masks those past the
    diagonal to -2e38, whose softmax weight is exactly 0, so skipping
    them changes only the order of summation. The reference asserts
    that the chunks tile the sequence; the port raises `ValueError`
    (`q_chunks`).
  * `mla_decode`, one token, absorbed: the query's nope part is
    multiplied into W_uk so attention runs against the latent cache
    itself, and W_uv is applied after it. The step writes its latent
    and rope key into the caches in place (the reference returns
    updated copies) and attends over the filled slots 0 .. pos, where
    the reference masks the rest of the cache.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_def
from repro_torch.models.schema import PDef

# the reference's mask value (`repro.models.layers.NEG_INF`)
NEG_INF = -2.0e38


def mla_def(cfg: ModelConfig) -> dict:
    m = cfg.mla
    d = cfg.d_model
    h = cfg.n_heads
    scale = 0.02
    q_in = m.q_lora_rank or d
    p = {
        "w_dkv": PDef((d, m.kv_lora_rank + m.d_head_rope), ("fsdp", None),
                      scale=scale),
        "kv_norm": rmsnorm_def(m.kv_lora_rank),
        "w_uk": PDef((m.kv_lora_rank, h * m.d_head_nope), (None, "tp"),
                     scale=scale),
        "w_uv": PDef((m.kv_lora_rank, h * m.d_head_v), (None, "tp"),
                     scale=scale),
        "w_q": PDef((q_in, h * (m.d_head_nope + m.d_head_rope)),
                    ("fsdp", "tp"), scale=scale),
        "wo": PDef((h * m.d_head_v, d), ("tp", "fsdp"), scale=scale),
    }
    if m.q_lora_rank:
        p["w_dq"] = PDef((d, m.q_lora_rank), ("fsdp", None), scale=scale)
        p["q_norm"] = rmsnorm_def(m.q_lora_rank)
    return p


def _project_q(p, x, cfg: ModelConfig, compute_dtype):
    """(q_nope [B, S, H, d_nope], q_rope [B, S, H, d_rope]), through the
    `q_lora_rank` bottleneck and its norm when the config has one."""
    m = cfg.mla
    if m.q_lora_rank:
        cq = x @ p["w_dq"].to(compute_dtype)
        cq = rmsnorm(p["q_norm"], cq, cfg.rms_eps)
        q = cq @ p["w_q"].to(compute_dtype)
    else:
        q = x @ p["w_q"].to(compute_dtype)
    b, s, _ = x.shape
    q = q.reshape(b, s, cfg.n_heads, m.d_head_nope + m.d_head_rope)
    return q[..., :m.d_head_nope], q[..., m.d_head_nope:]


def mla_latent(p, x, cfg: ModelConfig, positions, compute_dtype):
    """Compress x -> (normalized latent [B, S, R], rotated rope key [B, S,
    Dr]); the rope key is rotated as one head (a singleton head axis)."""
    m = cfg.mla
    ckv = x @ p["w_dkv"].to(compute_dtype)
    c, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    c = rmsnorm(p["kv_norm"], c, cfg.rms_eps)
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return c, k_rope


def q_chunks(s: int, q_chunk: int) -> Tuple[int, int]:
    """(number of chunks, chunk length) of the reference's `mla_attention`:
    s // q_chunk chunks of equal length (one when s <= q_chunk). Raises
    `ValueError` when they do not tile the s queries, where the reference
    asserts (a 4064-token prompt at DeepSeek-V2's 512-query chunk: 7
    chunks; 4096 tiles)."""
    nq = max(1, s // q_chunk) if s > q_chunk else 1
    if s % nq:
        raise ValueError(
            f"MLA attention over {s} queries in chunks of {q_chunk}: "
            f"{nq} chunks do not tile them (the reference asserts s % nq "
            f"== 0); use a prompt that is a multiple of {nq} or of the "
            "chunk")
    return nq, s // nq


def _scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return (m.d_head_nope + m.d_head_rope) ** -0.5


def mla_attention(p, x, cfg: ModelConfig, *, q_chunk: int = 512,
                  compute_dtype=torch.bfloat16, latent: bool = False):
    """Training / prefill path (non-absorbed: per-head keys and values
    materialized). Returns the output [B, S, D] in the compute dtype, and
    with `latent` also (c [B, S, R], k_rope [B, S, Dr]) for the cache."""
    m = cfg.mla
    cd = compute_dtype
    b, s, _ = x.shape
    h = cfg.n_heads
    x = x.to(cd)
    positions = torch.arange(s, device=x.device)
    c, k_rope = mla_latent(p, x, cfg, positions, cd)
    k_nope = (c @ p["w_uk"].to(cd)).reshape(b, s, h, m.d_head_nope)
    v = (c @ p["w_uv"].to(cd)).reshape(b, s, h, m.d_head_v)
    q_nope, q_rope = _project_q(p, x, cfg, cd)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    out = chunked_attention(q_nope, q_rope, k_nope, k_rope, v,
                            scale=_scale(cfg), q_chunk=q_chunk)
    out = out.reshape(b, s, h * m.d_head_v) @ p["wo"].to(cd)
    return (out, (c, k_rope)) if latent else out


def chunked_attention(q_nope, q_rope, k_nope, k_rope, v, *, scale: float,
                      q_chunk: int):
    """The non-absorbed attention itself: q_nope [B, S, H, dn], q_rope
    [B, S, H, dr], k_nope [B, S, H, dn], k_rope [B, S, dr] (one key for
    every head), v [B, S, H, dv], all in the compute dtype; causal.
    Per chunk of queries (`q_chunks`) the fp32 logits q_nope . k_nope +
    q_rope . k_rope times `scale`, masked, softmax in fp32, rounded to
    the compute dtype and multiplied into v. Returns [B, S, H, dv]."""
    f32 = torch.float32
    b, s, h, _ = q_nope.shape
    dr = q_rope.shape[-1]
    nq, cs = q_chunks(s, q_chunk)
    kn = k_nope.to(f32).transpose(1, 2).contiguous()      # [B, H, S, dn]
    kr = k_rope.to(f32)                                   # [B, S, dr]
    vt = v.transpose(1, 2)                                # [B, H, S, dv]
    keys = torch.arange(s, device=q_nope.device)
    outs = []
    for i in range(nq):
        q0 = i * cs
        nk = q0 + cs                       # keys past the last query: 0
        qn = q_nope[:, q0:q0 + cs].to(f32).transpose(1, 2)  # [B, H, cs, dn]
        qr = q_rope[:, q0:q0 + cs].to(f32).reshape(b, cs * h, dr)
        logits = qn @ kn[:, :, :nk].transpose(-1, -2)       # [B, H, cs, nk]
        logits += (qr @ kr[:, :nk].transpose(1, 2)).reshape(
            b, cs, h, nk).transpose(1, 2)
        logits *= scale
        qpos = q0 + torch.arange(cs, device=q_nope.device)
        logits.masked_fill_(keys[None, :nk] > qpos[:, None], NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        del logits
        outs.append((probs @ vt[:, :, :nk]).transpose(1, 2))  # [B, cs, H, dv]
        del probs
    return outs[0] if nq == 1 else torch.cat(outs, dim=1)


def mla_decode(p, x, cache_c, cache_kr, pos: int, cfg: ModelConfig,
               compute_dtype=torch.bfloat16):
    """Absorbed decode of one token. x: [B, 1, D]; cache_c: [B, S, R];
    cache_kr: [B, S, Dr], both written in place at slot `pos`. Returns the
    output [B, 1, D]."""
    m = cfg.mla
    cd = compute_dtype
    f32 = torch.float32
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"an MLA decode step of {s} tokens; the absorbed "
                         "path steps one token at a time")
    h = cfg.n_heads
    x = x.to(cd)
    positions = torch.full((1,), pos, device=x.device)
    c_new, kr_new = mla_latent(p, x, cfg, positions, cd)
    cache_c[:, pos:pos + 1] = c_new.to(cache_c.dtype)
    cache_kr[:, pos:pos + 1] = kr_new.to(cache_kr.dtype)

    q_nope, q_rope = _project_q(p, x, cfg, cd)              # [B, 1, H, *]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    # absorb W_uk: q_lat[h] = q_nope[h] @ W_uk[h].T, attention in latent
    w_uk = p["w_uk"].to(cd).reshape(m.kv_lora_rank, h, m.d_head_nope)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)  # [B, H, R]

    n = pos + 1                              # the filled slots 0 .. pos
    cc = cache_c[:, :n].to(cd)
    logits = q_lat.to(f32) @ cc.to(f32).transpose(1, 2)       # [B, H, n]
    logits += q_rope[:, 0].to(f32) @ cache_kr[:, :n].to(cd).to(
        f32).transpose(1, 2)
    logits *= _scale(cfg)
    probs = torch.softmax(logits, dim=-1).to(cd)
    o_lat = probs @ cc                                        # [B, H, R]
    w_uv = p["w_uv"].to(cd).reshape(m.kv_lora_rank, h, m.d_head_v)
    o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv)
    return o.reshape(b, 1, h * m.d_head_v) @ p["wo"].to(cd)
