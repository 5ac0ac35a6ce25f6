"""Mamba2's SSD mixer (`repro.models.mamba`; state-space duality,
arXiv:2405.21060).

Training and prefill run the chunked SSD form: attention-like products
within chunks of `chunk_size` tokens, a linear recurrence across the
chunks' states. Decode is the O(1) recurrent update of a [B, H, P, N]
state; the causal depthwise conv keeps a (d_conv - 1)-step cache. One
function for each of the reference's, in its order of operations and
its roundings to the compute dtype: dt is rounded to the compute dtype
where it weights x (`xdt`) and stays fp32 in dt * A; the conv is the
reference's sum of d_conv shifted products plus the bias in the compute
dtype; softplus is logaddexp(x, 0) (`jax.nn.softplus`, no threshold);
the gate is silu(z) in fp32 rounded to the compute dtype before the
product and the norm over all of d_inner. The SSD's products are fp32.

Departures (ROADMAP C):
  * the intra-chunk decay is exp(where(mask, li, -inf)) where the
    reference takes where(mask, exp(li), 0): the same values forward
    (exp(li) on and below the diagonal, exactly 0 above), but above the
    diagonal li is the sum of |dt A| over the span, which passes 88 in a
    256-token chunk at the reference's own init, and there fp32 exp
    overflows and the reference's gradient is 0 x inf = NaN. Every other
    exp here (`seg`, the chunks' decay, exp(cum) and the decode's
    exp(dt A)) takes an argument <= 0;
  * a sequence whose length is not a multiple of min(chunk_size, s)
    raises `ValueError` (the reference asserts);
  * the within-chunk cumulative sum of dt A is a product with a
    triangular matrix of ones: `torch.cumsum` on a CUDA float tensor is
    refused under torch's deterministic mode, which the train step runs.
    The fp32 sums run in another order, as the products' do: heads share
    their group's B and C (no copy per head), the chunk states multiply
    x by the decay before the product with B, and the inter-chunk term
    takes C against the state before the decay.

The SSD is plain PyTorch ops here, as it is plain `jnp` in the
reference (no Pallas kernel); the scan across chunks is a loop over
them where the reference runs `lax.scan`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MambaConfig, ModelConfig
from repro_torch.models.layers import rmsnorm, rmsnorm_def
from repro_torch.models.schema import PDef


def mamba_dims(cfg: ModelConfig):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    n_heads = d_inner // m.head_dim
    conv_dim = d_inner + 2 * m.n_groups * m.d_state
    return d_inner, n_heads, conv_dim


def mamba_def(cfg: ModelConfig) -> dict:
    m = cfg.mamba
    d = cfg.d_model
    d_inner, n_heads, conv_dim = mamba_dims(cfg)
    scale = 0.02
    return {
        # order: [z (d_inner), x (d_inner), B (G*N), C (G*N), dt (H)]
        "w_in": PDef((d, 2 * d_inner + 2 * m.n_groups * m.d_state + n_heads),
                     ("fsdp", "tp"), scale=scale),
        "conv_w": PDef((m.d_conv, conv_dim), (None, "tp"), scale=scale),
        "conv_b": PDef((conv_dim,), ("tp",), init="zeros"),
        "a_log": PDef((n_heads,), ("tp",), init="zeros"),
        "dt_bias": PDef((n_heads,), ("tp",), init="zeros"),
        "d_skip": PDef((n_heads,), ("tp",), init="ones"),
        "norm": rmsnorm_def(d_inner),
        "w_out": PDef((d_inner, d), ("tp", "fsdp"), scale=scale),
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    m = cfg.mamba
    d_inner, n_heads, _ = mamba_dims(cfg)
    gn = m.n_groups * m.d_state
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    bmat = zxbcdt[..., 2 * d_inner:2 * d_inner + gn]
    cmat = zxbcdt[..., 2 * d_inner + gn:2 * d_inner + 2 * gn]
    dt = zxbcdt[..., 2 * d_inner + 2 * gn:]
    return z, x, bmat, cmat, dt


def _silu(x):
    """`jax.nn.silu`: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def _softplus(x):
    """`jax.nn.softplus`: logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


def _conv1d(x, w, b, cache=None):
    """Causal depthwise conv. x: [B, S, C]; w: [K, C]. cache: [B, K-1, C].
    Returns (silu(out), the new cache: the last K - 1 inputs)."""
    k = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, :s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return _silu(out + b), xp[:, -(k - 1):]


def _per_head(t, rep: int):
    """[..., G, N] -> [..., G * rep, N], each group's row repeated for its
    heads (`jnp.repeat` along the group axis); an expand where G = 1."""
    *lead, g, n = t.shape
    return t[..., None, :].expand(*lead, g, rep, n).reshape(*lead, g * rep, n)


def ssd_chunked(xh, dt, a_log, bmat, cmat, d_skip, m: MambaConfig,
                init_state=None):
    """Chunked SSD scan.

    xh:   [B, S, H, P]    (head-split inputs)
    dt:   [B, S, H]       (softplus'd step sizes, fp32)
    bmat: [B, S, G, N]; cmat: [B, S, G, N]
    Returns (y [B, S, H, P] in xh's dtype, final_state [B, H, P, N]
    fp32). Raises `ValueError` when S is not a multiple of
    min(chunk_size, S).
    """
    b, s, h, p = xh.shape
    g, n = bmat.shape[2], bmat.shape[3]
    cs = min(m.chunk_size, s)
    if s % cs:
        raise ValueError(
            f"a sequence of {s} tokens does not split into SSD chunks of "
            f"{cs} (chunk_size {m.chunk_size}); give a multiple of it")
    nc = s // cs
    rep = h // g
    f32 = torch.float32

    a = -torch.exp(a_log.to(f32))                              # [H] (neg)
    dta = dt * a                                               # [B,S,H]
    xdt = xh * dt[..., None].to(xh.dtype)                      # dt-weighted x

    # chunks, heads ahead of positions: dta [B,nc,H,cs], x^T [B,nc,H,P,cs],
    # B and C per group [B,nc,G,cs,N]
    tri = torch.ones((cs, cs), dtype=torch.bool, device=xh.device).tril()
    dta_c = dta.reshape(b, nc, cs, h).transpose(2, 3)
    x_t = xdt.reshape(b, nc, cs, h, p).permute(0, 1, 3, 4, 2).to(f32) \
        .contiguous()
    b_c = bmat.reshape(b, nc, cs, g, n).transpose(2, 3).to(f32)
    c_c = cmat.reshape(b, nc, cs, g, n).transpose(2, 3).to(f32)

    cum = dta_c @ tri.T.to(f32)                    # [B,nc,H,cs] inclusive
    # intra-chunk (lower-triangular) term; exp(-inf) = 0 above the
    # diagonal, with a gradient of 0 there (not exp(li) x 0)
    decay = (cum[..., :, None] - cum[..., None, :]) \
        .masked_fill_(~tri, float("-inf")).exp_()              # [B,nc,H,i,j]
    cb = c_c @ b_c.transpose(-1, -2)                           # [B,nc,G,i,j]
    scores = (cb[:, :, :, None] * decay.view(b, nc, g, rep, cs, cs)) \
        .view(b, nc, h, cs, cs)
    y_intra = scores @ x_t.transpose(-1, -2)                   # [B,nc,H,i,P]

    # chunk states: sum_j exp(cum_last - cum_j) * B_j (x) xdt_j
    seg = torch.exp(cum[..., -1:] - cum)                       # [B,nc,H,cs]
    states = ((x_t * seg[..., None, :]).view(b, nc, g, rep * p, cs)
              @ b_c).view(b, nc, h, p, n)                      # [B,nc,H,P,N]
    chunk_decay = torch.exp(cum[..., -1])                      # [B,nc,H]

    hs = (torch.zeros((b, h, p, n), dtype=f32, device=xh.device)
          if init_state is None else init_state.to(f32))
    prevs = []
    for c in range(nc):
        prevs.append(hs)
        hs = hs * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(prevs, 1)                            # [B,nc,H,P,N]

    # inter-chunk contribution: C_i . (decay_to_i * h_prev)
    ch = c_c @ h_prevs.view(b, nc, g, rep * p, n).transpose(-1, -2)
    y_inter = ch.view(b, nc, g, cs, rep, p) * torch.exp(cum).view(
        b, nc, g, rep, cs).transpose(-1, -2)[..., None]        # [B,nc,G,i,r,P]
    y = (y_intra.transpose(2, 3)
         + y_inter.permute(0, 1, 3, 2, 4, 5).reshape(b, nc, cs, h, p))
    y = y.reshape(b, s, h, p)
    y = y + xh.to(f32) * d_skip[None, None, :, None]
    return y.to(xh.dtype), hs


def mamba_block(p, x, cfg: ModelConfig, compute_dtype,
                ssm_state=None, conv_cache=None, decode_pos=None):
    """Full Mamba2 mixer. Train/prefill when decode_pos is None, else one
    recurrent decode step (S = 1; more raises `ValueError`).

    Returns (y [B,S,D], (new_ssm_state, new_conv_cache)).
    """
    m = cfg.mamba
    cd = compute_dtype
    f32 = torch.float32
    d_inner, n_heads, conv_dim = mamba_dims(cfg)
    b, s, _ = x.shape
    zxbcdt = x.to(cd) @ p["w_in"].to(cd)
    z, xi, bmat, cmat, dt = _split_proj(zxbcdt, cfg)

    conv_in = torch.cat([xi, bmat, cmat], dim=-1)
    conv_out, new_conv = _conv1d(conv_in, p["conv_w"].to(cd),
                                 p["conv_b"].to(cd), cache=conv_cache)
    gn = m.n_groups * m.d_state
    xi = conv_out[..., :d_inner]
    bmat = conv_out[..., d_inner:d_inner + gn]
    cmat = conv_out[..., d_inner + gn:]

    dt = _softplus(dt.to(f32) + p["dt_bias"].to(f32))
    xh = xi.reshape(b, s, n_heads, m.head_dim)
    bm = bmat.reshape(b, s, m.n_groups, m.d_state)
    cm = cmat.reshape(b, s, m.n_groups, m.d_state)

    if decode_pos is None:
        y, h_t = ssd_chunked(xh, dt, p["a_log"], bm, cm,
                             p["d_skip"].to(f32), m, init_state=ssm_state)
    else:
        if s != 1:
            raise ValueError(f"a recurrent SSM step of {s} tokens; step one "
                             "token at a time")
        a = -torch.exp(p["a_log"].to(f32))
        dta = torch.exp(dt[:, 0] * a)                          # [B,H]
        rep = n_heads // m.n_groups
        bh = _per_head(bm[:, 0], rep)                          # [B,H,N]
        ch = _per_head(cm[:, 0], rep)
        hs = (ssm_state.to(f32) if ssm_state is not None else
              torch.zeros((b, n_heads, m.head_dim, m.d_state), dtype=f32,
                          device=x.device))
        upd = (dt[:, 0, :, None, None] * xh[:, 0, :, :, None]
               * bh[:, :, None, :].to(f32))
        h_t = hs * dta[..., None, None] + upd
        yv = (h_t @ ch.to(f32)[..., None])[..., 0]             # [B,H,P]
        yv = yv + (xh[:, 0].to(f32)
                   * p["d_skip"].to(f32)[None, :, None])
        y = yv[:, None].to(cd)

    y = y.reshape(b, s, d_inner)
    y = rmsnorm(p["norm"], y * _silu(z.to(f32)).to(y.dtype), cfg.rms_eps)
    out = y.to(cd) @ p["w_out"].to(cd)
    return out, (h_t, new_conv)
