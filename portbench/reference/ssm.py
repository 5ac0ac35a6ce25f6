"""Plain reference of the "ssm" family's training loss: Mamba2
(arXiv:2405.21060, "Transformers are SSMs"), layers of RMSNorm and an
SSD mixer with the residual; a final RMSNorm; the output head tied to
the embedding; the mean next-token cross-entropy.

The mixer as the paper gives it: one input projection to (z, x, B, C,
dt); a causal depthwise convolution of width d_conv with a bias over
(x, B, C), then SiLU; dt = softplus(dt + dt_bias), A = -exp(a_log); the
selective state space
    y_t = sum_{s <= t} (C_t . B_s) exp(A sum_{r = s+1..t} dt_r) dt_s x_s
          + D x_t
computed in chunks (the paper's SSD algorithm: a quadratic form inside
each chunk, a linear recurrence of states between chunks) in fp32; the
gate: RMSNorm(y * silu(z)) over all of d_inner; the output projection.

Plain PyTorch; each layer under `torch.utils.checkpoint`.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.dense import rmsnorm
from portbench.reference.layout import ssm_dims


def ssd(x, dt, a, bm, cm, chunk: int):
    """x [S, H, P], dt [S, H], a [H] (negative), bm, cm [S, H, N] ->
    y [S, H, P] (without the D skip), fp32."""
    s, h, p = x.shape
    n = bm.shape[-1]
    L = min(chunk, s)
    nc = s // L
    xc = (x * dt[..., None]).reshape(nc, L, h, p)
    adt = (dt * a).reshape(nc, L, h).permute(2, 0, 1)           # [H, nc, L]
    bc = bm.reshape(nc, L, h, n)
    cc = cm.reshape(nc, L, h, n)
    cs = torch.cumsum(adt, dim=-1)                              # [H, nc, L]
    tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    seg = (cs[..., :, None] - cs[..., None, :]).masked_fill(~tri,
                                                            float("-inf"))
    decay = torch.exp(seg)                                      # [H,nc,L,L]
    cb = torch.einsum("clhn,cshn->hcls", cc, bc)
    y_diag = torch.einsum("hcls,cshp->clhp", cb * decay, xc)
    to_end = torch.exp(cs[..., -1:] - cs)                       # [H, nc, L]
    states = torch.einsum("cshn,hcs,cshp->chpn", bc, to_end, xc)
    chunk_decay = torch.exp(cs[..., -1])                        # [H, nc]
    prev = []
    hstate = torch.zeros(h, p, n, dtype=x.dtype, device=x.device)
    for c in range(nc):
        prev.append(hstate)
        hstate = hstate * chunk_decay[:, c, None, None] + states[c]
    prev = torch.stack(prev)                                    # [nc,H,P,N]
    y_off = torch.einsum("clhn,chpn,hcl->clhp", cc, prev, torch.exp(cs))
    return (y_diag + y_off).reshape(s, h, p)


def mixer(cfg: Dict, mm: Callable, y, w_in, conv_w, conv_b, a_log,
          dt_bias, d_skip, norm, w_out):
    s = y.shape[0]
    d_inner, heads, conv = ssm_dims(cfg)
    g, n, hp = cfg["n_groups"], cfg["d_state"], cfg["ssm_head_dim"]
    zxbcdt = mm(y, w_in)
    z = zxbcdt[:, :d_inner]
    xbc = zxbcdt[:, d_inner:d_inner + conv]
    dt = zxbcdt[:, d_inner + conv:]
    k = conv_w.shape[0]
    xbc = F.conv1d(F.pad(xbc.T[None], (k - 1, 0)), conv_w.T[:, None, :],
                   conv_b, groups=conv)[0].T
    xbc = F.silu(xbc)
    x = xbc[:, :d_inner].reshape(s, heads, hp)
    bm = xbc[:, d_inner:d_inner + g * n].reshape(s, g, n)
    cm = xbc[:, d_inner + g * n:].reshape(s, g, n)
    rep = heads // g
    bm = bm.repeat_interleave(rep, dim=1)
    cm = cm.repeat_interleave(rep, dim=1)
    dt = F.softplus(dt + dt_bias)
    yh = ssd(x, dt, -torch.exp(a_log), bm, cm, cfg["chunk_size"])
    yh = yh + x * d_skip[None, :, None]
    yv = rmsnorm(norm, yh.reshape(s, d_inner) * F.silu(z), cfg["rms_eps"])
    return mm(yv, w_out)


def layer(cfg: Dict, mm: Callable, x, pre, *w):
    return x + mixer(cfg, mm, rmsnorm(pre, x, cfg["rms_eps"]), *w)


MIXER = ("w_in", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm",
         "w_out")


def row_loss(cfg: Dict, p: Dict, tokens: torch.Tensor, mm: Callable):
    mix = ("blocks", "sub0", "mixer")
    x = p[("embed",)][tokens]
    for i in range(cfg["n_layers"]):
        x = checkpoint(layer, cfg, mm, x,
                       p[("blocks", "sub0", "pre_norm")][i],
                       *(p[mix + (w,)][i] for w in MIXER),
                       use_reentrant=False)
    x = rmsnorm(p[("final_norm",)], x, cfg["rms_eps"])
    logits = mm(x[:-1], p[("embed",)].T)
    return F.cross_entropy(logits, tokens[1:])
