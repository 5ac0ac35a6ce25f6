"""The dense and MoE model families (`repro.models.model`, `family` of
"dense", and "moe" without MLA): their parameter layout and their
serving path, prefill and decode, with gemma2's local/global layout and
Qwen3-MoE's routed experts.

Layers are stacked along a leading axis, as the reference's `_stack`
does, in the reference's period layout (`period_layout`): a period of
sub-layers repeated `n_periods` times, one `blocks/sub{j}` subtree per
sub-layer whose leaves carry [n_periods, ...]. The plain dense family
has one sub-layer (`sub0`, n_periods = n_layers), and so does the MoE
family, whose sub-layer's FFN is `models.moe`'s routed experts
(`moe_block`, the gather dispatch unless `Model(moe_impl="einsum")`;
groups are the batch rows, so a decode step routes each row's token
alone); gemma2's `local_global_pattern` has two, `sub0` attending
within its sliding window and `sub1` globally (n_periods = n_layers //
2), and with
`sandwich_norms` each sub-layer norms its mixer's and its FFN's output
(`post_mixer_norm`, `post_ffn_norm`) before the residual add. The stack
runs as a Python loop over periods and, in each, over the sub-layers'
views of those leaves, where the reference scans. `Model` stays a class
over the parameter pytree, as `Replica.resolve` returns it; it runs
under `torch.inference_mode()` on the device the parameters lie on.

The KV cache has the reference's structure, `{"blocks": {"sub{j}": (k,
v)}}` with k, v of [n_periods, B, slots, HK, D] in the compute dtype:
`max_len` slots for a global sub-layer, min(window, max_len) for a local
one, a ring buffer once the window fits (slot i holds the newest
position p with p = i mod window). Prefill allocates it zeroed at
`max(max_len, s)` positions for an s-token prompt and writes the
prompt's keys and values into it (the reference zero-pads a copy,
`_pad_seq`, which leaves a longer sequence as it is); a ring of w slots
takes a prompt of s >= w as `roll(k[:, -w:], s % w)`, the reference's
layout. `decode_step` writes its slot in place (position pos, or pos %
w on a ring; the reference returns an updated copy) and returns the
same tensors. A step whose tokens would not fit the global caches
raises `ValueError`, where the reference clamps the slot and overwrites
the last key (ROADMAP C, departures); so does a step of more than one
token on a ring (a departure: `greedy_decode` steps one token). Every
attention call goes to `self.attention`, B9 (`kernels.flash_attention`)
unless the caller passes a function of its signature. Decode attention
over a ring needs no mode of its own: every filled slot lies inside the
window, so the visible slots are 0 .. min(pos, w - 1), B9's causal mask
at q_offset = min(pos, w - 1) (the reference's `kv_positions = pos -
(pos - i) mod w`).

Training: `init(key)` draws the reference's parameters bit for bit
(threefry, per leaf `fold_in(key, SHA-256(path)[:4])`); `loss` is the
reference's training forward (no cache, no `inference_mode`) and its
causal cross-entropy, with each sub-layer under
`torch.utils.checkpoint` (non-reentrant) when `cfg.remat != "none"`,
the reference's `jax.checkpoint`. Under autograd every attention call
goes to B9's autograd function (forward with the log-sum-exp,
hand-written backward), with gemma2's softcap and, on its local
sub-layers, its window: gemma2 trains over its local/global periods,
sandwich norms, embedding scale and final softcap as the reference's
`Model.loss` does. `loss` takes the stacked `blocks/sub{j}` leaves or,
as the train step passes them, a list of per-period dicts for each
sub-layer (views that are autograd leaves of their own, so a layer's
gradient lands in its slice of the stacked gradient without a
full-size zero tensor per layer).

Each MoE sub-layer's router adds its Switch load-balancing term; `loss`
returns the cross-entropy plus `router_aux_coef` times their sum over
layers (under remat the term leaves each checkpointed layer beside its
output), as the reference's `Model.loss` does.

The MLA (DeepSeek-V2), SSM, hybrid, enc-dec and VLM families wait for
ROADMAP A7.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.dtypes import BY_NAME
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.schema import init_from_key, PDef


@dataclass(frozen=True)
class SubLayer:
    mixer: str            # attn (the other mixers wait for ROADMAP A7)
    ffn: str              # dense | moe
    window: int = 0       # sliding window for attn (0 = global)


def period_layout(cfg: ModelConfig) -> Tuple[List[SubLayer], int]:
    """Returns (sub-layers of one period, n_periods) for the stack: the
    reference's layouts of the dense family and of MoE without MLA."""
    if cfg.family == "moe":
        return [SubLayer("attn", "moe")], cfg.n_layers
    if cfg.local_global_pattern:
        return [SubLayer("attn", "dense", window=cfg.sliding_window),
                SubLayer("attn", "dense", window=0)], cfg.n_layers // 2
    return [SubLayer("attn", "dense")], cfg.n_layers


def _stack(schema: Any, n: int) -> Any:
    if isinstance(schema, PDef):
        return PDef((n,) + schema.shape, (None,) + schema.spec, schema.init,
                    schema.scale, schema.dtype)
    return {k: _stack(v, n) for k, v in schema.items()}


class Model:
    def __init__(self, cfg: ModelConfig,
                 attention: Optional[Callable] = None,
                 moe_impl: str = "gather"):
        if cfg.family not in ("dense", "moe") or cfg.mla is not None \
                or cfg.pad_heads_to_tp:
            raise NotImplementedError(
                f"{cfg.name}: only the dense layouts (plain and gemma2's "
                "local/global) and MoE without MLA are ported; the other "
                "families wait for ROADMAP A7")
        self.cfg = cfg
        self.compute_dtype = BY_NAME[cfg.compute_dtype]
        self.attention = attention or flash_attention
        self.moe_impl = moe_impl
        self.layout, self.n_periods = period_layout(cfg)

    # ------------------------------------------------------------- schema

    def _sublayer_schema(self, sl: SubLayer) -> dict:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        sub: Dict[str, Any] = {
            "pre_norm": L.rmsnorm_def(d),
            "attn": L.attn_def(d, cfg.n_heads, cfg.n_kv_heads, hd, 0.02),
            "ffn_norm": L.rmsnorm_def(d),
            "ffn": (MOE.moe_def(cfg) if sl.ffn == "moe" else
                    L.mlp_def(d, cfg.d_ff, cfg.mlp_variant, 0.02)),
        }
        if cfg.sandwich_norms:
            sub["post_mixer_norm"] = L.rmsnorm_def(d)
            sub["post_ffn_norm"] = L.rmsnorm_def(d)
        return sub

    def schema(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        period = {f"sub{j}": self._sublayer_schema(sl)
                  for j, sl in enumerate(self.layout)}
        sc: Dict[str, Any] = {
            "embed": PDef((cfg.vocab_size, d), ("tp", None), scale=0.02),
            "final_norm": L.rmsnorm_def(d),
            "blocks": _stack(period, self.n_periods),
        }
        if not cfg.tie_embeddings:
            sc["lm_head"] = PDef((d, cfg.vocab_size), (None, "tp"),
                                 scale=0.02)
        return sc

    def init(self, key, *, device: Any = "cuda") -> dict:
        """The reference's `model.init(key)`, bit for bit, on `device`;
        `key` is a threefry key (`random.PRNGKey(seed)`)."""
        return init_from_key(self.schema(), key, device=device)

    # ------------------------------------------------------------ training

    def loss(self, params, batch):
        """batch: tokens [B, S]. Returns (loss, {"ce", "aux"}): ce, the
        causal cross-entropy of the training forward (`_logits`' head,
        logit multiplier and final softcap, then the mean over B x (S - 1)
        of logsumexp - the target's logit, computed by `_HeadCE`); aux,
        the routers' load-balancing terms summed over the MoE layers (0
        without MoE); loss = ce + router_aux_coef x aux."""
        cfg = self.cfg
        tokens = self._tokens(params, batch["tokens"])
        x = self._embed(params, tokens)
        x, aux = self._run_stack(params, x, mode="train")
        x, head = self._head_inputs(params, x)
        ce = _HeadCE.apply(x, head, tokens[:, 1:].long(),
                           float(cfg.logit_mult), float(cfg.final_softcap))
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        total = ce + cfg.moe.router_aux_coef * aux if cfg.moe else ce
        return total, {"ce": ce, "aux": aux}

    # --------------------------------------------------------- sub-layers

    def _apply_mixer(self, sl: SubLayer, p, x, *, mode, cache, pos):
        """Attention, plain or within `sl.window`; `mode` is "train",
        "prefill" or "decode". `cache` (prefill and decode): this
        layer's (k, v) views of [B, slots, HK, D], written in place.
        Returns the mixer's output."""
        cfg = self.cfg
        cd = self.compute_dtype
        hd = cfg.resolved_head_dim
        if mode == "decode":
            k_cache, v_cache = cache
            k_new, v_new = self._project_kv(p["attn"], x, rope=True,
                                            pos=pos)
            s = x.shape[1]
            slots = k_cache.shape[1]
            ring = _is_ring(sl, slots)
            slot = pos % slots if ring else pos
            k_cache[:, slot:slot + s] = k_new.to(k_cache.dtype)
            v_cache[:, slot:slot + s] = v_new.to(v_cache.dtype)
            if ring:
                # every filled slot lies inside the window: slots
                # 0 .. min(pos, slots - 1) are visible
                return self._attn_with_cache(p["attn"], x, k_cache, v_cache,
                                             pos, q_offset=min(pos,
                                                               slots - 1))
            return self._attn_with_cache(p["attn"], x, k_cache, v_cache,
                                         pos, q_offset=pos,
                                         window=sl.window)
        out = L.gqa_attention(
            p["attn"], x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=hd, rope_theta=cfg.rope_theta, window=sl.window,
            softcap=cfg.attn_softcap, q_scale=cfg.query_scale,
            compute_dtype=cd, attention=self.attention)
        if mode == "train":
            return out
        k, v = self._project_kv(p["attn"], x, rope=True)
        s, slots = k.shape[1], cache[0].shape[1]
        if sl.window and s >= slots:
            # a ring of `slots` positions: slot i holds the last position
            # p = i mod slots, the reference's roll of the last slots keys
            k = torch.roll(k[:, s - slots:], s % slots, dims=1)
            v = torch.roll(v[:, s - slots:], s % slots, dims=1)
        cache[0][:, :k.shape[1]] = k
        cache[1][:, :v.shape[1]] = v
        return out

    def _project_kv(self, p, x, *, rope, pos=None):
        cfg = self.cfg
        cd = self.compute_dtype
        hd = cfg.resolved_head_dim
        b, s, _ = x.shape
        xc = x.to(cd)
        k = (xc @ p["wk"].to(cd)).reshape(b, s, cfg.n_kv_heads, hd)
        v = (xc @ p["wv"].to(cd)).reshape(b, s, cfg.n_kv_heads, hd)
        if rope and cfg.rope_theta > 0:
            positions = torch.arange(s, device=x.device)
            if pos is not None:
                positions = pos + positions
            k = L.apply_rope(k, positions, cfg.rope_theta)
        return k, v

    def _attn_with_cache(self, p, x, k_cache, v_cache, pos, *, q_offset,
                         window=0):
        """Decode attention over the whole cache: B9 at `q_offset` sees
        slots 0 .. q_offset + i (and, with a `window`, those within it),
        the reference's `kv_valid` mask. The queries sit at `pos` for
        RoPE."""
        cfg = self.cfg
        cd = self.compute_dtype
        hd = cfg.resolved_head_dim
        b, s, _ = x.shape
        q = (x.to(cd) @ p["wq"].to(cd)).reshape(b, s, cfg.n_heads, hd)
        if cfg.rope_theta > 0:
            q = L.apply_rope(q, pos + torch.arange(s, device=x.device),
                             cfg.rope_theta)
        out = self.attention(q, k_cache.to(cd), v_cache.to(cd), causal=True,
                             scale=cfg.query_scale, q_offset=q_offset,
                             window=window, softcap=cfg.attn_softcap)
        return out.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(cd)

    def _apply_sublayer(self, sl: SubLayer, p, x, *, mode, cache=None,
                        pos=None):
        """(x, aux): the sub-layer's output and its router's
        load-balancing term (None for a dense FFN)."""
        cfg = self.cfg
        # the scale rounded to the residual's dtype, as a weak-typed
        # Python float meets a bf16 array in the reference
        rs = torch.tensor(cfg.residual_scale, dtype=x.dtype).item()
        h = L.rmsnorm(p["pre_norm"], x, cfg.rms_eps)
        mix = self._apply_mixer(sl, p, h, mode=mode, cache=cache, pos=pos)
        if cfg.sandwich_norms:
            mix = L.rmsnorm(p["post_mixer_norm"], mix, cfg.rms_eps)
        x = x + rs * mix
        h = L.rmsnorm(p["ffn_norm"], x, cfg.rms_eps)
        aux = None
        if sl.ffn == "moe":
            y, aux = MOE.moe_block(p["ffn"], h, cfg, self.compute_dtype,
                                   impl=self.moe_impl)
        else:
            y = L.mlp(p["ffn"], h, cfg.mlp_variant, self.compute_dtype)
        if cfg.sandwich_norms:
            y = L.rmsnorm(p["post_ffn_norm"], y, cfg.rms_eps)
        return x + rs * y, aux

    # ------------------------------------------------------------ drivers

    def _run_stack(self, params, x, *, mode, caches=None, pos=None):
        """The stack, period by period and in each the sub-layers in
        order, one layer's views of the stacked leaves at a time.
        `caches`: {"sub{j}": (k, v)} of [n_periods, ...] tensors. In
        training each layer runs under `checkpoint` unless `cfg.remat`
        is "none" (its activations are recomputed in the backward).
        Returns (x, aux): aux sums the MoE layers' router terms in layer
        order (None without MoE layers)."""
        blocks = params["blocks"]
        remat = mode == "train" and self.cfg.remat != "none"
        aux_sum = None
        for i in range(self.n_periods):
            for j, sl in enumerate(self.layout):
                name = f"sub{j}"
                sub = blocks[name]
                bp = sub[i] if isinstance(sub, list) else \
                    pytree.tree_map(lambda t: t[i], sub)
                if remat:
                    x, aux = checkpoint(
                        functools.partial(self._train_layer, sl), bp, x,
                        use_reentrant=False, preserve_rng_state=False)
                else:
                    cache = None if caches is None else \
                        (caches[name][0][i], caches[name][1][i])
                    x, aux = self._apply_sublayer(sl, bp, x, mode=mode,
                                                  cache=cache, pos=pos)
                if aux is not None:
                    aux_sum = aux if aux_sum is None else aux_sum + aux
        return x, aux_sum

    def _train_layer(self, sl, bp, x):
        return self._apply_sublayer(sl, bp, x, mode="train")

    # -------------------------------------------------------- embeddings

    def _embed(self, params, tokens):
        """Token embeddings in the compute dtype. (The reference's
        `activation_constraint` is the identity on one device; sharding
        waits for ROADMAP A8.)"""
        cd = self.compute_dtype
        x = params["embed"][tokens.long()]
        # the scale rounded to the compute dtype on the host, as
        # `jnp.asarray(emb_scale, cd)`; a device tensor made here would
        # be a blocking copy, stalling the host on every decode step
        return x.to(cd) * torch.tensor(self.cfg.emb_scale, dtype=cd).item()

    def _head_inputs(self, params, x):
        """The final norm's output and the output head (the embedding's
        transpose when tied), both in the compute dtype."""
        cfg = self.cfg
        cd = self.compute_dtype
        x = L.rmsnorm(params["final_norm"], x, cfg.rms_eps)
        head = (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])
        return x.to(cd), head.to(cd)

    def _logits(self, params, x):
        x, head = self._head_inputs(params, x)
        return _head_fp32(x @ head, self.cfg.logit_mult,
                          self.cfg.final_softcap)[0]

    @staticmethod
    def _tokens(params, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=params["embed"].device)

    # ----------------------------------------------------------- serving

    @torch.inference_mode()
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Full-sequence forward building a decode cache.

        `max_len` pre-sizes the KV caches for decode; a cache is never
        shorter than the prompt, so without it (or below the prompt
        length) the cache holds the prompt alone and a decode step on it
        raises. Returns (last-token logits [B, V] fp32, caches).
        """
        tokens = self._tokens(params, batch["tokens"])
        b, s = tokens.shape
        caches = self.init_cache(b, max(max_len or s, s),
                                 device=params["embed"].device)
        x = self._embed(params, tokens)
        x, _ = self._run_stack(params, x, mode="prefill",
                               caches=caches["blocks"])
        logits = self._logits(params, x[:, -1:])
        return logits[:, 0], caches

    @torch.inference_mode()
    def decode_step(self, params, caches, token, pos: int):
        """One decode step. token: [B, 1]; pos: its position.

        Returns (logits [B, V] fp32, caches), the caches written in place.
        Raises `ValueError` when the step's positions pos .. pos + s - 1
        run past the global caches (the reference clamps the slot to the
        last one), or when a step of s > 1 tokens meets a ring cache.
        """
        tokens = self._tokens(params, token)
        s = tokens.shape[1]
        slots = [caches["blocks"][f"sub{j}"][0].shape[2]
                 for j in range(len(self.layout))]
        rings = [_is_ring(sl, n) for sl, n in zip(self.layout, slots)]
        held = [n for n, ring in zip(slots, rings) if not ring]
        if int(pos) < 0 or (held and int(pos) + s > min(held)):
            raise ValueError(
                f"decode at position {int(pos)} of {s} token(s) does not "
                f"fit a {min(held) if held else 0}-slot KV cache; pre-size "
                "it with prefill(..., max_len=...)")
        if s > 1 and any(rings):
            raise ValueError(
                f"a decode step of {s} tokens on a sliding-window ring "
                "cache; step one token at a time")
        x = self._embed(params, tokens)
        x, _ = self._run_stack(params, x, mode="decode",
                               caches=caches["blocks"], pos=int(pos))
        return self._logits(params, x)[:, 0], caches

    # ------------------------------------------------------------- cache

    def init_cache(self, batch_size: int, max_len: int, *,
                   device: Any = "cuda"):
        """Zeroed cache pytree for decode: max_len slots per global
        sub-layer, min(window, max_len) per local one."""
        cfg = self.cfg
        kw = dict(dtype=self.compute_dtype, device=device)
        blocks = {}
        for j, sl in enumerate(self.layout):
            slots = min(sl.window, max_len) if sl.window else max_len
            shape = (self.n_periods, batch_size, slots, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            blocks[f"sub{j}"] = (torch.zeros(shape, **kw),
                                 torch.zeros(shape, **kw))
        return {"blocks": blocks}


def _is_ring(sl: SubLayer, slots: int) -> bool:
    """A local sub-layer's cache is a ring once the window fits in it."""
    return bool(sl.window) and sl.window <= slots


# positions of the head's fp32 stage a chunk: [rows, V] fp32 under 2^28
# elements (1 GiB)
_CE_ELEMS = 1 << 28


def _ce_chunks(b: int, n: int, v: int):
    """(batch row, first, end position) chunks over B x n positions."""
    step = max(1, _CE_ELEMS // max(v, 1))
    for bi in range(b):
        for p0 in range(0, n, step):
            yield bi, p0, min(n, p0 + step)


def _head_fp32(rows, mult: float, cap: float):
    """(logits, tanh) of the head's fp32 stage (`_logits`, `_HeadCE`)
    for rows of the compute-dtype logits: times the logit multiplier
    (skipped at 1.0, where it changes no bit), then cap tanh(z / cap)
    under a final softcap (tanh None without one)."""
    z = rows.to(torch.float32)
    if mult != 1.0:
        z = z * mult
    if not cap > 0:
        return z, None
    t = torch.tanh(z / cap)
    return cap * t, t


class _HeadCE(torch.autograd.Function):
    """The training loss's tail: logits = x @ head in the compute dtype,
    then, as `_logits` and the reference's `_causal_ce`, in fp32 the
    logit multiplier, the final softcap, and the mean over B x (S - 1) of
    logsumexp(pred) - pred[target] (the target's logit gathered: x + 0 =
    x, the reference's sum against a one-hot, for finite logits). Only
    the compute-dtype logits are kept for the backward ([B, S, V]: 4.2 GB
    in bf16 at gemma2's vocabulary of 256,000 and 8192 tokens, where
    autograd over the same ops kept two fp32 copies, 16.8 GB, and made as
    many again in its backward, past the card beside gemma2's training
    state). The fp32 steps run over chunks of positions (`_ce_chunks`);
    the backward recomputes them chunk by chunk with autograd's own
    formulas (softmax times the mean's 1 / N, minus it at the target,
    then the softcap's c (1 - t^2) / c and the multiplier), writes the
    logits' gradient over the kept logits in the compute dtype, and
    takes dx and dhead as one product each, as autograd's matmul
    backward does."""

    @staticmethod
    def forward(ctx, x, head, tgt, mult: float, cap: float):
        """x [B, S, d] and head [d, V] in the compute dtype; tgt [B, S - 1]
        int64 (the next tokens). Returns the mean cross-entropy."""
        logits = x @ head
        b, s, v = logits.shape
        lse = torch.empty((b, s - 1), dtype=torch.float32,
                          device=logits.device)
        ce = torch.empty_like(lse)
        for bi, p0, p1 in _ce_chunks(b, s - 1, v):
            z, _ = _head_fp32(logits[bi, p0:p1], mult, cap)
            lse[bi, p0:p1] = torch.logsumexp(z, dim=-1)
            ce[bi, p0:p1] = lse[bi, p0:p1] - torch.gather(
                z, -1, tgt[bi, p0:p1, None])[:, 0]
        ctx.save_for_backward(x, head, tgt, logits, lse)
        ctx.mult, ctx.cap = mult, cap
        return torch.mean(ce)

    @staticmethod
    def backward(ctx, g):
        x, head, tgt, logits, lse = ctx.saved_tensors
        b, s, v = logits.shape
        gn = g / lse.numel()                   # the mean's backward
        for bi, p0, p1 in _ce_chunks(b, s - 1, v):
            rows = logits[bi, p0:p1]
            z, t = _head_fp32(rows, ctx.mult, ctx.cap)
            d = z.sub_(lse[bi, p0:p1, None]).exp_().mul_(gn)
            d.scatter_add_(-1, tgt[bi, p0:p1, None],
                           (-gn).expand(p1 - p0, 1))
            if t is not None:
                d.mul_(ctx.cap).mul_(t.mul_(t).neg_().add_(1)) \
                    .div_(ctx.cap)
            if ctx.mult != 1.0:
                d.mul_(ctx.mult)
            rows.copy_(d)
            del z, t, d
        logits[:, s - 1:] = 0                  # the last position: no target
        dl = logits.reshape(-1, v)
        dx = (dl @ head.T).reshape(x.shape)
        dhead = x.reshape(-1, x.shape[-1]).T @ dl
        return dx, dhead, None, None, None
