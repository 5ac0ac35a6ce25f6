"""The dense, MoE, SSM, hybrid, enc-dec and VLM model families
(`repro.models.model`, `family` of "dense", "moe" with or without MLA,
"ssm", "hybrid", "encdec" and "vlm"): their parameter layout, their
training forward and their serving path, prefill and decode, with
gemma2's local/global layout, Qwen3-MoE's routed experts, DeepSeek-V2's
latent attention, Mamba2's SSD mixers, Jamba's periods that mix them,
Whisper's encoder-decoder and the VLM's gated cross-attention.

Layers are stacked along a leading axis, as the reference's `_stack`
does, in the reference's period layout (`period_layout`): a period of
sub-layers repeated `n_periods` times, one `blocks/sub{j}` subtree per
sub-layer whose leaves carry [n_periods, ...]. The plain dense family
has one sub-layer (`sub0`, n_periods = n_layers), and so does the MoE
family, whose sub-layer's FFN is `models.moe`'s routed experts
(`moe_block`, the gather dispatch unless `Model(moe_impl="einsum")`;
groups are the batch rows, so a decode step routes each row's token
alone); with `cfg.mla` (DeepSeek-V2) that sub-layer's mixer is
`models.mla`'s latent attention (its parameters under `attn`), and layer
0 sits outside the stack as `first`, MLA with a dense FFN of d_ff
(n_periods = n_layers - 1; `_apply_first`); gemma2's
`local_global_pattern` has two, `sub0` attending within its sliding
window and `sub1` globally (n_periods = n_layers // 2); the SSM family
has one, a Mamba2 mixer (`models.mamba`, its parameters under `mixer`)
and no FFN; the hybrid family (Jamba) has
`hybrid_period`, attention at `hybrid_attn_index` and a Mamba2 mixer
elsewhere, each with an FFN that is routed experts where j % interval
== offset % interval and dense otherwise (n_periods = n_layers //
hybrid_period); the VLM family (Llama-3.2-Vision) has
`cross_attn_interval`, self-attention sub-layers and last a `cross` one
that attends, without a causal mask or RoPE, to the batch's "patches"
(its keys and values projected from them, `kv_input_dim` = d_model) and
scales its mixer's and its FFN's outputs by tanh of its 0-d `gate_attn`
and `gate_ffn` (zeros at init, so the sub-layer starts as the identity);
and with
`sandwich_norms` each sub-layer norms its mixer's and its FFN's output
(`post_mixer_norm`, `post_ffn_norm`) before the residual add. The stack
runs as a Python loop over periods and, in each, over the sub-layers'
views of those leaves, where the reference scans. `Model` stays a class
over the parameter pytree, as `Replica.resolve` returns it; it runs
under `torch.inference_mode()` on the device the parameters lie on.

The cache has the reference's structure, `{"blocks": {"sub{j}": (k,
v)}}` for an attention sub-layer, with k, v of [n_periods, B, slots, HK,
D] in the compute dtype:
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
(pos - i) mod w`). A Mamba sub-layer's cache is (ssm, conv): the SSM
state [n_periods, B, H, P, N] in fp32 and the conv's last d_conv - 1
inputs [n_periods, B, d_conv - 1, conv_dim] in the compute dtype, both
written in place by prefill (the prompt's final state) and by each
decode step (the recurrent update); it has no slots, so no length
bounds a decode, and a step of more than one token on it raises
`ValueError` (the reference's recurrent branch reads token 0 alone and
its reshape then fails). An MLA sub-layer's cache is (c, k_rope): the
normalized latent [n_periods, B, slots, kv_lora_rank] and the rotated
rope key [n_periods, B, slots, d_rope] in the compute dtype (`first`'s
under "first", without the period axis), written in place by prefill
(the reference pads a copy, `_pad_seq`) and by each decode step; a step
of more than one token on it raises `ValueError` (the reference's
absorbed decode fixes a single position).

Training: `init(key)` draws the reference's parameters bit for bit
(threefry, per leaf `fold_in(key, SHA-256(path)[:4])`); `loss` is the
reference's training forward (no cache, no `inference_mode`) and its
causal cross-entropy, with each sub-layer (each decoder layer of the
enc-dec family, whose encoder runs without it, as the reference's) under
`torch.utils.checkpoint` (non-reentrant) when `cfg.remat != "none"`,
the reference's `jax.checkpoint`. The enc-dec and VLM families need the
batch's frames or patches (`_context`): without them `loss` and
`prefill` raise `ValueError`, where the reference raises `KeyError`
(its train CLI and Branch-Train-Merge feed tokens alone, and so do the
port's). Under autograd every attention call
goes to B9's autograd function (forward with the log-sum-exp,
hand-written backward), with gemma2's softcap and, on its local
sub-layers, its window: gemma2 trains over its local/global periods,
sandwich norms, embedding scale and final softcap as the reference's
`Model.loss` does. `loss` takes the stacked `blocks/sub{j}` leaves or,
as the train step passes them, a list of per-period dicts for each
sub-layer (and for `enc_blocks` / `dec_blocks` a list of per-layer
dicts; views that are autograd leaves of their own, so a layer's
gradient lands in its slice of the stacked gradient without a
full-size zero tensor per layer).

Each MoE sub-layer's router adds its Switch load-balancing term; `loss`
returns the cross-entropy plus `router_aux_coef` times their sum over
the MoE sub-layers (under remat the term leaves each checkpointed layer
beside its output), as the reference's `Model.loss` does (its dense
sub-layers add exact zeros).

`cfg.pad_heads_to_tp` rounds the query and KV head counts up to a
multiple of it (Megatron-style tensor-parallel padding), as the
reference's `Model` does; `param_shapes` and `logical_specs` are the
reference's dry-run views of the schema (meta tensors and logical
sharding axes, `repro_torch.sharding.policy`).
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
from repro_torch.models import mamba as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.schema import (init_from_key, meta_from_schema, PDef,
                                       specs_from_schema)


@dataclass(frozen=True)
class SubLayer:
    mixer: str            # attn | mla | mamba | cross
    ffn: str              # dense | moe | none
    window: int = 0       # sliding window for attn (0 = global)


def period_layout(cfg: ModelConfig) -> Tuple[List[SubLayer], int]:
    """Returns (sub-layers of one period, n_periods) for the stack: the
    reference's layouts of the dense family, of MoE with and without
    MLA (DeepSeek-V2's layer 0, dense, is `first`, outside the stack),
    of the SSM, hybrid and VLM families (the enc-dec family has no
    period stack: the plain dense layout, as the reference returns
    it)."""
    if cfg.family == "ssm":
        return [SubLayer("mamba", "none")], cfg.n_layers
    if cfg.family == "hybrid":
        per = []
        for j in range(cfg.hybrid_period):
            mixer = "attn" if j == cfg.hybrid_attn_index else "mamba"
            ffn = "moe" if (cfg.moe and j % cfg.moe.interval == cfg.moe.offset
                            % cfg.moe.interval) else "dense"
            per.append(SubLayer(mixer, ffn))
        return per, cfg.n_layers // cfg.hybrid_period
    if cfg.family == "vlm":
        n = cfg.cross_attn_interval
        per = [SubLayer("attn", "dense") for _ in range(n - 1)]
        per.append(SubLayer("cross", "dense"))
        return per, cfg.n_layers // n
    if cfg.family == "moe" and cfg.mla is not None:
        return [SubLayer("mla", "moe")], cfg.n_layers - 1
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
        if cfg.pad_heads_to_tp and cfg.n_heads:
            # round the head counts up to a multiple of the tensor-parallel
            # degree (minicpm's 36 heads, whisper's 6), as the reference
            m = cfg.pad_heads_to_tp
            cfg = cfg.replace(n_heads=_round_up(cfg.n_heads, m),
                              n_kv_heads=_round_up(cfg.n_kv_heads, m))
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "encdec",
                              "vlm"):
            raise NotImplementedError(f"{cfg.name}: family {cfg.family!r}")
        self.cfg = cfg
        self.compute_dtype = BY_NAME[cfg.compute_dtype]
        self.attention = attention or flash_attention
        self.moe_impl = moe_impl
        self.encdec = cfg.family == "encdec"
        self.layout, self.n_periods = ([], 0) if self.encdec else \
            period_layout(cfg)

    # ------------------------------------------------------------- schema

    def _sublayer_schema(self, sl: SubLayer) -> dict:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        sub: Dict[str, Any] = {"pre_norm": L.rmsnorm_def(d)}
        if sl.mixer == "mamba":
            sub["mixer"] = M.mamba_def(cfg)
        elif sl.mixer == "mla":
            sub["attn"] = MLA.mla_def(cfg)
        elif sl.mixer == "cross":
            sub["attn"] = L.attn_def(d, cfg.n_heads, cfg.n_kv_heads, hd,
                                     0.02, kv_input_dim=d)
            sub["gate_attn"] = PDef((), (), init="zeros")
            sub["gate_ffn"] = PDef((), (), init="zeros")
        else:
            sub["attn"] = L.attn_def(d, cfg.n_heads, cfg.n_kv_heads, hd, 0.02)
        if sl.ffn != "none":
            sub["ffn_norm"] = L.rmsnorm_def(d)
            sub["ffn"] = (MOE.moe_def(cfg) if sl.ffn == "moe" else
                          L.mlp_def(d, cfg.d_ff, cfg.mlp_variant, 0.02))
        if cfg.sandwich_norms:
            sub["post_mixer_norm"] = L.rmsnorm_def(d)
            if sl.ffn != "none":
                sub["post_ffn_norm"] = L.rmsnorm_def(d)
        return sub

    def schema(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        sc: Dict[str, Any] = {
            "embed": PDef((cfg.vocab_size, d), ("tp", None), scale=0.02),
            "final_norm": L.rmsnorm_def(d),
        }
        if not cfg.tie_embeddings:
            sc["lm_head"] = PDef((d, cfg.vocab_size), (None, "tp"),
                                 scale=0.02)
        if self.encdec:
            hd = cfg.resolved_head_dim

            def attn():
                return L.attn_def(d, cfg.n_heads, cfg.n_kv_heads, hd, 0.02)

            def ffn():
                return L.mlp_def(d, cfg.d_ff, cfg.mlp_variant, 0.02)

            enc = {"pre_norm": L.rmsnorm_def(d), "attn": attn(),
                   "ffn_norm": L.rmsnorm_def(d), "ffn": ffn()}
            dec = {"pre_norm": L.rmsnorm_def(d), "attn": attn(),
                   "cross_norm": L.rmsnorm_def(d), "cross": attn(),
                   "ffn_norm": L.rmsnorm_def(d), "ffn": ffn()}
            sc["enc_blocks"] = _stack(enc, cfg.n_encoder_layers)
            sc["enc_final_norm"] = L.rmsnorm_def(d)
            sc["dec_blocks"] = _stack(dec, cfg.n_layers)
            return sc
        period = {f"sub{j}": self._sublayer_schema(sl)
                  for j, sl in enumerate(self.layout)}
        sc["blocks"] = _stack(period, self.n_periods)
        if cfg.mla is not None:      # DeepSeek-V2's dense layer 0
            sc["first"] = self._sublayer_schema(FIRST)
        return sc

    def init(self, key, *, device: Any = "cuda") -> dict:
        """The reference's `model.init(key)`, bit for bit, on `device`;
        `key` is a threefry key (`random.PRNGKey(seed)`)."""
        return init_from_key(self.schema(), key, device=device)

    def param_shapes(self) -> dict:
        """The parameters' shapes and dtypes as meta tensors (the
        reference's `ShapeDtypeStruct` tree)."""
        return meta_from_schema(self.schema())

    def logical_specs(self) -> dict:
        """Each parameter's logical sharding axes ("fsdp", "tp", "ep" or
        None a dimension), the reference's `logical_specs`."""
        return specs_from_schema(self.schema())

    # ------------------------------------------------------------ training

    def loss(self, params, batch):
        """batch: tokens [B, S], with the enc-dec family's "frames" [B,
        encoder_seq, d] or the VLM's "patches" [B, num_patches, d]
        (`ValueError` without them, `_context`). Returns (loss, {"ce",
        "aux"}): ce, the
        causal cross-entropy of the training forward (`_logits`' head,
        logit multiplier and final softcap, then the mean over B x (S - 1)
        of logsumexp - the target's logit, computed by `_HeadCE`); aux,
        the routers' load-balancing terms summed over the MoE layers (0
        without MoE); loss = ce + router_aux_coef x aux."""
        cfg = self.cfg
        tokens = self._tokens(params, batch["tokens"])
        ctx = self._context(params, batch)
        if self.encdec:
            enc = self._encode(params, ctx["frames"])
            x = self._run_encdec_stack(params, self._dec_inputs(params,
                                                                tokens),
                                       enc, mode="train")
            aux = None
        else:
            x = self._embed(params, tokens)
            x = self._apply_first(params, x, mode="train")
            x, aux = self._run_stack(params, x, mode="train", ctx=ctx)
        x, head = self._head_inputs(params, x)
        ce = _HeadCE.apply(x, head, tokens[:, 1:].long(),
                           float(cfg.logit_mult), float(cfg.final_softcap))
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=ce.device)
        total = ce + cfg.moe.router_aux_coef * aux if cfg.moe else ce
        return total, {"ce": ce, "aux": aux}

    # --------------------------------------------------------- sub-layers

    def _apply_mixer(self, sl: SubLayer, p, x, *, mode, cache, pos,
                     ctx=None):
        """Attention, plain or within `sl.window`, MLA, a Mamba2 mixer, or
        cross-attention over `ctx["patches"]` (the VLM); `mode` is
        "train", "prefill" or "decode". `cache` (prefill and decode): this
        layer's views, written in place: (k, v) of [B, slots, HK, D],
        (c, k_rope) of [B, slots, R] and [B, slots, Dr] for MLA, (ssm,
        conv) for a Mamba mixer, or the cross-attention's static (k, v)
        of [B, num_patches, HK, D], which prefill writes once and decode
        reads whole. Returns the mixer's output."""
        cfg = self.cfg
        cd = self.compute_dtype
        hd = cfg.resolved_head_dim
        if sl.mixer == "cross":
            if mode == "decode":
                return self._attn_with_cache(p["attn"], x, *cache, pos,
                                             q_offset=0, causal=False,
                                             rope=False)
            kv_x = ctx["patches"]
            out = L.gqa_attention(
                p["attn"], x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=hd, rope_theta=0.0, causal=False, compute_dtype=cd,
                kv_x=kv_x, use_rope=False, attention=self.attention)
            if mode == "prefill":
                k, v = self._project_kv(p["attn"], kv_x, rope=False)
                cache[0].copy_(k)
                cache[1].copy_(v)
            return out
        if sl.mixer == "mla":
            if mode == "decode":
                return MLA.mla_decode(p["attn"], x, *cache, pos, cfg, cd)
            out = MLA.mla_attention(p["attn"], x, cfg,
                                    q_chunk=cfg.attn_q_chunk,
                                    compute_dtype=cd,
                                    latent=mode == "prefill")
            if mode == "train":
                return out
            out, (c, k_rope) = out
            cache[0][:, :c.shape[1]] = c
            cache[1][:, :k_rope.shape[1]] = k_rope
            return out
        if sl.mixer == "mamba":
            if mode == "train":
                return M.mamba_block(p["mixer"], x, cfg, cd)[0]
            ssm, conv = cache
            decode = mode == "decode"
            out, (new_ssm, new_conv) = M.mamba_block(
                p["mixer"], x, cfg, cd,
                ssm_state=ssm if decode else None,
                conv_cache=conv if decode else None,
                decode_pos=pos if decode else None)
            ssm.copy_(new_ssm)
            conv.copy_(new_conv)
            return out
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
                         window=0, causal=True, rope=True):
        """Decode attention over the whole cache: B9 at `q_offset` sees
        slots 0 .. q_offset + i (and, with a `window`, those within it),
        the reference's `kv_valid` mask; without `causal` (a static
        cross-attention cache: Whisper's encoder output, the VLM's
        patches) it sees every slot. The queries sit at `pos` for RoPE
        (none without `rope`)."""
        cfg = self.cfg
        cd = self.compute_dtype
        hd = cfg.resolved_head_dim
        b, s, _ = x.shape
        q = (x.to(cd) @ p["wq"].to(cd)).reshape(b, s, cfg.n_heads, hd)
        if rope and cfg.rope_theta > 0:
            q = L.apply_rope(q, pos + torch.arange(s, device=x.device),
                             cfg.rope_theta)
        out = self.attention(q, k_cache.to(cd), v_cache.to(cd),
                             causal=causal,
                             scale=cfg.query_scale, q_offset=q_offset,
                             window=window, softcap=cfg.attn_softcap)
        return out.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(cd)

    def _apply_sublayer(self, sl: SubLayer, p, x, *, mode, cache=None,
                        pos=None, ctx=None):
        """(x, aux): the sub-layer's output and its router's
        load-balancing term (None for a dense FFN or none). A
        cross-attention sub-layer scales its mixer's and its FFN's
        outputs by tanh of its `gate_attn` and `gate_ffn` (0-d, fp32
        tanh, cast to the output's dtype)."""
        cfg = self.cfg
        # the scale rounded to the residual's dtype, as a weak-typed
        # Python float meets a bf16 array in the reference
        rs = torch.tensor(cfg.residual_scale, dtype=x.dtype).item()
        h = L.rmsnorm(p["pre_norm"], x, cfg.rms_eps)
        mix = self._apply_mixer(sl, p, h, mode=mode, cache=cache, pos=pos,
                                ctx=ctx)
        if cfg.sandwich_norms:
            mix = L.rmsnorm(p["post_mixer_norm"], mix, cfg.rms_eps)
        if sl.mixer == "cross":
            mix = _gate(p["gate_attn"], mix)
        x = x + rs * mix
        if sl.ffn == "none":
            return x, None
        h = L.rmsnorm(p["ffn_norm"], x, cfg.rms_eps)
        aux = None
        if sl.ffn == "moe":
            y, aux = MOE.moe_block(p["ffn"], h, cfg, self.compute_dtype,
                                   impl=self.moe_impl)
        else:
            y = L.mlp(p["ffn"], h, cfg.mlp_variant, self.compute_dtype)
        if cfg.sandwich_norms:
            y = L.rmsnorm(p["post_ffn_norm"], y, cfg.rms_eps)
        if sl.mixer == "cross":
            y = _gate(p["gate_ffn"], y)
        return x + rs * y, aux

    # ------------------------------------------------------------ drivers

    def _run_stack(self, params, x, *, mode, caches=None, pos=None,
                   ctx=None):
        """The stack, period by period and in each the sub-layers in
        order, one layer's views of the stacked leaves at a time.
        `caches`: {"sub{j}": (k, v)} of [n_periods, ...] tensors; `ctx`:
        the VLM's {"patches"}. In
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
                bp = _layer(blocks[name], i)
                if remat:
                    x, aux = checkpoint(
                        functools.partial(self._train_layer, sl, ctx=ctx),
                        bp, x, use_reentrant=False, preserve_rng_state=False)
                else:
                    cache = None if caches is None else \
                        (caches[name][0][i], caches[name][1][i])
                    x, aux = self._apply_sublayer(sl, bp, x, mode=mode,
                                                  cache=cache, pos=pos,
                                                  ctx=ctx)
                if aux is not None:
                    aux_sum = aux if aux_sum is None else aux_sum + aux
        return x, aux_sum

    def _train_layer(self, sl, bp, x, ctx=None):
        return self._apply_sublayer(sl, bp, x, mode="train", ctx=ctx)

    def _apply_first(self, params, x, *, mode, cache=None, pos=None):
        """DeepSeek-V2's layer 0 (MLA + dense FFN, `params["first"]`),
        outside the stack and, in training, outside remat, as the
        reference's `_apply_first`; the identity without MLA. `cache`:
        its (c, k_rope) of [B, slots, ...]."""
        if self.cfg.mla is None:
            return x
        return self._apply_sublayer(FIRST, params["first"], x, mode=mode,
                                    cache=cache, pos=pos)[0]

    # ------------------------------------------------------ the enc-dec

    def _encode(self, params, frames):
        """The encoder (the reference's `_encode`): frames plus sinusoidal
        positions in the compute dtype, then per layer a non-causal
        self-attention without RoPE and the MLP, each pre-normed and
        added to the residual; the final norm. Not under remat, as the
        reference's encoder scan."""
        cfg = self.cfg
        cd = self.compute_dtype
        x = frames.to(cd) + L.sinusoidal_positions(
            frames.shape[1], cfg.d_model, frames.device).to(cd)
        stack = params["enc_blocks"]
        for i in range(cfg.n_encoder_layers):
            bp = _layer(stack, i)
            h = L.rmsnorm(bp["pre_norm"], x, cfg.rms_eps)
            x = x + L.gqa_attention(bp["attn"], h, causal=False,
                                    **self._encdec_attn())
            h = L.rmsnorm(bp["ffn_norm"], x, cfg.rms_eps)
            x = x + L.mlp(bp["ffn"], h, cfg.mlp_variant, cd)
        return L.rmsnorm(params["enc_final_norm"], x, cfg.rms_eps)

    def _encdec_attn(self) -> dict:
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, rope_theta=0.0,
                    compute_dtype=self.compute_dtype, use_rope=False,
                    attention=self.attention)

    def _dec_inputs(self, params, tokens):
        """The decoder's input: token embeddings plus sinusoidal positions
        0 .. S - 1, in the compute dtype."""
        x = self._embed(params, tokens)
        return x + L.sinusoidal_positions(
            tokens.shape[1], self.cfg.d_model, x.device).to(x.dtype)

    def _dec_layer(self, bp, x, enc, *, mode, cache=None, pos=None):
        """One decoder layer (the reference's `_run_encdec_stack` body):
        causal self-attention, cross-attention over the encoder output
        `enc`, the MLP, each pre-normed and added to the residual; no
        RoPE. `cache` (prefill and decode): ((k, v) of the self cache,
        (k, v) of the cross cache), this layer's views, written in place:
        prefill writes the prompt's keys and values and the cross cache
        once; decode writes its slots of the self cache and reads the
        cross cache whole."""
        cfg = self.cfg
        kw = self._encdec_attn()
        h = L.rmsnorm(bp["pre_norm"], x, cfg.rms_eps)
        if mode == "decode":
            (k_cache, v_cache), cross = cache
            k_new, v_new = self._project_kv(bp["attn"], h, rope=False)
            s = h.shape[1]
            k_cache[:, pos:pos + s] = k_new.to(k_cache.dtype)
            v_cache[:, pos:pos + s] = v_new.to(v_cache.dtype)
            a = self._attn_with_cache(bp["attn"], h, k_cache, v_cache, pos,
                                      q_offset=pos, rope=False)
        else:
            a = L.gqa_attention(bp["attn"], h, causal=True, **kw)
            if mode == "prefill":
                k, v = self._project_kv(bp["attn"], h, rope=False)
                cache[0][0][:, :k.shape[1]] = k
                cache[0][1][:, :v.shape[1]] = v
        x = x + a
        h = L.rmsnorm(bp["cross_norm"], x, cfg.rms_eps)
        if mode == "decode":
            a = self._attn_with_cache(bp["cross"], h, *cross, pos,
                                      q_offset=0, causal=False, rope=False)
        else:
            a = L.gqa_attention(bp["cross"], h, causal=False, kv_x=enc, **kw)
            if mode == "prefill":
                k, v = self._project_kv(bp["cross"], enc, rope=False)
                cache[1][0].copy_(k)
                cache[1][1].copy_(v)
        x = x + a
        h = L.rmsnorm(bp["ffn_norm"], x, cfg.rms_eps)
        return x + L.mlp(bp["ffn"], h, cfg.mlp_variant, self.compute_dtype)

    def _run_encdec_stack(self, params, x, enc, *, mode, caches=None,
                          pos=None):
        """The decoder, layer by layer over the views of `dec_blocks`
        (or the train step's per-layer list); in training each layer
        runs under `checkpoint` unless `cfg.remat` is "none", as the
        reference checkpoints its decoder body (not its encoder).
        `caches`: {"self": (k, v), "cross": (k, v)} of [n_layers, ...]
        tensors."""
        stack = params["dec_blocks"]
        remat = mode == "train" and self.cfg.remat != "none"
        for i in range(self.cfg.n_layers):
            bp = _layer(stack, i)
            if remat:
                x = checkpoint(functools.partial(self._dec_layer,
                                                 mode="train"), bp, x, enc,
                               use_reentrant=False, preserve_rng_state=False)
                continue
            cache = None if caches is None else tuple(
                (caches[c][0][i], caches[c][1][i]) for c in ("self", "cross"))
            x = self._dec_layer(bp, x, enc, mode=mode, cache=cache, pos=pos)
        return x

    # -------------------------------------------------------- embeddings

    def _embed(self, params, tokens):
        """Token embeddings in the compute dtype. (The reference's
        `activation_constraint` is the identity on one device, and the
        port runs on one.)"""
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

    def _context(self, params, batch) -> dict:
        """The batch's static context on the parameters' device: the
        enc-dec family's {"frames"}, the VLM's {"patches"}, {} for the
        others. Raises `ValueError` when the batch lacks it (the train
        CLI and Branch-Train-Merge feed tokens alone, in the port as in
        the reference, whose `Model.loss` raises `KeyError` there)."""
        key = {"encdec": "frames", "vlm": "patches"}.get(self.cfg.family)
        if key is None:
            return {}
        if key not in batch:
            raise ValueError(
                f"{self.cfg.name} ({self.cfg.family}) needs the batch's "
                f"{key!r} beside its tokens; the train CLI and "
                "Branch-Train-Merge feed tokens alone, as the reference's "
                "do (their Model.loss raises KeyError)")
        return {key: torch.as_tensor(batch[key],
                                     device=params["embed"].device)}

    # ----------------------------------------------------------- serving

    @torch.inference_mode()
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Full-sequence forward building a decode cache.

        `max_len` pre-sizes the KV caches for decode; a cache is never
        shorter than the prompt, so without it (or below the prompt
        length) the cache holds the prompt alone and a decode step on it
        raises. The enc-dec family's batch carries "frames" and the VLM's
        "patches" (`_context`): their cross-attention caches are written
        here once. Returns (last-token logits [B, V] fp32, caches).
        """
        tokens = self._tokens(params, batch["tokens"])
        b, s = tokens.shape
        ctx = self._context(params, batch)
        static = next(iter(ctx.values()), None)
        caches = self.init_cache(
            b, max(max_len or s, s), device=params["embed"].device,
            context_len=None if static is None else static.shape[1])
        if self.encdec:
            enc = self._encode(params, ctx["frames"])
            x = self._run_encdec_stack(params, self._dec_inputs(params,
                                                                tokens),
                                       enc, mode="prefill", caches=caches)
        else:
            x = self._embed(params, tokens)
            x = self._apply_first(params, x, mode="prefill",
                                  cache=caches.get("first"))
            x, _ = self._run_stack(params, x, mode="prefill",
                                   caches=caches["blocks"], ctx=ctx)
        logits = self._logits(params, x[:, -1:])
        return logits[:, 0], caches

    @torch.inference_mode()
    def decode_step(self, params, caches, token, pos: int):
        """One decode step. token: [B, 1]; pos: its position.

        Returns (logits [B, V] fp32, caches), the caches written in place.
        Raises `ValueError` when the step's positions pos .. pos + s - 1
        run past the global caches or the MLA latent caches (the
        reference clamps the slot to the last one), or when a step of s >
        1 tokens meets a ring cache, an SSM cache or an MLA cache.
        """
        tokens = self._tokens(params, token)
        s = tokens.shape[1]
        if self.encdec:
            slots = caches["self"][0].shape[2]
            if int(pos) < 0 or int(pos) + s > slots:
                raise ValueError(
                    f"decode at position {int(pos)} of {s} token(s) does "
                    f"not fit a {slots}-slot KV cache; pre-size it with "
                    "prefill(..., max_len=...)")
            # the reference adds position pos's vector to every token of
            # the step (`_sinusoidal_at(pos)`)
            x = self._embed(params, tokens)
            x = x + L.sinusoidal_at(int(pos), self.cfg.d_model,
                                    x.device).to(x.dtype)
            x = self._run_encdec_stack(params, x, None, mode="decode",
                                       caches=caches, pos=int(pos))
            return self._logits(params, x)[:, 0], caches
        attn = [(sl, caches["blocks"][f"sub{j}"][0].shape[2])
                for j, sl in enumerate(self.layout)
                if sl.mixer in ("attn", "mla")]
        rings = [_is_ring(sl, n) for sl, n in attn]
        held = [n for (_, n), ring in zip(attn, rings) if not ring]
        if "first" in caches:
            held.append(caches["first"][0].shape[1])
        if int(pos) < 0 or (held and int(pos) + s > min(held)):
            raise ValueError(
                f"decode at position {int(pos)} of {s} token(s) does not "
                f"fit a {min(held) if held else 0}-slot KV cache; pre-size "
                "it with prefill(..., max_len=...)")
        if s > 1 and any(rings):
            raise ValueError(
                f"a decode step of {s} tokens on a sliding-window ring "
                "cache; step one token at a time")
        if s > 1 and any(sl.mixer == "mamba" for sl in self.layout):
            raise ValueError(
                f"a decode step of {s} tokens on an SSM cache (its "
                "recurrent update takes one token); step one token at a "
                "time")
        if s > 1 and self.cfg.mla is not None:
            raise ValueError(
                f"a decode step of {s} tokens on an MLA latent cache (the "
                "absorbed decode takes one position, as the reference's); "
                "step one token at a time")
        x = self._embed(params, tokens)
        x = self._apply_first(params, x, mode="decode",
                              cache=caches.get("first"), pos=int(pos))
        x, _ = self._run_stack(params, x, mode="decode",
                               caches=caches["blocks"], pos=int(pos))
        return self._logits(params, x)[:, 0], caches

    # ------------------------------------------------------------- cache

    def init_cache(self, batch_size: int, max_len: int, *,
                   device: Any = "cuda", context_len: Optional[int] = None):
        """Zeroed cache pytree for decode: max_len slots per global
        sub-layer, min(window, max_len) per local one, per MLA sub-layer
        its latent and rope-key caches of max_len slots (and
        DeepSeek-V2's layer 0's under "first"), per Mamba
        sub-layer its SSM state (fp32) and conv cache, and per
        cross-attention sub-layer `context_len` slots (the VLM's
        num_patches unless given). The enc-dec family's is {"self": (k,
        v), "cross": (k, v)} of [n_layers, B, slots, HK, D]: max_len
        slots, and `context_len` (encoder_seq unless given) for the
        cross-attention over the encoder output."""
        cfg = self.cfg
        kw = dict(dtype=self.compute_dtype, device=device)
        hkd = (cfg.n_kv_heads, cfg.resolved_head_dim)
        if self.encdec:
            kv = (cfg.n_layers, batch_size, max_len) + hkd
            ckv = (cfg.n_layers, batch_size,
                   context_len or cfg.encoder_seq) + hkd
            return {"self": (torch.zeros(kv, **kw), torch.zeros(kv, **kw)),
                    "cross": (torch.zeros(ckv, **kw),
                              torch.zeros(ckv, **kw))}
        blocks = {}
        for j, sl in enumerate(self.layout):
            if sl.mixer == "mamba":
                m = cfg.mamba
                _, n_heads, conv_dim = M.mamba_dims(cfg)
                blocks[f"sub{j}"] = (
                    torch.zeros((self.n_periods, batch_size, n_heads,
                                 m.head_dim, m.d_state),
                                dtype=torch.float32, device=device),
                    torch.zeros((self.n_periods, batch_size, m.d_conv - 1,
                                 conv_dim), **kw))
                continue
            if sl.mixer == "mla":
                blocks[f"sub{j}"] = self._mla_cache(
                    (self.n_periods, batch_size, max_len), **kw)
                continue
            if sl.mixer == "cross":
                slots = context_len or cfg.num_patches
            else:
                slots = min(sl.window, max_len) if sl.window else max_len
            shape = (self.n_periods, batch_size, slots) + hkd
            blocks[f"sub{j}"] = (torch.zeros(shape, **kw),
                                 torch.zeros(shape, **kw))
        if cfg.mla is None:
            return {"blocks": blocks}
        return {"blocks": blocks,
                "first": self._mla_cache((batch_size, max_len), **kw)}

    def _mla_cache(self, lead: tuple, **kw) -> tuple:
        """(c, k_rope) zeros of lead + [kv_lora_rank] and + [d_rope]."""
        m = self.cfg.mla
        return (torch.zeros(lead + (m.kv_lora_rank,), **kw),
                torch.zeros(lead + (m.d_head_rope,), **kw))


# DeepSeek-V2's layer 0 (`first`): MLA with a dense FFN of d_ff
FIRST = SubLayer("mla", "dense")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m if x else x


def _layer(stack, i: int):
    """Layer i of a stacked subtree (views of its leaves), or of the
    train step's per-layer list."""
    if isinstance(stack, list):
        return stack[i]
    return pytree.tree_map(lambda t: t[i], stack)


def _gate(g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """tanh(g) y: the gate's tanh in fp32, cast to y's dtype."""
    return torch.tanh(g.to(torch.float32)).to(y.dtype) * y


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
