"""Parameter layout of the dense model family (`repro.models.model`,
`Model.schema()` for `family == "dense"`).

Layers are stacked along a leading axis, as the reference's `_stack`
does: one `blocks/sub0` subtree whose leaves carry [n_layers, ...].
The forward pass and the other families (MoE, MLA, SSM, hybrid,
enc-dec, VLM) wait for ROADMAP A7.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import PDef


def rmsnorm_def(d: int) -> PDef:
    return PDef((d,), (None,), init="ones")


def attn_def(d: int, n_heads: int, n_kv: int, head_dim: int,
             scale: float) -> dict:
    return {
        "wq": PDef((d, n_heads * head_dim), ("fsdp", "tp"), scale=scale),
        "wk": PDef((d, n_kv * head_dim), ("fsdp", "tp"), scale=scale),
        "wv": PDef((d, n_kv * head_dim), ("fsdp", "tp"), scale=scale),
        "wo": PDef((n_heads * head_dim, d), ("tp", "fsdp"), scale=scale),
    }


def mlp_def(d: int, f: int, variant: str, scale: float) -> dict:
    if variant in ("swiglu", "geglu"):
        return {
            "w_gate": PDef((d, f), ("fsdp", "tp"), scale=scale),
            "w_up": PDef((d, f), ("fsdp", "tp"), scale=scale),
            "w_down": PDef((f, d), ("tp", "fsdp"), scale=scale),
        }
    return {
        "w_up": PDef((d, f), ("fsdp", "tp"), scale=scale),
        "w_down": PDef((f, d), ("tp", "fsdp"), scale=scale),
    }


def _stack(schema: Any, n: int) -> Any:
    if isinstance(schema, PDef):
        return PDef((n,) + schema.shape, (None,) + schema.spec, schema.init,
                    schema.scale, schema.dtype)
    return {k: _stack(v, n) for k, v in schema.items()}


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense" or cfg.local_global_pattern \
                or cfg.sandwich_norms:
            raise NotImplementedError(
                f"{cfg.name}: only the plain dense layout is ported; the "
                "other families wait for ROADMAP A7")
        self.cfg = cfg

    def schema(self) -> dict:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        sub: Dict[str, Any] = {
            "pre_norm": rmsnorm_def(d),
            "attn": attn_def(d, cfg.n_heads, cfg.n_kv_heads, hd, 0.02),
            "ffn_norm": rmsnorm_def(d),
            "ffn": mlp_def(d, cfg.d_ff, cfg.mlp_variant, 0.02),
        }
        sc: Dict[str, Any] = {
            "embed": PDef((cfg.vocab_size, d), ("tp", None), scale=0.02),
            "final_norm": rmsnorm_def(d),
            "blocks": _stack({"sub0": sub}, cfg.n_layers),
        }
        if not cfg.tie_embeddings:
            sc["lm_head"] = PDef((d, cfg.vocab_size), (None, "tp"),
                                 scale=0.02)
        return sc
