"""Analytic parameter counting (total vs active) from the schema
(`repro.models.params`)."""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import _flatten_schema


def _counts(cfg: ModelConfig, skip_embed: bool) -> Tuple[int, int]:
    from repro_torch.models.model import Model   # lazy; avoids a cycle
    total = 0
    active = 0.0
    frac = (cfg.moe.top_k / cfg.moe.num_experts) if cfg.moe else 1.0
    for path, pdef in _flatten_schema(Model(cfg).schema()):
        p = "/".join(str(k) for _, k in path)
        if skip_embed and p == "embed":
            continue
        n = 1
        for d in pdef.shape:
            n *= d
        total += n
        active += n * (frac if "experts" in p else 1.0)
    return total, int(active)


def count_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active). Active scales routed-expert tensors by top_k/E."""
    return _counts(cfg, skip_embed=False)


def non_embedding_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) excluding the token embedding table (lm_head kept)."""
    return _counts(cfg, skip_embed=True)
