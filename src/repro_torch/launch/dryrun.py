"""Dry-run views of a workload cell (`repro.launch.dryrun`, its pure
part): a cell's inputs as meta tensors (`input_specs`, nothing
allocated), the reference's performance variants of a config
(`VARIANTS`, `apply_variant`), and the analytic "useful" flops of a cell
(`_model_flops`: 6 x active non-embedding parameters x tokens to train,
2 x to serve a prefill or a decode step, one token a sequence). The
reference's lowering of each cell onto 256 or 512 devices, its compiled
memory and cost analyses and its HLO collective counts are out of scope
on one card (ROADMAP, "Out of scope").
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import get_config, SHAPES, smoke_config
from repro_torch.data.synthetic import batch_shapes
from repro_torch.dtypes import BY_NAME


def input_specs(arch: str, shape_name: str, *, smoke: bool = False,
                shape_override=None):
    """(cfg, shape, batch): the config, the cell's `ShapeSpec` and every
    model input of the cell as a meta tensor of its shape and dtype."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    shape = shape_override or SHAPES[shape_name]
    batch = {k: torch.empty(s, dtype=BY_NAME[dt], device="meta")
             for k, (s, dt) in batch_shapes(cfg, shape).items()}
    return cfg, shape, batch


VARIANTS = {
    "castbf16": lambda c: c.replace(cast_params_for_loss=True),
    "headpad16": lambda c: c.replace(pad_heads_to_tp=16),
    "accum2": lambda c: c.replace(grad_accum=2),
    "accum4": lambda c: c.replace(grad_accum=4),
    "accum16": lambda c: c.replace(grad_accum=16),
    "optbf16": lambda c: c.replace(opt_state_dtype="bfloat16"),
    "parambf16": lambda c: c.replace(param_dtype="bfloat16"),
    "qchunk1k": lambda c: c.replace(attn_q_chunk=1024),
    "noremat": lambda c: c.replace(remat="none"),
    "bf16psum": lambda c: c.replace(bf16_psum=True),
    "optint8": lambda c: c.replace(opt_state_dtype="int8"),
}


def apply_variant(cfg, variant: str):
    """'castbf16+accum4' -> composed config transform."""
    for tok in (variant or "base").split("+"):
        if tok in ("", "base"):
            continue
        cfg = VARIANTS[tok](cfg)
    return cfg


def _model_flops(cfg, shape) -> Dict:
    """Analytic 'useful' FLOPs for the roofline ratio."""
    from repro_torch.models.params import count_params, non_embedding_params
    total, active = count_params(cfg)
    ne_total, ne_active = non_embedding_params(cfg)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * s
        mf = 6.0 * ne_active * tokens
    elif shape.kind == "prefill":
        tokens = b * s
        mf = 2.0 * ne_active * tokens
    else:
        tokens = b            # one token per sequence
        mf = 2.0 * ne_active * tokens
    return {"params_total": total, "params_active": active,
            "model_flops": mf, "tokens": tokens}
