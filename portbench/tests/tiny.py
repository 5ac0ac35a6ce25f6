"""Tiny cells for the CPU tests: the benchmark's own configurations cut
to a few widths, registered with the program under names of their own,
so the drivers run end to end on the CPU with the kernels' plain
versions."""
from __future__ import annotations

import copy
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import registry  # noqa: E402

DENSE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
             d_ff=128, vocab_size=503)
SSM = dict(n_layers=2, d_model=64, vocab_size=503)
SSM_MAMBA = dict(d_state=16, head_dim=16, chunk_size=16)


def _register(config: dict, name: str, **kw) -> None:
    from repro_torch.configs.base import get_config, register
    base = get_config(config["port_config"])
    mamba = kw.pop("mamba", None)
    cfg = base.replace(name=name, **kw)
    if mamba:
        cfg = cfg.replace(mamba=dataclasses.replace(base.mamba, **mamba))
    register(cfg)


def config(name: str) -> dict:
    """The named configuration's file, cut to tiny widths."""
    bench = registry.load_benchmark()
    conf = {c["name"]: c for c in bench["configs"]}[name]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    tiny = "portbench-tiny-" + cfg["family"]
    if cfg["family"] == "dense":
        cfg.update(DENSE)
        _register(cfg, tiny, **DENSE)
    else:
        cfg.update(SSM)
        cfg.update(d_state=16, ssm_head_dim=16, chunk_size=16)
        _register(cfg, tiny, **SSM, mamba=SSM_MAMBA)
    cfg["port_config"] = tiny
    return cfg


# limits at tiny widths: a leaf of a few thousand elements, and the few
# rows of a tiny model's products, round differently from the full
# widths whose chip runs set the cells' own limits
LIMITS = {"merge_sweep": {"diff_share": 0.05, "root_mismatch": 0.0},
          "finetune": {"loss_gap": 8e-5, "grad_norm_gap": 0.05,
                       "grad_gap": 0.05, "update_gap": 0.05,
                       "update_elem_gap": 0.12}}


def cell(workload: str, **traffic) -> registry.Cell:
    """The workload's cell on tiny widths, held to the tiny limits;
    `traffic` overrides keys of its mix (a short sequence for the
    fine-tunes)."""
    c = copy.deepcopy(registry.cell(workload))
    c.config = config(c.workload["config"])
    c.traffic.update(traffic)
    c.limits = dict(LIMITS[c.traffic["kind"]])
    return c
