"""What the drivers share: the view the per-layer readers get, the
check that the program runs the configuration as its file states it,
sums of squares that fit, and the device's memory reading."""
from __future__ import annotations

import gc
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from portbench.devtrace import Trace
from portbench.reference.layout import Leaf


@dataclass
class View:
    """What a per-layer reader reads: the traced stretch (None when the
    run was not traced) and the facts the driver recorded."""
    cell: Any
    trace: Optional[Trace]
    facts: Dict[str, Any] = field(default_factory=dict)


def port_config(config: Dict):
    """The program's registered configuration, after checking each field
    the file maps (`program_fields`: key in the file -> dotted attribute
    of the program's config) against the file's value."""
    from repro_torch.configs import get_config
    cfg = get_config(config["port_config"])
    bad = []
    for key, attr in config["program_fields"].items():
        v = cfg
        for part in attr.split("."):
            v = getattr(v, part)
        if v != config[key]:
            bad.append(f"{key}: file {config[key]!r}, program {v!r}")
    if bad:
        raise ValueError(f"the program's {config['port_config']} departs "
                         "from the configuration file: " + "; ".join(bad))
    return cfg


def check_layout(model, layout: List[Leaf]) -> None:
    """The program's parameter tree has the layout's paths and shapes."""
    from repro_torch import pytree
    flat, _ = pytree.flatten_with_path(model.param_shapes())
    have = {pytree.keystr(p): tuple(t.shape) for p, t in flat}
    want = {leaf.key: leaf.shape for leaf in layout}
    if have != want:
        raise ValueError(f"the program's tree {have} is not the "
                         f"configuration's layout {want}")


def sq_norm(t: torch.Tensor) -> float:
    """Sum of squares of a tensor in float64, a slice at a time."""
    flat = t.detach().reshape(-1)
    total = 0.0
    for s in range(0, flat.numel(), 1 << 24):
        part = flat[s:s + (1 << 24)].to(torch.float32)
        total += float(torch.sum(part * part, dtype=torch.float64))
    return total


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class Stamps:
    """Set-up's phases, in seconds since the run's start, printed on
    standard error when set-up ends."""

    def __init__(self, t_start: float):
        self.t_start = t_start
        self.marks: List = []

    def __call__(self, phase: str) -> None:
        import time
        self.marks.append((phase, time.perf_counter() - self.t_start))

    def report(self) -> None:
        import sys
        print("set-up: " + ", ".join(f"{p} {t:.2f} s" for p, t in self.marks),
              file=sys.stderr)


def reset_peak(device) -> None:
    """Start the device's peak reading afresh (at the window's start)."""
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    """The device's peak of allocated bytes (0 off a GPU)."""
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
