"""Kernel knobs (`repro.kernels.config.KernelEnv`, in the port).

`kernel_env` is the process-wide source of truth for the flat-batch
tile width, the histogram trim resolution, and the DARE route switch
of the merge engine's kernel dispatch. As the reference's, it is seeded
from the environment when this module is imported and again on
`reset()`, with the reference's parsing and its `ValueError`s:

==========================  ============================================
variable                    effect
==========================  ============================================
REPRO_KERNEL_BLOCK          the flat batch's tile width (default 2048;
                            must be > 0). On CUDA, B3-B5 read 8 columns
                            at a time: a width that is not a multiple of
                            8 raises there, naming this variable.
REPRO_KERNEL_HIST_BINS      histogram trim-quantile resolution (default
                            512, matching `strategies.catalog`; > 1).
REPRO_KERNEL_DARE_RNG       "1"/"true"/"yes"/"on" routes DARE through
                            `dare_block`'s counter-hash RNG ("0"/"false"/
                            "no"/"off", or unset: the catalog's exact
                            path); anything else raises.
==========================  ============================================

The reference's two other variables have no counterpart here.
REPRO_KERNEL_INTERPRET picks Pallas's interpret mode: the port picks a
kernel or its plain version by the device its tensors lie on.
REPRO_KERNEL_QUANTIZED switches off the int8 merge on arrival: the port
always merges int8 payloads on arrival (`kernel_env.quantized` is gone,
a departure on record, ROADMAP C).
"""
from __future__ import annotations

import os
from typing import Optional

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _env_flag(name: str) -> Optional[bool]:
    raw = os.environ.get(name)
    if raw is None:
        return None
    v = raw.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"{name}={raw!r}: expected one of {_TRUE + _FALSE}")


class KernelEnv:
    """Process-wide kernel configuration, plain mutable attributes.

    `block` is the column tile width of the flat batch; `hist_bins` the
    histogram trim-quantile resolution, matching `strategies.catalog`.
    `dare_kernel_rng` routes DARE through the `dare_block` kernel's
    counter-hash RNG; off by default, because that sampler is not the
    catalog's `jax.random` threefry, so replicas agree only if every
    one of them opts in. Each is read from the environment (module
    docstring) unless given here; `reset()` reads them all again.
    """

    def __init__(self, block: Optional[int] = None,
                 hist_bins: Optional[int] = None,
                 dare_kernel_rng: Optional[bool] = None):
        self.reset()
        if block is not None:
            self.block = block
        if hist_bins is not None:
            self.hist_bins = hist_bins
        if dare_kernel_rng is not None:
            self.dare_kernel_rng = dare_kernel_rng

    def reset(self) -> None:
        self.block: int = int(os.environ.get("REPRO_KERNEL_BLOCK", "2048"))
        self.hist_bins: int = int(
            os.environ.get("REPRO_KERNEL_HIST_BINS", "512"))
        dare = _env_flag("REPRO_KERNEL_DARE_RNG")
        self.dare_kernel_rng: bool = False if dare is None else dare
        if self.block <= 0:
            raise ValueError(f"REPRO_KERNEL_BLOCK must be > 0, "
                             f"got {self.block}")
        if self.hist_bins <= 1:
            raise ValueError(f"REPRO_KERNEL_HIST_BINS must be > 1, "
                             f"got {self.hist_bins}")


def block_name(block: int) -> str:
    """How an error names a tile width: as the environment variable
    when `block` is the width it set, else as the argument."""
    if os.environ.get("REPRO_KERNEL_BLOCK") is not None \
            and block == kernel_env.block:
        return f"REPRO_KERNEL_BLOCK={block}"
    return f"block={block}"


kernel_env = KernelEnv()
