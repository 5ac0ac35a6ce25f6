"""Kernel knobs (`repro.kernels.config.KernelEnv`, in the port).

`kernel_env` is the process-wide source of truth for the flat-batch
tile width and the histogram trim resolution.
"""
from __future__ import annotations


class KernelEnv:
    """Process-wide kernel configuration.

    `block` is the column tile width of the flat batch; `hist_bins` the
    histogram trim-quantile resolution, matching `strategies.catalog`.
    """

    def __init__(self, block: int = 2048, hist_bins: int = 512):
        self.block = block
        self.hist_bins = hist_bins


kernel_env = KernelEnv()
