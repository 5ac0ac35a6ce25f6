"""Kernel knobs (`repro.kernels.config.KernelEnv`, in the port).

`kernel_env` is the process-wide source of truth for the flat-batch
tile width, the histogram trim resolution, and the DARE route switch
of the merge engine's kernel dispatch.
"""
from __future__ import annotations


class KernelEnv:
    """Process-wide kernel configuration, plain mutable attributes.

    `block` is the column tile width of the flat batch; `hist_bins` the
    histogram trim-quantile resolution, matching `strategies.catalog`.
    `dare_kernel_rng` routes DARE through the `dare_block` kernel's
    counter-hash RNG; off by default, because that sampler is not the
    catalog's `jax.random` threefry, so replicas agree only if every
    one of them opts in.
    """

    def __init__(self, block: int = 2048, hist_bins: int = 512,
                 dare_kernel_rng: bool = False):
        self.block = block
        self.hist_bins = hist_bins
        self.dare_kernel_rng = dare_kernel_rng


kernel_env = KernelEnv()
