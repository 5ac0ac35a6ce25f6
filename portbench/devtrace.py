"""The traced stretch of a run: host spans of the benchmark's own, the
program's spans (its `repro_torch.obs` tracer), calls into named entry
points of the program (their argument shapes), and the device's
activity from `torch.profiler` (CUDA only: recording the host's ops
would cost more than a training step). Reduced to what the per-layer
readers take: device operations with their times, the union of busy
time, and idle gaps named by the innermost host span that covers them.

Copied in spirit from `chip_smoke.py:trace_device` (busy time by kernel
group, idle share of the wall time). Host spans use `time.time_ns`, the
clock the profiler stamps its events with.
"""
from __future__ import annotations

import contextlib
import importlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class Span:
    name: str
    t0: int
    t1: int
    depth: int


@dataclass
class Op:
    name: str
    t0: int
    t1: int

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


class Spans:
    """The benchmark's host spans, nested by a stack."""

    def __init__(self):
        self.spans: List[Span] = []
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self.spans.append(Span(name, t0, time.time_ns(), self._depth))


@dataclass
class Trace:
    """What one traced stretch recorded."""
    t0: int
    t1: int
    ops: List[Op]
    spans: List[Span]
    calls: Dict[str, List[Dict]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def ops_in(self, name: str) -> List[Op]:
        """Device operations that start inside the host spans `name`."""
        outs = self.spans_named(name)
        return [op for op in self.ops
                if any(s.t0 <= op.t0 <= s.t1 for s in outs)]

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def busy_ns(self, ops: Optional[List[Op]] = None) -> int:
        """The union of the operations' intervals (all of them by
        default), clipped to the stretch."""
        ivs = sorted((max(o.t0, self.t0), min(o.t1, self.t1))
                     for o in (self.ops if ops is None else ops))
        busy, end = 0, self.t0
        for a, b in ivs:
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy

    def busy_s(self) -> float:
        return self.busy_ns() / 1e9

    def idle_pct(self) -> Optional[float]:
        """The share of the stretch with no operation on the device, in
        percent (None when nothing ran)."""
        if not self.ops or self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def gaps(self) -> List[Tuple[int, int]]:
        ivs = sorted((o.t0, o.t1) for o in self.ops)
        out, end = [], self.t0
        for a, b in ivs:
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            out.append((end, self.t1))
        return out

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds by the innermost host span covering each gap's
        middle ("outside any span" when none does)."""
        out: Dict[str, float] = {}
        for a, b in self.gaps():
            mid = (a + b) // 2
            inside = [s for s in self.spans if s.t0 <= mid <= s.t1]
            name = max(inside, key=lambda s: (s.depth, s.t0)).name \
                if inside else "outside any span"
            out[name] = out.get(name, 0.0) + (b - a) / 1e9
        return out

    def seconds_by_op(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self.ops:
            out[o.name] = out.get(o.name, 0.0) + o.ns / 1e9
        return out

    def breakdown(self) -> Dict[str, List]:
        def top(d):
            return [[k[:120], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.seconds_by_op()),
                "idle_gaps": top(self.idle_by_span())}


def _device_ops(prof) -> List[Op]:
    from torch.autograd import DeviceType
    ops = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CPU:
            ops.append(Op(ev.name(), ev.start_ns(), ev.end_ns()))
    return ops


class Probe:
    """Record each call of `module.attr` (its positional arguments run
    through `describe`) while installed; the program's function runs
    unchanged."""

    def __init__(self, module: str, attr: str,
                 describe: Callable[..., Dict]):
        self.module, self.attr, self.describe = module, attr, describe
        self.calls: List[Dict] = []

    @contextlib.contextmanager
    def installed(self):
        mod = importlib.import_module(self.module)
        orig = getattr(mod, self.attr)

        def wrapper(*args, **kwargs):
            self.calls.append(self.describe(*args, **kwargs))
            return orig(*args, **kwargs)

        setattr(mod, self.attr, wrapper)
        try:
            yield
        finally:
            setattr(mod, self.attr, orig)


@contextlib.contextmanager
def stretch(spans: Spans, probes: Dict[str, Probe], out: List[Trace],
            device="cuda"):
    """Profile the device over the `with` body; appends one Trace to
    `out`, holding the program's spans (installed on its tracer), the
    benchmark's spans and each probe's calls made inside it."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from repro_torch.obs import set_tracer, Tracer
    tracer = Tracer(clock=time.time_ns)
    prev = set_tracer(tracer)
    first = len(spans.spans)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    try:
        with contextlib.ExitStack() as stack:
            for p in probes.values():
                stack.enter_context(p.installed())
            with profile(activities=[ProfilerActivity.CUDA if cuda
                                     else ProfilerActivity.CPU]) as prof:
                t0 = time.time_ns()
                yield
                sync()
                t1 = time.time_ns()
    finally:
        set_tracer(prev)
    ops = _device_ops(prof)
    if ops and not any(o.t1 > t0 and o.t0 < t1 for o in ops):
        # the profiler's clock is not the host's: line its first
        # operation up with the stretch's start
        shift = t0 - min(o.t0 for o in ops)
        ops = [Op(o.name, o.t0 + shift, o.t1 + shift) for o in ops]
    ops = [o for o in ops if o.t1 > t0 and o.t0 < t1]
    prog = [Span(s.name, s.t0, s.t1, 100) for s in tracer.spans
            if s.t1 is not None]
    out.append(Trace(t0, t1, ops, spans.spans[first:] + prog,
                     {k: list(p.calls) for k, p in probes.items()}))
