"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

(or `python3 -m portbench.run ...`) from the root of a checkout, on a
machine with the GPUs the cell asks for. The cell's traffic mix names
its driver (`portbench/drivers/<kind>.py`); the driver sets the cell
up, measures for `--seconds`, then checks what the timed path produced
against the plain reference (`portbench/reference/`). The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device` (and with `--trace 1` a `breakdown`), and
last `checks`, each number compared beside its limit; the same numbers
close standard error. Exits non-zero with no result when the GPUs are
missing, when the program or JAX cannot be kept apart, or on error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, this directory heads sys.path: take it off, so that no
# module here stands in for a library's of the same name
HERE = str(Path(__file__).resolve().parent)
sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(HERE)]
# the program's build and kernel caches: fixed directories inside the
# checkout, so only a checkout's first run builds (the port's own CUDA
# libraries land in build/torch_kernels/, which it fixes itself)
_CACHE = ROOT / "build" / "portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(_CACHE / "inductor")
# the allocator setting the program's own chip driver runs under: 61 GB
# of Phi-3 training state leave little room for fragments
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def metrics_of(cell, out: dict, trace: bool) -> dict:
    """The result's metrics: end-to-end ones from the driver, or the
    per-layer readers' over the traced stretch (a reader that finds
    nothing to read is left out)."""
    from portbench import registry
    res = {}
    if not trace:
        for m in cell.end_to_end:
            v = out["setup_s"] if m["name"] == "setup_s" \
                else out["e2e"].get(m["name"])
            if v is not None:
                res[m["name"]] = {"value": v, "unit": m["unit"]}
        return res
    for m in cell.per_layer:
        v = registry.reader(m["name"]).read(out["view"])
        if v is not None:
            res[m["name"]] = {"value": v, "unit": m["unit"]}
    return res


def judge(checks: dict) -> bool:
    return all(math.isfinite(v) and v <= lim
               for v, lim in checks.values())


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Set up, measure and check one cell; the result object."""
    import torch
    from portbench import registry
    out = registry.driver(cell.traffic["kind"]).run(
        cell, seed=seed, seconds=seconds, trace=trace, device=device,
        t_start=t_start)
    checks = out["checks"]
    result = {
        "correct": out["failed"] == 0 and judge(checks),
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": metrics_of(cell, out, trace),
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": out["memory_peak_bytes"]},
    }
    if trace:
        tr = out["view"].trace
        result["device"]["busy_s"] = tr.busy_s() if tr else 0.0
        result["device"]["window_s"] = tr.window_s if tr else 0.0
        if tr is not None:
            result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from portbench import registry
    cell = registry.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 3
    result = run_cell(cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: the benchmark measures "
              "the port alone", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
