"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc`, holds each
against its plain PyTorch version at a batch shape the merge engine
dispatches, then drives the port's main path at Phi-3-mini's full width
and depth (3,821,079,552 bf16 parameters per model, k = 4
contributions): `Replica.contribute` -> Merkle root -> seed ->
`engine.merge(..., kernels=True)` for weight_average, task_arithmetic
and histogram-trim TIES. At depth 2 it holds the kernel route against
the exact route (`Replica.resolve`).

Prints one line per phase, then a JSON line with every kernel's numbers,
the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failed check raises (exit code 1).
Needs CUDA, the CUDA toolkit's `nvcc`, and the repository's `src/`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
K = 4                       # contributions per merge
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# linear family: kernel route (fp32 accumulate, one bf16 rounding) vs
# exact route (fp32 fold, one bf16 rounding): one bf16 ulp
LIN_ATOL, LIN_RTOL = 1e-5, 2.0 ** -7
# TIES: the exact path trims in bf16 arithmetic (thresholds, |tau|),
# the kernel route in fp32, so boundary elements may trim differently.
# Two H100 runs measured a share of 1.07e-4 at 2 layers; the limit is
# ten times that, so a fault in the glue between the three kernels (a
# threshold one bucket off, one leaf's tiles summed wrongly) fails.
TIES_MAX_DIFF_SHARE = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of `fn()` over `reps` CUDA-event-timed runs,
    after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; count {torch.cuda.device_count()}; "
        f"nvidia-smi: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    return {"name": name, "smi": smi}


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    dt = time.perf_counter() - t0
    for src, text in sorted(logs.items()):
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {src}.cu: {len(regs)} kernels; "
            + " | ".join(r.split("ptxas info    : ")[-1] for r in regs))
    log(f"[build] nvcc for {sorted(logs)} in parallel: {dt:.1f} s")


def main_path_lengths(cfg) -> list:
    """Leaf lengths of the largest fused batch the engine dispatches for
    this model at k = K, from the engine's own packing rule."""
    from repro_torch.core.engine import _dispatch_groups, LeafTask
    from repro_torch.models.model import Model
    from repro_torch.models.schema import schema_leaves
    from repro_torch.strategies import get_strategy
    tasks = []
    for i, (path, pdef) in enumerate(schema_leaves(Model(cfg).schema())):
        n = 1
        for d in pdef.shape:
            n *= d
        tasks.append(LeafTask(index=i, path=path, sub_root=b"",
                              shape=pdef.shape, dtype=torch.bfloat16,
                              stacked_nbytes=K * n * 2,
                              contributors=tuple(range(K))))
    groups = _dispatch_groups(get_strategy("weight_average"), tasks,
                              max(t.stacked_nbytes for t in tasks))
    big = max((g for g in groups if len(g) > 1),
              key=lambda g: sum(t.stacked_nbytes for t in g))
    return [t.stacked_nbytes // (K * 2) for t in big]


def phase_kernels(cfg) -> dict:
    """Each kernel against its plain version on one fused batch of the
    main path (bf16 rows, as the engine dispatches them)."""
    from repro_torch.kernels import histogram as H
    from repro_torch.kernels import nary_accum as N
    from repro_torch.kernels.config import kernel_env
    dev = torch.device(DEVICE)
    block, bins = kernel_env.block, kernel_env.hist_bins
    lengths = main_path_lengths(cfg)
    leaf_id, valid, npad = H.batch_layout(lengths, block)
    nb = len(leaf_id)
    g = torch.Generator(device=dev).manual_seed(SEED + 100)
    x = (torch.randn((K, npad), generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    base = torch.randn((npad,), generator=g, device=dev) * 0.02
    w = torch.full((K,), 1.0 / K, device=dev)
    log(f"[kernels] batch of {len(lengths)} leaves {lengths}: "
        f"stacked [{K}, {npad}] bf16, {nb} tiles of {block}")
    lid = torch.tensor(leaf_id, device=dev)
    vld = torch.tensor(valid, dtype=torch.int32, device=dev)
    bmax = H.block_amax_plain(x, base, block)
    amax_meta = (torch.stack([bmax[lid == j].amax(dim=0)
                              for j in range(len(lengths))])[lid]
                 + 1e-12).contiguous()
    thr_meta = (amax_meta * 0.3).contiguous()
    xe = K * npad * 2                       # stacked bytes (bf16)
    cases = {
        "nary_accum": (lambda: N.nary_accum(x, base, w),
                       lambda: N.nary_accum_plain(x, base, w),
                       xe + npad * 4 * 2 + K * 4, 3 * K * npad + npad,
                       "src/repro_torch/csrc/nary_accum.cu",
                       "src/repro/kernels/nary_accum.py:35"),
        "block_amax": (lambda: H.block_amax(x, base, block),
                       lambda: H.block_amax_plain(x, base, block),
                       xe + npad * 4 + nb * K * 4, 3 * K * npad,
                       "src/repro_torch/csrc/histogram.cu",
                       "src/repro/kernels/histogram.py:99"),
        "block_hist": (lambda: H.block_hist(x, base, amax_meta, vld, bins,
                                            block),
                       lambda: H.block_hist_plain(x, base, amax_meta, vld,
                                                  bins, block),
                       xe + npad * 4 + nb * K * 4 + nb * 4
                       + nb * K * bins * 4, 6 * K * npad,
                       "src/repro_torch/csrc/histogram.cu",
                       "src/repro/kernels/histogram.py:118"),
        "ties_block": (lambda: H.ties_block(x, base, thr_meta, block),
                       lambda: H.ties_block_plain(x, base, thr_meta, block),
                       xe + npad * 4 * 2 + nb * K * 4, 12 * K * npad,
                       "src/repro_torch/csrc/histogram.cu",
                       "src/repro/kernels/histogram.py:141"),
    }
    rows = {}
    for name, (kern, plain, nbytes, ops, src, replaces) in cases.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if got.dtype.is_floating_point:
            same = torch.equal(got, want)
            err = float((got - want).abs().max())
        else:
            same = torch.equal(got, want)
            err = float((got.to(torch.int64) - want.to(torch.int64))
                        .abs().max())
        if not same:
            raise AssertionError(f"{name}: kernel != plain version "
                                 f"(max abs err {err})")
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 3)
        bms, by = bound_ms(nbytes, ops)
        rows[name] = {"name": name, "route": "cuda", "source": src,
                      "replaces": replaces, "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "library_ms": None}
        log(f"[kernels] {name}: bitwise equal to plain; {ms:.3f} ms "
            f"(bound {bms:.3f} ms by {by}, {nbytes / 1e9:.2f} GB; "
            f"{nbytes / ms / 1e6:.0f} GB/s); plain {plain_ms:.2f} ms")
    # B3 keeps a NaN, as jnp.max does (fmaxf alone would drop it)
    xn = torch.zeros((K, 2 * block), dtype=torch.bfloat16, device=dev)
    xn[2, block + 7] = float("nan")
    got = H.block_amax(xn, torch.zeros(2 * block, device=dev), block)
    if not (bool(torch.isnan(got[1, 2])) and int(torch.isnan(got).sum()) == 1):
        raise AssertionError("block_amax dropped or spread a NaN")
    log("[kernels] block_amax propagates a NaN to its tile only")
    del x, base
    torch.cuda.empty_cache()
    return rows


def make_models(cfg, device):
    """A bf16 base and K contributions of the form base + small delta,
    from seeded generators on the device."""
    from repro_torch import pytree
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    schema = Model(cfg).schema()
    base = init_from_schema(schema, seed=SEED, device=device,
                            dtype=torch.bfloat16)
    contribs = []
    for j in range(K):
        delta = init_from_schema(schema, seed=SEED + 1 + j, device=device,
                                 dtype=torch.bfloat16)
        contribs.append(pytree.tree_map(
            lambda b, d: b + d * 0.1, base, delta))
        del delta
    return base, contribs


STRATEGIES = (("weight_average", {}, False),
              ("task_arithmetic", {"lam": 1.0}, True),
              ("ties", {"trim": 0.2, "trim_method": "histogram"}, True))


def phase_main_path(cfg) -> dict:
    from repro_torch import kernels, pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.core import engine
    from repro_torch.core.resolve import canonical_order, seed_from_root
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base, contribs = make_models(cfg, DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(base))
    log(f"[main] {cfg.name}: {len(pytree.leaves(base))} leaves, {n} "
        f"parameters per model, {K} contributions + base in bf16 "
        f"({(K + 1) * n * 2 / 1e9:.2f} GB) made in "
        f"{time.perf_counter() - t0:.1f} s")
    rep = Replica("chip-smoke", device=DEVICE)
    t0 = time.perf_counter()
    for c in contribs:
        rep.contribute(c)
    t_hash = time.perf_counter() - t0
    del contribs
    root = rep.merkle_root()
    seed = seed_from_root(root)
    ref = rep.register_base(base)
    order = canonical_order(rep.state)
    ordered = [rep.state.store[i] for i in order]
    log(f"[main] contribute x{K}: {t_hash:.1f} s "
        f"({K * n * 2 / t_hash / 1e9:.2f} GB/s hashed); merkle root "
        f"{root.hex()[:16]}…; seed {seed}")
    disp = rep.cache.obs.counter("kernel_dispatch_total")
    before = {k: disp.value(kernel=k) for k in ("nary_accum", "ties_hist")}
    kernels.reset_launch_counts()
    per = {}
    for name, cfgd, uses_base in STRATEGIES:
        spec = MergeSpec(name, cfgd, base_ref=ref if uses_base else None)
        torch.cuda.synchronize()
        c0 = kernels.launch_counts()
        t0 = time.perf_counter()
        out = engine.merge(ordered, spec=spec, contrib_ids=order,
                           base=base if uses_base else None, seed=seed,
                           kernels=True, use_cache=False, cache=rep.cache)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c1 = kernels.launch_counts()
        got = pytree.leaves(out)
        for o, b in zip(got, pytree.leaves(base)):
            if o.shape != b.shape or o.dtype != b.dtype:
                raise AssertionError(f"{name}: output leaf {o.shape} "
                                     f"{o.dtype} != {b.shape} {b.dtype}")
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"{name}: non-finite output")
        delta = {k: c1[k] - c0[k] for k in c1}
        per[name] = ms
        log(f"[main] {name}: {ms:.0f} ms; launches {delta}; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del out, got
    counts = kernels.launch_counts()
    after = {k: disp.value(kernel=k) for k in before}
    for k, v in counts.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 "main path")
    for k in before:
        if after[k] <= before[k]:
            raise AssertionError(f"kernel_dispatch_total{{kernel={k}}} "
                                 "did not grow")
    log(f"[main] launches over the three merges: {counts}; "
        f"kernel_dispatch_total {after}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del base, ordered, rep
    torch.cuda.empty_cache()
    return {"launches": counts, "ms": per}


def phase_exact_vs_kernels(cfg) -> None:
    """Kernel route against the exact route at full width, depth 2."""
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.core import engine
    from repro_torch.core.resolve import canonical_order, seed_from_root
    cfg = cfg.replace(n_layers=2)
    base, contribs = make_models(cfg, DEVICE)
    rep = Replica("chip-smoke-d2", device=DEVICE)
    for c in contribs:
        rep.contribute(c)
    ref = rep.register_base(base)
    order = canonical_order(rep.state)
    seed = seed_from_root(rep.merkle_root())
    for name, cfgd, uses_base in STRATEGIES:
        spec = MergeSpec(name, cfgd, base_ref=ref if uses_base else None)
        exact = rep.resolve(spec, use_cache=False)
        kern = engine.merge([rep.state.store[i] for i in order], spec=spec,
                            contrib_ids=order, seed=seed,
                            base=base if uses_base else None,
                            kernels=True, use_cache=False)
        total = bad = 0
        worst = 0.0
        for e, k in zip(pytree.leaves(exact), pytree.leaves(kern)):
            e32, k32 = e.to(torch.float32), k.to(torch.float32)
            d = (e32 - k32).abs()
            worst = max(worst, float(d.max()))
            bad += int((d > LIN_ATOL + LIN_RTOL * e32.abs()).sum())
            total += d.numel()
        share = bad / total
        if name == "ties":
            ok = share <= TIES_MAX_DIFF_SHARE
            rule = f"share beyond one bf16 ulp <= {TIES_MAX_DIFF_SHARE}"
        else:
            ok = bad == 0
            rule = f"|exact - kernel| <= {LIN_ATOL} + {LIN_RTOL} |exact|"
        log(f"[exact-vs-kernels] {name} ({cfg.n_layers} layers): max abs "
            f"diff {worst:.3e}; {bad}/{total} = {share:.2e} beyond one "
            f"bf16 ulp; rule: {rule}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel route outside tolerance")
        del exact, kern
    del base, contribs, rep
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    cfg = get_config("phi3-mini-3.8b")
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    rows = phase_kernels(cfg)
    main = phase_main_path(cfg)
    phase_exact_vs_kernels(cfg)
    for name, row in rows.items():
        row["launches"] = main["launches"][name]
    log(f"[done] {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
