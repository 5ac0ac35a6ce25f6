"""B3 (`block_amax`) and B4 (`block_hist`) of a checkout, timed on one
CUDA card the way `chip_smoke.py` times them, on a Gaussian and a
concentrated input.

    python3 tools/hist_time.py [--root DIR] [--variants]

Needs one CUDA card and `nvcc`. Prints the card's name and power limit
first, then one `[hist]` line per reading and, last, one JSON object of
the readings.

  (always)    `block_amax` and `block_hist` of DIR's `src/repro_torch`
              (default: this checkout; its kernels build under
              DIR/build/) at the main-path batch of `chip_smoke.py`:
              stacked [4, 801,181,696] bf16 in 391,202 tiles of 2048,
              512 bins, on two inputs:
                gaussian      the batch of `chip_smoke.py` (x and base
                              0.02 x N(0, 1), seeded);
                concentrated  the same with one element per leaf and
                              contribution set to base + 1000 x the
                              typical |x - base|, so nearly every count
                              falls in bins 0-3 (real fine-tune deltas
                              are heavy-tailed; the bins one warp's
                              lanes add to collide).
              Each kernel is held bitwise against its plain version and
              timed with `chip_smoke.cuda_ms` of this checkout (the
              device sleeps ahead of each start event), with GB/s and
              the share of its bound (`chip_smoke.bound_ms`; the same
              for both inputs). Point DIR at an unpacked older commit
              to time its kernels by the same clock.
  --variants  this checkout's histogram source rebuilt with one choice
              changed, each variant's B3 and B4 ptxas registers and the
              opcode census of its bf16 B4 instance's SASS printed, held
              and timed the same way:
                load_row          each segment loaded and widened in one
                                  step by `merge::load_row`, not loaded
                                  whole and then widened;
                prefetch          each row's loads issued before the
                                  previous row's arithmetic (a second
                                  row of registers);
                seg2048, seg512   a lane holds 8 or 2 vectors, not 4
                                  (a segment of 2048 or 512 columns);
                hist_min6         B4's launch bounds ask for 6 blocks an
                                  SM, so fewer registers a thread;
                aggregate         one lane adds each bin's count for the
                                  warp, found by __match_any_sync;
                fadd_int          B4 truncates to an integer by adding
                                  2^23 with round-toward-zero on the
                                  fp32 pipe, not by a conversion
                                  instruction (exact on [0, 2^23), the
                                  rest as the conversion maps it);
              and, not held (they compute something else), timed only to
              show what B4 spends its time on:
                no_div            the bin index multiplies where it
                                  divides;
                no_atomic         the bin index is computed and dropped,
                                  no shared-memory atomic.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (timing, bounds, and this checkout's src/)

_BIN = "int idx = __float2int_rz(__fmul_rn(__fdiv_rn(a, am), fbins));"
_ADD = "if (keep) atomicAdd(&h[idx], 1u);"
BOTH, HIST = ("block_amax", "block_hist"), ("block_hist",)
_ROWS = """      for (int i = g0; i < g1; ++i) {
        Seg v;
        load_raw(col + static_cast<long long>(i) * np, nv, lane, r);
        widen(r, v);
        row(i, i - g0, s0, v, b);
      }
"""
_PREFETCH = """      load_raw(col + static_cast<long long>(g0) * np, nv, lane, r);
      for (int i = g0; i < g1; ++i) {
        Seg v;
        widen(r, v);
        if (i + 1 < g1)
          load_raw(col + static_cast<long long>(i + 1) * np, nv, lane, r);
        row(i, i - g0, s0, v, b);
      }
"""


def _min_blocks(which: str, n: int):
    lb = f"__launch_bounds__(k{which}Warps * kLanes)"
    return lb, lb.replace(")", f", {n})", 1)


def _seg(n: int):
    return ("constexpr int kSegVecs = 4;", f"constexpr int kSegVecs = {n};")


_BASE = """      Raw<float> rb;
      load_raw(base + t0 + s0, nv, lane, rb);
      Seg b;
      widen(rb, b);
"""


def _load_row(dest: str, src: str) -> str:
    """`merge::load_row` of a segment into `dest`, as the first design."""
    return f"""#pragma unroll
        for (int j = 0; j < kSegVecs; ++j) {{
          const int q = j * kLanes + lane;
          if (q < nv) {{
            merge::load_row<kVec>({src} + q * kVec, {dest}[j]);
          }} else {{
#pragma unroll
            for (int e = 0; e < kVec; ++e) {dest}[j][e] = 0.f;
          }}
        }}
"""


# name: (substitutions, held against the plain version, kernels timed)
VARIANTS = {
    "load_row": ([(_BASE, "      Seg b;\n" + _load_row("b", "(base + t0 + s0)")),
                  (_ROWS, """      for (int i = g0; i < g1; ++i) {
        Seg v;
""" + _load_row("v", "(col + static_cast<long long>(i) * np)") + """        row(i, i - g0, s0, v, b);
      }
""")], True, BOTH),
    "prefetch": ([(_ROWS, _PREFETCH)], True, BOTH),
    "seg2048": ([_seg(8)], True, BOTH),
    "seg512": ([_seg(2)], True, BOTH),
    "hist_min6": ([_min_blocks("Hist", 6)], True, HIST),
    "aggregate": ([(_ADD, "{ const unsigned int peers = __match_any_sync("
                    "0xffffffffu, keep ? idx : -1); if (keep && lane == "
                    "__ffs(peers) - 1) atomicAdd(&h[idx], static_cast<"
                    "unsigned int>(__popc(peers))); }")], True, HIST),
    "fadd_int": ([(_BIN, "const float q = __fmul_rn(__fdiv_rn(a, am), "
                   "fbins); int idx = (q >= 0.f && q < 8388608.f) ? "
                   "__float_as_int(__fadd_rz(q, 8388608.f)) - 0x4B000000 "
                   ": (q >= 8388608.f ? bins - 1 : 0);")], True, HIST),
    "no_div": ([(_BIN, _BIN.replace("__fdiv_rn", "__fmul_rn"))], False,
               HIST),
    "no_atomic": ([(_ADD, 'asm volatile("" :: "r"(idx));')], False, HIST),
}
REPS = 10


def inputs(cfg) -> dict:
    """The main-path batch of `chip_smoke.phase_kernels` and its
    concentrated copy, each with its per-tile amax metadata."""
    from repro_torch.kernels import histogram as H
    from repro_torch.kernels.config import kernel_env
    dev = torch.device("cuda")
    block = kernel_env.block
    lengths = chip_smoke.main_path_lengths(cfg)
    leaf_id, valid, npad = H.batch_layout(lengths, block)
    g = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 100)
    k = chip_smoke.K
    x = (torch.randn((k, npad), generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    base = torch.randn((npad,), generator=g, device=dev) * 0.02
    typical = float((x[:, :1 << 20].float() - base[:1 << 20]).abs()
                    .median())
    xc = x.clone()
    start = 0
    for j, n in enumerate(lengths):
        for i in range(k):
            c = start + (i * 7919 + j * 104729) % n
            sign = 1.0 if (i + j) % 2 == 0 else -1.0
            xc[i, c] = (base[c] + sign * 1000.0 * typical).to(torch.bfloat16)
        start += -(-n // block) * block
    lid = torch.tensor(leaf_id, device=dev)
    vld = torch.tensor(valid, dtype=torch.int32, device=dev)
    out = {"block": block, "bins": kernel_env.hist_bins, "nb": len(leaf_id),
           "npad": npad, "base": base, "valid": vld, "typical": typical}
    out["plain"] = {}
    for name, xs in (("gaussian", x), ("concentrated", xc)):
        bmax = H.block_amax_plain(xs, base, block)
        meta = (torch.stack([bmax[lid == j].amax(dim=0)
                             for j in range(len(lengths))])[lid]
                + 1e-12).contiguous()
        out[name] = (xs, meta)
        out["plain"][name] = {"block_amax": bmax, "block_hist":
                              H.block_hist_plain(xs, base, meta, vld,
                                                 out["bins"], block)}
    return out


def bounds(d: dict) -> dict:
    k, npad, nb, bins = chip_smoke.K, d["npad"], d["nb"], d["bins"]
    xe = k * npad * 2
    return {"block_amax": (xe + npad * 4 + nb * k * 4, 3 * k * npad),
            "block_hist": (xe + npad * 4 + nb * k * 4 + nb * 4
                           + nb * k * bins * 4, 6 * k * npad)}


def low_share(counts: torch.Tensor, bins: int) -> float:
    per = counts.reshape(-1, bins).sum(dim=0, dtype=torch.int64)
    return float(per[:4].sum()) / float(per.sum())


def time_pair(label: str, amax_fn, hist_fn, d: dict, out: dict,
              held: bool = True, names=("block_amax", "block_hist")) -> None:
    """Hold the kernels against their plain versions on both inputs
    (unless not `held`), then time them."""
    block, bins, base, vld = d["block"], d["bins"], d["base"], d["valid"]
    bnd = bounds(d)
    for inp in ("gaussian", "concentrated"):
        xs, meta = d[inp]
        calls = {"block_amax": lambda: amax_fn(xs, base, block),
                 "block_hist": lambda: hist_fn(xs, base, meta, vld, bins,
                                               block)}
        for name in names:
            kern = calls[name]
            got = kern()
            torch.cuda.synchronize()
            if held and not torch.equal(got, d["plain"][inp][name]):
                raise AssertionError(f"{label} {name} on {inp}: kernel != "
                                     "plain version")
            extra = (f"; {low_share(got, bins):.4f} of counts in bins 0-3"
                     if held and name == "block_hist" else "")
            del got
            ms = chip_smoke.cuda_ms(kern, REPS)
            nbytes, ops = bnd[name]
            bms, by, _, _ = chip_smoke.bound_ms(nbytes, ops)
            out[f"{label} {name} {inp}"] = {
                "ms": ms, "bound_ms": bms, "bound_by": by,
                "gb_per_s": nbytes / ms / 1e6, "share": bms / ms,
                "held": held}
            print(f"[hist] {label} {name} {inp}: "
                  + ("bitwise equal to plain" if held else "NOT HELD "
                     "(computes something else)")
                  + f"; {ms:.4f} ms, {nbytes / ms / 1e6:.0f} GB/s, "
                  f"{bms / ms:.1%} of the {bms:.3f} ms bound (by {by})"
                  f"{extra}", flush=True)


def shipped(d: dict, out: dict, label: str) -> None:
    from repro_torch.kernels import histogram as H
    time_pair(label, H.block_amax, H.block_hist, d, out)


def ptxas_report(log: str) -> str:
    """Registers and spill stores of the B3 and B4 instances."""
    cur, rep = None, {}
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = ln.split("'")[1]
            kind = ("block_amax" if "block_amax_kernel" in m else
                    "block_hist" if "block_hist_kernel" in m else None)
            cur = kind and f"{kind}<{'bf16' if 'ItE' in m else 'f32'}>"
        elif cur and "spill stores" in ln:
            rep[cur] = ln.split(",")[1].strip()
        elif cur and "registers" in ln:
            regs = ln.split("Used ")[1].split(",")[0]
            rep[cur] = f"{regs}, {rep.get(cur, '')}"
    return "; ".join(f"{k} {v}" for k, v in sorted(rep.items()))


def sass_census(lib: Path) -> str:
    """Opcode counts in the SASS of the bf16 `block_hist_kernel`, most
    frequent first."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    inside = False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = "block_hist_kernel" in ln and "ItE" in ln
        elif inside and "*/" in ln and "/*" in ln:
            body = ln.split("*/", 1)[1].strip().split(";")[0].strip()
            if not body or body.startswith("/*"):
                continue
            op = body.split()[0]
            if op.startswith("@"):
                op = body.split()[1]
            counts[op] = counts.get(op, 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])
    return f"{sum(counts.values())} instructions: " + ", ".join(
        f"{op} {n}" for op, n in top[:24])


def variants(d: dict, out: dict) -> None:
    """This checkout's histogram source with one choice changed, called
    through its own library with the wrappers' arguments."""
    from repro_torch.kernels import build
    from repro_torch.kernels import histogram as H
    src = (build.CSRC / "histogram.cu").read_text()
    dest = build.BUILD_DIR.parent / "hist_variants"
    dest.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (subs, _, _) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        (dest / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.FLAGS, "-I", str(build.CSRC), "-o",
             str(dest / f"{name}.so"), str(dest / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    stream = torch.cuda.current_stream().cuda_stream
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(f"[hist] variant {name} ptxas: {ptxas_report(log)}",
              flush=True)
        print(f"[hist] variant {name} block_hist<bf16> SASS: "
              f"{sass_census(dest / f'{name}.so')}", flush=True)
        lib = ctypes.CDLL(str(dest / f"{name}.so"))
        fa, fh = lib.block_amax_bf16, lib.block_hist_bf16
        fa.argtypes = build.SIGNATURES["block_amax_bf16"][1]
        fh.argtypes = build.SIGNATURES["block_hist_bf16"][1]
        fa.restype = fh.restype = ctypes.c_int

        def amax_fn(xs, base, block, fa=fa):
            o = torch.empty((xs.shape[1] // block, xs.shape[0]),
                            dtype=torch.float32, device=xs.device)
            if fa(xs.data_ptr(), base.data_ptr(), o.data_ptr(), xs.shape[0],
                  xs.shape[1], block, stream):
                raise RuntimeError(f"{name}: block_amax launch failed")
            return o

        def hist_fn(xs, base, meta, vld, bins, block, fh=fh):
            H.hist_plan(xs.shape[0], bins)
            o = torch.empty((xs.shape[1] // block, xs.shape[0] * bins),
                            dtype=torch.int32, device=xs.device)
            if fh(xs.data_ptr(), base.data_ptr(), meta.data_ptr(),
                  vld.data_ptr(), o.data_ptr(), xs.shape[0], xs.shape[1],
                  block, bins, stream):
                raise RuntimeError(f"{name}: block_hist launch failed")
            return o

        _, held, names = VARIANTS[name]
        time_pair(f"variant {name}", amax_fn, hist_fn, d, out, held, names)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hist_time: CUDA is not available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    if args.variants and root != HERE:
        raise SystemExit("--variants times this checkout")
    sys.path.insert(0, str(root / "src"))
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {root}")
    from repro_torch.configs import get_config
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    from repro_torch.kernels import build
    logs = build.build_all()
    if "histogram" in logs:
        print(f"[hist] ptxas: {ptxas_report(logs['histogram'])}", flush=True)
    d = inputs(get_config("phi3-mini-3.8b"))
    print(f"[hist] {root}: stacked [{chip_smoke.K}, {d['npad']}] bf16, "
          f"{d['nb']} tiles of {d['block']}, {d['bins']} bins; typical "
          f"|x - base| {d['typical']:.6f}", flush=True)
    out: dict = {"root": str(root)}
    shipped(d, out, "shipped")
    if args.variants:
        variants(d, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
