"""B5 (`ties_block`) of this checkout, beside the B5 of another checkout
(`--root DIR`, e.g. the parent commit unpacked under `build/`), timed on
one CUDA card by one clock (`chip_smoke.cuda_ms`: the device sleeps
ahead of each start event) and held bit for bit against the plain
version.

    python3 tools/ties_time.py [--root DIR] [--variants]

Needs one CUDA card and `nvcc`. Prints the card's name and power limit
first, then the ptxas registers and spill bytes of every B5 instance of
each library, one `[ties]` line per reading, a summary line per k and,
last, one JSON object of the readings. Exits 1 if an instance of this
checkout spills, or if this checkout's B5 is slower than DIR's at any k
(the mean of two readings each, taken in the order DIR, this, this,
DIR).

Each library is `histogram.cu` compiled with this checkout's `nvcc`
flags (`kernels/build.py`) into `build/ties_time/` and called through
its C entry point `ties_block_bf16`, the wrappers' arguments. The
shipped wrapper (`kernels.histogram.ties_block`) is held too.

  shapes   k = 4 on the main-path batch of `chip_smoke.py` (stacked
           [4, 801,181,696] bf16 in 391,202 tiles of 2048), and
           k in {2, 3, 5, 6, 8, 9, 12, 14, 16, 17} on the sparse path's
           column count ([k, 603,979,776] bf16, the first k rows of one
           17-row stack); x and base 0.02 x N(0, 1), seeded; thresholds
           0.3 x each leaf's max |x - base| per contribution, as
           `chip_smoke.merge_batch` makes them. GB/s and the share of the
           bound use `chip_smoke.bound_ms` with bytes = stack + base +
           output + thresholds and 12 operations per stacked element.
  --variants  this checkout's source with one choice changed:
           wide_recompute k = 9-16: the agreement pass loads the rows
                          again (from L1) and trims them anew, rather
                          than keeping the trimmed values in registers;
           wide_reread8   the same on 8 columns a thread, not 4;
           narrow_reread  k <= 8 the same way as wide_recompute;
           threads256     256 threads a tile (one vector a thread at
                          2048; the first version of this design);
           threads64      64 threads a tile (4 vectors a thread);
           min_blocks1/4/5  launch bounds asking for 1, 4 or 5 blocks an
                          SM (a register cap of 255, 128 or 96) for
                          every instance but bf16 K = 14 (the shipped
                          kernel asks for 5 there and names none
                          elsewhere);
           chunk8         the any-k instance loads 8 rows at once, not 4;
           stream_store   the output written with `__stcs` (evict first).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (timing, bounds, this checkout's src/)

KS_SPARSE = (2, 3, 5, 6, 8, 9, 12, 14, 16, 17)
REPS = 10
_STORE = """      *reinterpret_cast<float4*>(out + c + j) =
          make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);"""
_THREADS = "constexpr int kTiesThreads = 128;"
_BOUNDS = "__launch_bounds__(kTiesThreads)"
# the exact-k instances' agreement pass, over the trimmed values kept in
# registers; `_reread(cond)` loads and trims the rows again where `cond`
_AGREE = """#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e)
          merge::agree(tv[i][e], el[e], cnt[e], acc[e]);
"""


def _reread(cond: str) -> tuple:
    return (_AGREE, f"""      if constexpr ({cond}) {{
#pragma unroll
        for (int i = 0; i < K; ++i) r[i].load(col + i * np);
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e)
            merge::agree(merge::trim(r[i][e], b[e], thv[i]), el[e], cnt[e],
                         acc[e]);
      }} else {{
{_AGREE}      }}
""")


_WIDE8 = [("ties_block_kernel_r96<T, K, 4>",
           "ties_block_kernel_r96<T, K, 8>"),
          ("ties_block_kernel<T, K, 4>", "ties_block_kernel<T, K, 8>")]
VARIANTS = {
    "wide_recompute": [_reread("K > 8")],
    "wide_reread8": [_reread("K > 8"), *_WIDE8],
    "narrow_reread": [_reread("K <= 8")],
    "threads256": [(_THREADS, _THREADS.replace("128", "256"))],
    "threads64": [(_THREADS, _THREADS.replace("128", "64"))],
    "min_blocks1": [(_BOUNDS, "__launch_bounds__(kTiesThreads, 1)")],
    "min_blocks4": [(_BOUNDS, "__launch_bounds__(kTiesThreads, 4)")],
    "min_blocks5": [(_BOUNDS, "__launch_bounds__(kTiesThreads, 5)")],
    "chunk8": [("constexpr int kTiesChunk = 4;",
                "constexpr int kTiesChunk = 8;")],
    "stream_store": [(_STORE, """      __stcs(reinterpret_cast<float4*>(out + c + j),
             make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]));""")],
}


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_b5(text: str) -> dict:
    """{instance: (registers, spill store bytes, spill load bytes)} of
    every `ties_block_kernel` instance in an `nvcc -Xptxas=-v` log; an
    instance reads `bf16<K,V>` (`..._r96` where its launch bounds hold it
    to 96 registers; `bf16<KMAX>` for the first design's)."""
    rep, cur = {}, None
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"ties_block_kernel(_r96)?I([tf])"
                          r"((?:L[ib]\d+E)+)E", ln)
            cur = m and ("bf16" if m.group(2) == "t" else "f32") + "<" \
                + ",".join(re.findall(r"L[ib](\d+)E", m.group(3))) + ">" \
                + (m.group(1) or "")
            if cur:
                rep[cur] = [None, None, None]
        elif cur and "spill stores" in ln:
            n = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            rep[cur][1:] = [int(n[0]), int(n[1])]
        elif cur and "Used" in ln and "registers" in ln:
            rep[cur][0] = int(re.search(r"Used (\d+) registers", ln)
                              .group(1))
            cur = None
    return {k: tuple(v) for k, v in rep.items()}


def build(sources: dict) -> dict:
    """Compile {name: (source text, include dir)} in parallel into
    build/ties_time/; {name: (library path, ptxas log)}."""
    from repro_torch.kernels import build as B
    dest = B.BUILD_DIR.parent / "ties_time"
    dest.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, inc) in sources.items():
        (dest / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [B.nvcc_path(), *B.FLAGS, "-I", str(inc), "-o",
             str(dest / f"{name}.so"), str(dest / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        out[name] = (dest / f"{name}.so", text)
    return out


def caller(lib_path: Path):
    """`ties_block(x, base, thr, block)` through a library's C entry
    point, on bf16 stacks."""
    from repro_torch.kernels import build as B
    fn = getattr(ctypes.CDLL(str(lib_path)), "ties_block_bf16")
    fn.argtypes = B.SIGNATURES["ties_block_bf16"][1]
    fn.restype = ctypes.c_int

    def run(x, base, thr, block):
        out = torch.empty_like(base)
        rc = fn(x.data_ptr(), base.data_ptr(), thr.data_ptr(),
                out.data_ptr(), x.shape[0], x.shape[1], block,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{lib_path.name}: launch failed ({rc})")
        return out
    return run


def batch(cfg, k: int, rows: int, g) -> dict:
    """A bf16 stack of `rows` rows over the columns of the engine's
    largest batch of k contributions, with per-tile thresholds."""
    from repro_torch.kernels import histogram as H
    from repro_torch.kernels.config import kernel_env
    dev = torch.device("cuda")
    block = kernel_env.block
    lengths = chip_smoke.main_path_lengths(cfg, k=k)
    leaf_id, _, npad = H.batch_layout(lengths, block)
    x = (torch.randn((rows, npad), generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    base = torch.randn((npad,), generator=g, device=dev) * 0.02
    lid = torch.tensor(leaf_id, device=dev)
    bmax = H.block_amax_plain(x, base, block)
    amax = torch.stack([bmax[lid == j].amax(dim=0)
                        for j in range(len(lengths))])[lid] + 1e-12
    return {"x": x, "base": base, "thr": (amax * 0.3).contiguous(),
            "block": block, "npad": npad, "nb": len(leaf_id)}


def time_k(k: int, b: dict, libs: dict, parent: str, out: dict) -> None:
    """Hold every library and the shipped wrapper at k, then time them:
    the parent and this checkout in the order parent, this, this,
    parent; the variants once each."""
    from repro_torch.kernels import histogram as H
    x = b["x"][:k]
    thr = b["thr"][:, :k].contiguous()
    base, block, npad, nb = b["base"], b["block"], b["npad"], b["nb"]
    want = H.ties_block_plain(x, base, thr, block)
    if not torch.equal(H.ties_block(x, base, thr, block), want):
        raise AssertionError(f"k={k}: the shipped wrapper != plain")
    for name, run in libs.items():
        if not torch.equal(run(x, base, thr, block), want):
            raise AssertionError(f"k={k}: {name} != plain version")
    del want
    nbytes = k * npad * 2 + npad * 4 * 2 + nb * k * 4
    bms, by, _, _ = chip_smoke.bound_ms(nbytes, 12 * k * npad)
    order = ([parent] if parent else []) + ["change", "change"] \
        + ([parent] if parent else []) \
        + [n for n in libs if n not in ("change", parent)]
    reads: dict = {}
    for name in order:
        run = libs[name]
        ms = chip_smoke.cuda_ms(lambda: run(x, base, thr, block), REPS)
        reads.setdefault(name, []).append(ms)
        log(f"[ties] k={k} {name}: bitwise equal to plain; {ms:.4f} ms, "
            f"{nbytes / ms / 1e6:.0f} GB/s, {bms / ms:.1%} of the "
            f"{bms:.3f} ms bound (by {by})")
    row = {"stacked": [k, npad], "bound_ms": bms, "bound_by": by,
           "ms": reads}
    mean = {n: sum(v) / len(v) for n, v in reads.items()}
    row["share"] = {n: bms / m for n, m in mean.items()}
    if parent:
        row["speedup"] = mean[parent] / mean["change"]
        row["slower_than_parent"] = mean["change"] > mean[parent]
    out[f"k{k}"] = row
    log(f"[ties] k={k} summary: "
        + ", ".join(f"{n} {m:.4f} ms ({bms / m:.1%})"
                    for n, m in mean.items())
        + (f"; parent / change {row['speedup']:.3f}x" if parent else ""))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=None,
                    help="another checkout whose B5 is timed beside "
                    "this one's (the parent)")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ties_time: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build as B
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    src = (B.CSRC / "histogram.cu").read_text()
    sources = {"change": (src, B.CSRC)}
    parent = ""
    if args.root is not None:
        pcsrc = args.root.resolve() / "src" / "repro_torch" / "csrc"
        parent = "parent"
        sources[parent] = ((pcsrc / "histogram.cu").read_text(), pcsrc)
    if args.variants:
        for name, subs in VARIANTS.items():
            text = src
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"variant {name}: {old!r} not in "
                                       "the source")
                text = text.replace(old, new)
            sources[name] = (text, B.CSRC)
    B.build_all()
    built = build(sources)
    out: dict = {"root": str(args.root) if args.root else None,
                 "ptxas": {}}
    spilled = []
    for name, (_, text) in built.items():
        rep = ptxas_b5(text)
        out["ptxas"][name] = rep
        log(f"[ties] {name} ptxas (registers/spill store/spill load "
            "bytes): " + "; ".join(f"{i} {r}/{s}/{ld}" for i, (r, s, ld)
                                   in sorted(rep.items())))
        if name == "change":
            spilled = [i for i, (_, s, ld) in rep.items() if s or ld]
    libs = {name: caller(path) for name, (path, _) in built.items()}
    cfg = get_config("phi3-mini-3.8b")
    g = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 200)
    b = batch(cfg, chip_smoke.K, chip_smoke.K, g)
    log(f"[ties] main path: stacked [{chip_smoke.K}, {b['npad']}] bf16, "
        f"{b['nb']} tiles of {b['block']}")
    time_k(chip_smoke.K, b, libs, parent, out)
    b.clear()
    torch.cuda.empty_cache()
    b = batch(cfg, chip_smoke.K + 1, max(KS_SPARSE), g)
    log(f"[ties] sparse path: {b['npad']} columns in {b['nb']} tiles, "
        f"the first k of {max(KS_SPARSE)} rows")
    for k in KS_SPARSE:
        time_k(k, b, libs, parent, out)
    slower = [k for k, row in out.items()
              if isinstance(row, dict) and row.get("slower_than_parent")]
    log(f"[ties] spills in this checkout's instances: {spilled or 'none'}; "
        f"k slower than the parent: {slower or 'none'}")
    print(json.dumps(out))
    return 1 if spilled or slower else 0


if __name__ == "__main__":
    sys.exit(main())
