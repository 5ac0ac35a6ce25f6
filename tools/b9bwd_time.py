"""B9's gradient of a checkout, timed on one CUDA card the way
`chip_smoke.py` times it, with the choices of its bf16 design undone one
at a time.

    python3 tools/b9bwd_time.py [--root DIR] [--variants [NAME ...]]
                                [--hashes]

Needs one CUDA card and `nvcc`. Prints the card's name and power limit
first, then one `[b9bwd]` line per reading and, last, one JSON object of
the readings.

  (always)    DIR's kernels built (`build.build_all`; where its
              gradient's source was built now, each instance's ptxas
              registers and spills printed), then
              `flash_attention_backward` of DIR's `src/repro_torch`
              (default: this checkout; its kernels build under
              DIR/build/) at the train step's shape, q, k, v, dO
              [2, 4096, 32, 96] causal (a microbatch of TRAIN_4K at
              Phi-3-mini's widths), bf16 and fp32, through
              `chip_smoke.flash_bwd_case` of this checkout: the LSE
              forward bitwise the served forward, the gradient bitwise
              repeatable and within `chip_smoke.py`'s rule of
              `flash_attention_backward_plain`, then timed with
              `chip_smoke.cuda_ms` beside the backward of
              `scaled_dot_product_attention`, and each of its three
              kernels traced. Point DIR at an unpacked older commit to
              time its kernels by the same clock; run two checkouts in
              turns (parent, change, change, parent) to compare them.
  --variants  this checkout's gradient source rebuilt with one choice
              undone (VARIANTS; the NAMEs given, else all), each
              instance's ptxas registers and spills printed, each held
              to the same rule, bf16 and fp32, at the train shape and at
              small shapes (MHA, GQA, MQA, every head dim, non-causal, q
              x8, one row; q x8 in bf16 only: in fp32 the rule's 1e-5
              floor is for gradients of order 1, and that case is held
              to a float64 oracle by tests/test_torch_cuda.py's
              `test_cuda_flash_backward_peaked_fp32`), and timed at the
              train shape in turns, its three kernels traced apart. Each variant replaces exact
              text of the source (every occurrence) and stops if it is
              not there; "shipped" (the source as it is) always runs.
  --hashes    SHA-256 prefixes of DIR's B9 outputs on seeded inputs:
              the bf16 and fp32 prefill and LSE forward at the serving
              shape, a decode step, and the fp32 gradient at the train
              shape; equal lines from two checkouts mean equal bits.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402  (the case and its clock; this checkout's src/)

B, S, H, D = 2, 4096, 32, 96
KV = "constexpr bool dkdv_kv_regs() { return D <= 96; }"
COLS = "constexpr int dkdv_cols() { return D >= 96 ? 16 : 32; }"
LB = "__launch_bounds__(kMmaBwdThreads, kMmaBwdMinBlocks)"
DQ = "constexpr int kDqCols = 32;"
CAP_F32 = ("if (softcap > 0.f) tile(std::true_type{});\n"
           "  else tile(std::false_type{});")
CAP_KV = ("if (capped) tile(std::true_type{});\n"
          "      else tile(std::false_type{});")
CAP_Q = ("if (capped) tile_ds(std::true_type{});\n"
         "      else tile_ds(std::false_type{});")
VARIANTS = {
    "shipped": [],
    # dK / dV at D = 96: K and V read from shared memory every step, 32
    # columns a step
    "kv_smem_c32": [(KV, KV.replace("96", "64")),
                    (COLS, COLS.replace("96", "128"))],
    # no minimum of blocks an SM in the launch bounds
    "min_blocks_1": [(LB, "__launch_bounds__(kMmaBwdThreads)")],
    # dQ: 16 or 64 keys a step
    "dq16": [(DQ, DQ.replace("32", "16"))],
    "dq64": [(DQ, DQ.replace("32", "64"))],
    # every design without its softcap branch: the uncapped tile alone
    # compiled (what the gradient was before it took the softcap)
    "no_cap": [(CAP_F32, "tile(std::false_type{});"),
               (CAP_KV, "tile(std::false_type{});"),
               (CAP_Q, "tile_ds(std::false_type{});")],
    # every design without the window's mask tests (its loop bounds kept)
    "no_window": [("&& (!window || q - key < window)", "&& true"),
                  ("|| (window && pos - key >= window)", "|| false"),
                  ("|| (window && q0 + B - 1 - k0 >= window)", "|| false")],
}
VARIANTS["no_cap_window"] = VARIANTS["no_cap"] + VARIANTS["no_window"]
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
# (b, s, h, hk, d, causal, q scale): the train shape first
VARIANT_SHAPES = [(B, S, H, H, D, True, 1.0), (2, 130, 4, 4, 64, True, 1.0),
                  (1, 200, 8, 2, 96, True, 1.0),
                  (2, 129, 4, 1, 128, True, 1.0),
                  (2, 37, 4, 2, 16, True, 1.0),
                  (2, 130, 4, 2, 64, False, 1.0),
                  (1, 257, 32, 8, 128, True, 1.0),
                  (2, 200, 4, 2, 96, True, 8.0), (1, 1, 2, 2, 96, True, 1.0)]


def beyond(got, want) -> int:
    """Elements outside chip_smoke.py's rule for their dtype."""
    n = 0
    for x, y in zip(got, want):
        f32 = x.dtype == torch.float32
        x, y = x.float(), y.float()
        if f32:
            lim = chip_smoke.FLASH_BWD_F32[0] \
                + chip_smoke.FLASH_BWD_F32[1] * y.abs()
        else:
            lim = 2.0 ** -7 * y.abs() + chip_smoke.FLASH_BWD_BF16_ATOL \
                * float(y.abs().max())
        n += int(((x - y).abs() > lim).sum())
    return n


def variants(out: dict, only) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain, flash_attention_lse)
    cuh = (build.CSRC / "flash_attention_bwd.cuh").read_text()
    dest = build.BUILD_DIR.parent / "b9bwd_variants"
    unknown = set(only or ()) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    chosen = {n: subs for n, subs in VARIANTS.items()
              if not only or n == "shipped" or n in only}
    procs = {}
    for name, subs in chosen.items():
        text = cuh
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        d = dest / name
        d.mkdir(parents=True, exist_ok=True)
        for f in build.CSRC.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        (d / "flash_attention_bwd.cuh").write_text(text)
        (d / "flash_attention_bwd.cu").write_text(
            (build.CSRC / "flash_attention_bwd.cu").read_text())
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.FLAGS, "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        info = chip_smoke.ptxas_info(log)
        regs = {k: f"{v.get('regs', '?').split(',')[0]}; "
                   f"{v.get('spill', '?')}"
                for k, v in sorted(info.items()) if "bwd_" in k}
        out[f"variant {name} ptxas"] = regs
        print(f"[b9bwd] variant {name}: " + " | ".join(
            f"{k} {v}" for k, v in regs.items()), flush=True)
        lib = ctypes.CDLL(str(dest / name / "lib.so"))
        for tag in DTYPES:
            sym = f"flash_attention_bwd_{tag.replace('fp32', 'f32')}"
            fn = getattr(lib, sym)
            fn.argtypes = build.SIGNATURES[sym][1]
            fn.restype = ctypes.c_int
            fns[name, tag] = fn
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, q, k, v, o, lse, do, causal):
        b, sq, h, d = q.shape
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        dd = torch.empty((2, b, h, sq), dtype=torch.float32, device="cuda")
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq,
                  k.shape[1], h, k.shape[2], d, d ** -0.5, int(causal),
                  0.0, 0, stream)
        if code:
            raise RuntimeError(f"launch failed ({code})")
        return dq, dk, dv

    for tag, dtype in DTYPES.items():
        g = torch.Generator(device="cuda").manual_seed(1)
        cases = []
        for b, s, h, hk, d, causal, mult in VARIANT_SHAPES:
            if tag == "fp32" and mult != 1.0:
                continue                # held to a float64 oracle instead
            q = (torch.randn((b, s, h, d), generator=g, device="cuda")
                 * mult).to(dtype)
            k, v = (torch.randn((b, s, hk, d), generator=g, device="cuda")
                    .to(dtype) for _ in range(2))
            do = torch.randn((b, s, h, d), generator=g,
                             device="cuda").to(dtype)
            o, lse = flash_attention_lse(q, k, v, causal=causal)
            want = flash_attention_backward_plain(q, k, v, o, lse, do,
                                                  causal=causal)
            cases.append(((q, k, v, o, lse, do, causal), want))
        mine = [(n, fn) for (n, t), fn in fns.items() if t == tag]
        for name, fn in mine:
            bad = []
            for args, want in cases:
                got = call(fn, *args)
                again = call(fn, *args)
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                bad.append(beyond(got, want) if same else "not repeatable")
            out[f"variant {name} {tag} beyond"] = bad
            print(f"[b9bwd] variant {name} {tag}: elements beyond the rule "
                  f"per shape {bad}", flush=True)
        args = cases[0][0]
        for name, fn in mine + mine[::-1]:
            t = chip_smoke.cuda_ms(lambda: call(fn, *args), 10)
            split = chip_smoke.kernel_split_ms(lambda: call(fn, *args),
                                               chip_smoke.BWD_KERNELS)
            out.setdefault(f"variant {name} {tag} ms", []).append(t)
            out.setdefault(f"variant {name} {tag} split_ms",
                           []).append(split)
            print(f"[b9bwd] variant {name} {tag}: {t:.4f} ms at [{B}, {S}, "
                  f"{H}, {D}]; kernels {split}", flush=True)
        del cases, args
        torch.cuda.empty_cache()


def hashes(out: dict) -> None:
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_lse)

    def h(*ts):
        return " ".join(hashlib.sha256(
            t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            .hexdigest()[:16] for t in ts)

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    res = {}
    for label, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        q, k, v = (randn(4, 4064, H, D, dtype=dt) for _ in range(3))
        res[f"prefill {label}"] = h(flash_attention(q, k, v))
        res[f"lse forward {label}"] = h(*flash_attention_lse(q, k, v))
        del q, k, v
    q, kc, vc = randn(4, 1, H, D), randn(4, 4096, H, D), randn(4, 4096, H, D)
    res["decode bf16"] = h(flash_attention(q, kc, vc, q_offset=4063))
    q, k, v, do = (randn(B, S, H, D, dtype=torch.float32) for _ in range(4))
    o, lse = flash_attention_lse(q, k, v)
    res["backward fp32"] = h(*flash_attention_backward(q, k, v, o, lse, do))
    out["hashes"] = res
    print(f"[b9bwd] hashes {json.dumps(res)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--variants", nargs="*", default=None,
                    metavar="NAME")
    ap.add_argument("--hashes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b9bwd_time: CUDA is not available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    if args.variants is not None and root != HERE:
        raise SystemExit("--variants rebuilds this checkout's source")
    sys.path.insert(0, str(root / "src"))
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {root}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    out: dict = {"root": str(root)}
    from repro_torch.kernels import build
    log = build.build_all().get("flash_attention_bwd")
    if log is not None:                 # built now: its ptxas report
        regs = {k: f"{v.get('regs', '?').split(',')[0]}; "
                   f"{v.get('spill', '?')}"
                for k, v in sorted(chip_smoke.ptxas_info(log).items())
                if "bwd_" in k}
        out["ptxas"] = regs
        print("[b9bwd] ptxas: " + " | ".join(
            f"{k} {v}" for k, v in regs.items()), flush=True)
    if args.hashes:
        hashes(out)
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        x = [torch.randn((B, S, H, D), generator=g, device="cuda").to(dtype)
             for _ in range(4)]
        res = chip_smoke.flash_bwd_case(*x)
        del x
        torch.cuda.empty_cache()
        out[label] = res
        print(f"[b9bwd] {label} [{B}, {S}, {H}, {D}] causal: {res['rule']}; "
              f"{res['ms']:.3f} ms (bound {res['bound_ms']:.3f}); kernels "
              f"{res['split_ms']}; SDPA's backward {res['library_ms']:.3f} "
              f"ms", flush=True)
    if args.variants is not None:
        variants(out, args.variants)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
