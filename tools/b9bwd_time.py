"""B9's gradient of a checkout, timed on one CUDA card the way
`chip_smoke.py` times it, with the choices of its bf16 design undone one
at a time.

    python3 tools/b9bwd_time.py [--root DIR] [--variants] [--hashes]

Needs one CUDA card and `nvcc`. Prints the card's name and power limit
first, then one `[b9bwd]` line per reading and, last, one JSON object of
the readings.

  (always)    `flash_attention_backward` of DIR's `src/repro_torch`
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
  --variants  this checkout's gradient source rebuilt with one choice of
              the bf16 design undone (VARIANTS), each instance's ptxas
              registers and spills printed, each held to the same rule
              at the train shape and at small shapes (MHA, GQA, MQA,
              every head dim, non-causal, q x8, one row), and timed at
              the train shape in turns. Each variant replaces exact
              lines of the source and stops if they are not there.
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
}
# (b, s, h, hk, d, causal, q scale): the train shape first
VARIANT_SHAPES = [(B, S, H, H, D, True, 1.0), (2, 130, 4, 4, 64, True, 1.0),
                  (1, 200, 8, 2, 96, True, 1.0),
                  (2, 129, 4, 1, 128, True, 1.0),
                  (2, 37, 4, 2, 16, True, 1.0),
                  (2, 130, 4, 2, 64, False, 1.0),
                  (1, 257, 32, 8, 128, True, 1.0),
                  (2, 200, 4, 2, 96, True, 8.0), (1, 1, 2, 2, 96, True, 1.0)]


def beyond(got, want) -> int:
    """Elements outside chip_smoke.py's bf16 rule."""
    n = 0
    for x, y in zip(got, want):
        x, y = x.float(), y.float()
        lim = 2.0 ** -7 * y.abs() + chip_smoke.FLASH_BWD_BF16_ATOL * float(
            y.abs().max())
        n += int(((x - y).abs() > lim).sum())
    return n


def variants(out: dict) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain, flash_attention_lse)
    cuh = (build.CSRC / "flash_attention_bwd.cuh").read_text()
    dest = build.BUILD_DIR.parent / "b9bwd_variants"
    procs = {}
    for name, subs in VARIANTS.items():
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
                for k, v in sorted(info.items()) if "_mma" in k}
        out[f"variant {name} ptxas"] = regs
        print(f"[b9bwd] variant {name}: " + " | ".join(
            f"{k} {v}" for k, v in regs.items()), flush=True)
        fn = ctypes.CDLL(str(dest / name / "lib.so")).flash_attention_bwd_bf16
        fn.argtypes = build.SIGNATURES["flash_attention_bwd_bf16"][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, q, k, v, o, lse, do, causal):
        b, sq, h, d = q.shape
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        dd = torch.empty((b, h, sq), dtype=torch.float32, device="cuda")
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), dd.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq,
                  k.shape[1], h, k.shape[2], d, d ** -0.5, int(causal),
                  stream)
        if code:
            raise RuntimeError(f"launch failed ({code})")
        return dq, dk, dv

    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for b, s, h, hk, d, causal, mult in VARIANT_SHAPES:
        q = (torch.randn((b, s, h, d), generator=g, device="cuda")
             * mult).to(torch.bfloat16)
        k, v = (torch.randn((b, s, hk, d), generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        do = torch.randn((b, s, h, d), generator=g,
                         device="cuda").to(torch.bfloat16)
        o, lse = flash_attention_lse(q, k, v, causal=causal)
        want = flash_attention_backward_plain(q, k, v, o, lse, do,
                                              causal=causal)
        cases.append(((q, k, v, o, lse, do, causal), want))
    for name, fn in fns.items():
        bad = []
        for args, want in cases:
            got = call(fn, *args)
            again = call(fn, *args)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            bad.append(beyond(got, want) if same else "not repeatable")
        out[f"variant {name} beyond"] = bad
        print(f"[b9bwd] variant {name}: elements beyond the rule per shape "
              f"{bad}", flush=True)
    args = cases[0][0]
    for name, fn in list(fns.items()) + list(fns.items())[::-1]:
        t = chip_smoke.cuda_ms(lambda: call(fn, *args), 10)
        out.setdefault(f"variant {name} ms", []).append(t)
        print(f"[b9bwd] variant {name}: {t:.4f} ms at [{B}, {S}, {H}, {D}]",
              flush=True)


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
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--hashes", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b9bwd_time: CUDA is not available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    if args.variants and root != HERE:
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
    if args.variants:
        variants(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
