"""B9 (flash attention) of a checkout, timed on one CUDA card the way
`chip_smoke.py` times it, with its decode design's key chunks swept and
two design choices of its bf16 prefill undone.

    python3 tools/b9_time.py [--root DIR] [--sweep] [--variants]

Needs one CUDA card and `nvcc`. Prints the card's name and power limit
first, then one `[b9]` line per reading and, last, one JSON object of
the readings.

  (always)    `flash_attention` of DIR's `src/repro_torch` (default:
              this checkout; its kernels build under DIR/build/) at the
              serving shapes of `chip_smoke.py`: the prefill, q, k, v
              [4, 4064, 32, 96] causal, in bf16 and fp32, and a decode
              step, q [4, 1, 32, 96] over a [4, 4096, 32, 96] cache at
              q_offset 4063; each held against `flash_attention_plain`
              (elements beyond one bf16 ulp of |plain| + 1e-6, or beyond
              1e-5 in fp32) and timed with
              `chip_smoke.cuda_ms` of this checkout, with the device
              sleep ahead of the start event and without it (the method
              up to PR 15), beside `scaled_dot_product_attention` timed
              both ways. Point DIR at an unpacked older commit to time
              its kernel by the same clock.
  --sweep     this checkout's decode design at 1 to 32 key chunks, at
              batch 1, 2 and 4 (32 KV heads, D = 96, 4064 visible keys)
              and at batch 1 over 1024 keys, beside the count that
              `decode_splits` picks.
  --variants  this checkout's flash source rebuilt with one choice of
              the bf16 prefill undone, held to the same rule over
              three seeds at five shapes and timed at the serving
              shape: `p2` (P in two bf16 terms, not three) and `expf`
              (expf of natural-base logits, not 2^x on the special-
              function unit). Each variant replaces exact lines of the
              source and stops if they are not there.
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
import chip_smoke  # noqa: E402  (timing, and this checkout's src/)

# (b, s, h, hk, d): the serving prefill first
SHAPES = [(4, 4064, 32, 32, 96), (2, 200, 4, 2, 96), (2, 300, 4, 2, 16),
          (1, 200, 4, 1, 128), (2, 1000, 4, 2, 64)]
VARIANTS = {
    "shipped": [],
    "p2": [("        mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);\n", ""),
           ("        mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);\n", "")],
    "expf": [("exp2_approx(__fsub_rn", "expf(__fsub_rn"),
             ("const float scale2 = __fmul_rn(scale, 1.4426950408889634f);",
              "const float scale2 = scale;")],
}
SWEEP_SPLITS = (1, 2, 3, 4, 5, 6, 8, 11, 16, 32)
# (batch, visible keys); 32 KV heads, D = 96, a 4096-slot cache
SWEEP_SHAPES = ((1, 4064), (2, 4064), (4, 4064), (1, 1024))
H, D, SLOTS, PROMPT = 32, 96, 4096, 4064


def beyond(got, want) -> int:
    """Elements beyond one bf16 ulp of |plain| + 1e-6 (bf16), or beyond
    chip_smoke's fp32 limit (fp32)."""
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        return int(((g - w).abs() > chip_smoke.FLASH_F32_ATOL).sum())
    return int(((g - w).abs() > 2.0 ** -7 * w.abs() + 1e-6).sum())


def both(fn, reps: int = 10) -> dict:
    return {"sleep": chip_smoke.cuda_ms(fn, reps),
            "no_sleep": chip_smoke.cuda_ms(fn, reps, sleep=False)}


def randn(g, *shape):
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def serving(out: dict) -> None:
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (randn(g, 4, PROMPT, H, D) for _ in range(3))
    qd = randn(g, 4, 1, H, D)
    kc, vc = randn(g, 4, SLOTS, H, D), randn(g, 4, SLOTS, H, D)
    cases = {"prefill": (q, k, v, 0, PROMPT),
             "prefill fp32": (q.float(), k.float(), v.float(), 0, PROMPT),
             "decode": (qd, kc, vc, PROMPT - 1, PROMPT)}
    for name, (q, k, v, off, kend) in cases.items():
        got = flash_attention(q, k, v, q_offset=off)
        bad = beyond(got, flash_attention_plain(q, k, v, q_offset=off))
        qt, kt, vt = (x.transpose(1, 2).contiguous()
                      for x in (q, k[:, :kend], v[:, :kend]))
        ours = both(lambda: flash_attention(q, k, v, q_offset=off))
        sdpa = both(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=q.shape[1] > 1))
        out[name] = {"beyond": bad, "ms": ours, "sdpa_ms": sdpa}
        print(f"[b9] {name} {list(q.shape)}: {bad} beyond one ulp; "
              f"{ours['sleep']:.4f} ms with the sleep, "
              f"{ours['no_sleep']:.4f} without; SDPA {sdpa['sleep']:.4f} / "
              f"{sdpa['no_sleep']:.4f}", flush=True)


def sweep(out: dict) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        DECODE_TILE, decode_splits, flash_attention_plain)
    fn = build.function("flash_decode_bf16")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(1)
    for b, kend in SWEEP_SHAPES:
        q = randn(g, b, 1, H, D)
        k, v = randn(g, b, SLOTS, H, D), randn(g, b, SLOTS, H, D)
        want = flash_attention_plain(q, k, v, q_offset=kend - 1)
        o = torch.empty_like(q)
        tickets = torch.zeros(b * H, dtype=torch.int32, device="cuda")
        res = {}
        for n in SWEEP_SPLITS:
            chunk = -(-(-(-kend // n)) // DECODE_TILE) * DECODE_TILE
            n = -(-kend // chunk)
            part = torch.empty(b * H * n * (D + 2), dtype=torch.float32,
                               device="cuda")

            def dec():
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), b, 1, SLOTS, H, H, D,
                          *q.stride()[:3], *k.stride()[:3],
                          *v.stride()[:3], D ** -0.5, 1, kend - 1, 0.0, 0,
                          1, n,
                          chunk, part.data_ptr(), tickets.data_ptr(),
                          stream)
                if code:
                    raise RuntimeError(f"decode launch failed ({code})")
            t = chip_smoke.cuda_ms(dec, 10)
            res[f"{n}x{chunk}"] = [t, beyond(o, want)]
        picked = decode_splits(b, H, kend, D)
        out[f"sweep b{b} kend{kend}"] = {"picked": picked, "ms": res}
        print(f"[b9] decode sweep, batch {b}, {kend} keys (decode_splits "
              f"picks {picked[0]} x {picked[1]}): " + "; ".join(
                  f"{key} {t:.4f} ms ({bad} beyond)"
                  for key, (t, bad) in res.items()), flush=True)


def variants(out: dict) -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_plain
    src = (build.CSRC / "flash_attention.cu").read_text()
    dest = build.BUILD_DIR.parent / "b9_variants"
    dest.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
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
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(dest / f"{name}.so")).flash_attention_bf16
        fn.argtypes = build.SIGNATURES["flash_attention_bf16"][1]
        fn.restype = ctypes.c_int
        libs[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda")
    cases = []
    for seed in range(3):
        g.manual_seed(seed)
        for b, s, h, hk, d in SHAPES:
            if seed and s == PROMPT:
                continue           # the serving shape at seed 0 only
            q, k, v = randn(g, b, s, h, d), randn(g, b, s, hk, d), \
                randn(g, b, s, hk, d)
            cases.append(((b, s, h, hk, d), q, k, v,
                          flash_attention_plain(q, k, v)))
    for name, fn in libs.items():
        bad, t = [], None
        for (b, s, h, hk, d), q, k, v, want in cases:
            o = torch.empty_like(q)

            def call():
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          o.data_ptr(), b, s, s, h, hk, d, *q.stride()[:3],
                          *k.stride()[:3], *v.stride()[:3], d ** -0.5, 1, 0,
                          0.0, 0, stream)
                if code:
                    raise RuntimeError(f"{name}: launch failed ({code})")
            call()
            torch.cuda.synchronize()
            bad.append(beyond(o, want))
            if s == PROMPT and t is None:
                t = chip_smoke.cuda_ms(call, 10)
        out[f"variant {name}"] = {"prefill_ms": t, "beyond": bad}
        print(f"[b9] variant {name}: prefill [4, 4064, 32, 96] bf16 "
              f"{t:.4f} ms; elements beyond one bf16 ulp + 1e-6 per case "
              f"{bad} (total {sum(bad)})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b9_time: CUDA is not available", file=sys.stderr)
        return 2
    root = args.root.resolve()
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
    serving(out)
    if args.sweep or args.variants:
        if root != HERE:
            raise SystemExit("--sweep and --variants time this checkout")
        if args.sweep:
            sweep(out)
        if args.variants:
            variants(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
