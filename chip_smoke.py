"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc`, holds each
against its plain PyTorch version at a batch shape the merge engine
dispatches, then drives the port's main paths at Phi-3-mini's full
width and depth (3,821,079,552 bf16 parameters per model, k = 4
contributions), each with the kernel launch counts set to 0 just
before it and read just after:

  bf16   `Replica.contribute` -> Merkle root -> seed ->
         `engine.merge(..., kernels=True)` for weight_average,
         task_arithmetic and histogram-trim TIES;
  dare   the same contributions through DARE with the kernel RNG
         (`kernel_env.dare_kernel_rng`), seeded from the Merkle root;
  perleaf  the per-leaf kernel API over the same bf16 trees:
           `kernels.slerp_merge(c0, c1)`, `kernels.ties_merge(...,
           trim_method="quantile")` and `kernels.task_arithmetic_merge`;
  int8   the contributions compressed to int8 on the card, merged on
         arrival (weight_average, task_arithmetic) at 8 of the 32
         layers (all 32 before the qwen3-moe phase came);
  serve  the model served from a merge: replica A adds the K
         contributions in order and replica B in reverse; each resolves
         `MergeSpec("ties", base_ref=...)` (byte-identical trees), then
         `greedy_decode` serves A's tree (batch 4, a 4064-token prompt
         from `make_batch`, 32 tokens; every attention call on B9, the
         flash attention kernel), and B's tree must give the same tokens
         and last logits, byte for byte.

  search  genetic_merge and evolutionary_merge through `engine.merge(...,
          contrib_ids=...)` on the same bf16 contributions at full
          depth: whole-model strategies, no kernel (0 launches).
  sparse  benchmarks/bench_sparse.py's adapter update at full width: S,
          base + 0.1 x a seeded delta on the four attention projections
          (1,207,959,552 parameters), lands on replica A, which resolved
          weight_average over the K dense contributions: the warm
          re-resolve runs exactly the 4 attention leaves (fold
          resumptions) and hits the cache on the other 8, bitwise the
          cold resolve and replica B's (reverse order). Then
          `engine.merge(..., coverages=..., kernels=True)` over the K
          dense contributions and S: B1 and B3-B5 launch on fused groups
          of K + 1 rows (attention) and K rows (the rest) in one merge.

  gemma2  Gemma-2 27B (configs/gemma2_27b.py) at full width and depth:
          27,227,128,320 bf16 parameters seeded on the card (54.45 GB),
          `greedy_decode` twice (batch 2, an 8160-token prompt, past
          the local layers' 4096-key window, and 32 tokens; B9 with the
          attention softcap on every call, the window in prefill and the
          local layers' 4096-slot ring caches in decode: exactly 46 x 33
          launches a call), byte-identical tokens and logits, one decode
          step and one prefill traced; then a base and 2 contributions
          at 2 of its layers through two replicas in opposite orders,
          which resolve TIES to byte-identical trees and serve them to
          byte-identical tokens and logits; and at 2 layers (one local,
          one global) the served forward with B9 against its plain
          version. `[kernels]` holds B9 at gemma2's shapes (prefill
          local and global, bf16 and fp32; decode over the ring and the
          global cache).

  qwen3-moe  Qwen3-MoE-30B-A3B (configs/qwen3_moe_30b_a3b.py) at full
          width and depth: 30,532,110,336 bf16 parameters seeded on the
          card (61.06 GB), `greedy_decode` twice (batch 4, a 4064-token
          prompt, 32 tokens; B9 at 32 query heads over 4 KV heads on
          every attention call, exactly 48 x 33 launches a call; 128
          routed experts, top-8, the gather dispatch), byte-identical
          tokens and logits, one decode step and one prefill traced
          (routing / gather kernels a group of their own); a base and 4
          contributions at 2 of its layers through two replicas in
          opposite orders, which resolve histogram TIES and
          weight_average on the kernel routes (B1, B3-B5) to
          byte-identical trees and serve the TIES trees to
          byte-identical tokens and logits; at 2 layers the served
          forward with B9 against its plain version and the gather
          dispatch against the einsum one; then the int8 weight average
          of 2 contributions at 11 of its layers, where each stacked
          expert leaf holds 2,214,592,512 elements (past 2^31), merged
          on arrival through B2 with no slice densified and held
          bitwise against `quant_nary_ref` on windows at its start,
          across 2^31 and at its end. `[kernels]` holds B9 at Qwen3's
          shapes (H / HK = 8; prefill bf16 and fp32, decode) and B2 on
          one such expert leaf, bitwise over the whole output.

The consortium (`[gossip]`, full width, 2 of the 32 layers) runs after
the main paths: 8 gossip nodes on the card with delta gossip, an
attention update each and a dense fine-tune on nodes 0 and 1 (every
payload one tensor shared by all stores); partitioned in two halves a round leaves 2
roots, healed 1; every node resolves weight_average to node 0's bytes,
and nodes 0 and 7 histogram TIES to each other's. Last, the paper's
Tables 6-9 (benchmarks/bench_gossip.py --full: 100 nodes at 512^2 over
2 of its 20 orderings, 10 partitions healing, 26 of 26 strategies at 10 nodes,
2-50 nodes and epidemic gossip) on the card, every node's output
byte-identical; no merge kernel runs there, as in the reference.

The whole-model slice (`[whole]`) runs at Phi-3-mini's full width, 2 of
its 32 layers, fp32 (five fp32 models at 32 layers would take 76.4 GB,
and 2 rather than 16 keeps the script inside its time limit; bf16 SVD
raises in both packages): replica A contributes K models in
order, replica B the same models in reverse order under A's eids; each
resolves star, svd_knot_tying, adarank, evolutionary_merge and
genetic_merge (`MergeSpec(name, base_ref=...)`) and the two trees must
be byte-identical; a second resolve on A must be a whole-model cache
hit. It times each cuSOLVER SVD driver at the embedding's shape. The
audits (`[audit]`) run the paper's Tables 3 and 4 on the card: the raw
pattern of every strategy on `controlled_tensors()` against
`TABLE3_EXPECTED`, the wrapped audit 104/104, the tier-2 slices at 128^2
and 512^2, and the five whole-model strategies on the card against the
CPU at 512^2.

`[durable]` (inside the main paths, after int8) journals the four int8
payloads, cut to 2 of their 32 layers (`first_layers`; 4 before the
qwen3-moe phase came, all 32 before the gemma2 phase), through
`Replica(path=)`, reopens it, and syncs for real: the
recovered replica A, its storage handed to a `SyncNode`, and replica B
on a `keep_quantized` node run an anti-entropy session over
`PersistentLoopbackTransport` (B's root equal to A's, every chunk
shipped once, a second session only SyncReq and SyncDone); replica C,
a client outside the storage domain, takes Layer 1 from A and resolves
weight_average by fetching the payloads from A and B on demand
(multi-source), then re-resolves from its cache after `shed_blobs`
with nothing pulled. Every resolve on arrival (B2 on the int8 payloads,
B1 after `msg_to_state` decompresses) is byte-identical to an in-memory
one. `[sync] fleet`, after the tables, runs bench_antientropy's and
bench_durability's scenarios on the card: anti-entropy at least 5x
fewer bytes than full-state push, and the four durability gates.

At depth 2 it holds the kernel routes against the exact routes
(`Replica.resolve`, and the exact path over the same int8 payloads),
the sparse kernel routes against the exact path, which must be bitwise
`sparse_reference_apply` (and, over fp32 copies, the CPU's), the
per-leaf slerp and quantile-TIES kernels against `Replica.resolve`
(slerp at k = 2, and at k = 4 folded in sequence and as a tree, each
also over fp32 copies against `reference_apply`), and the exact DARE
path's threefry draw on the card against the CPU's, and the served
forward with B9 against the same forward with B9's plain version on the
card (bf16 and fp32 compute).

The training slice runs last. `[train]` trains Phi-3-mini at full width
and depth (fp32 parameters and AdamW moments, bf16 compute, each layer
under remat) for 3 steps of batch 4 x 4096 in microbatches of 2, every
attention call on B9's forward (with its log-sum-exp) and B9's gradient
(`csrc/flash_attention_bwd.cuh`, bf16 on the tensor cores), and traces
the last step. At 2 layers (`[train-d2]`) a step with B9 is held against
the same step with B9's plain forward and backward, a run resumed from a
checkpoint against an uninterrupted one (bitwise), and `python -m
repro_torch.launch.merge` over two branch checkpoints against an
in-process resolve (byte-identical; the CLI runs beside `[btm]`).
`[btm]` runs the reference test's Branch-Train-Merge scenario at full
width, 2 layers: a round, a branch killed, a straggler, an elastic
join, every alive branch byte-identical after each merge.
`[gemma2-train]` runs last: Gemma-2 27B at full width and 1 of its 23
periods (2 layers, a local and a global one; 2 periods before the
[qwen3-moe] phase came; fp32 parameters and moments, 37.0 GB of state,
bf16 compute, remat), 3 steps of batch 2 x 8192 in
microbatches of 1, every attention call on B9's forward and gradient
with the softcap and, on the local sub-layer, the 4096-key window; the
last step traced, and a run resumed from a checkpoint written after
step 2 bitwise the uninterrupted run. `[kernels]` holds B9's gradient
at that microbatch (local and global, bf16 and fp32) beside
`flex_attention`'s backward.

Prints one line per phase, then a JSON line with every kernel's numbers,
the card's name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failed check raises (exit code 1).
Needs CUDA, the CUDA toolkit's `nvcc`, and the repository's `src/`.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

# one device pool that grows in place: the sparse re-resolve's cache
# (every leaf's output and fp32 fold accumulator, 23 GB) beside the five
# models left 9 GB of a segmented pool in fragments and ran out
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
# the train step runs under torch's deterministic mode, which asks for
# cuBLAS's workspace setting before cuBLAS starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
K = 4                       # contributions per merge
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
# Hopper has 64 INT32 lanes per SM against 128 FP32 lanes: half the rate,
# on a pipe of its own that issues beside the FP32 one
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
# linear family: kernel route (fp32 accumulate, one bf16 rounding) vs
# exact route (fp32 fold, one bf16 rounding): one bf16 ulp
LIN_ATOL, LIN_RTOL = 1e-5, 2.0 ** -7
# TIES: the exact path trims in bf16 arithmetic (thresholds, |tau|),
# the kernel route in fp32, so boundary elements may trim differently.
# Two H100 runs measured a share of 1.07e-4 at 2 layers; the limit is
# ten times that, so a fault in the glue between the three kernels (a
# threshold one bucket off, one leaf's tiles summed wrongly) fails.
TIES_MAX_DIFF_SHARE = 1e-3
# int8: the kernel route dequantizes in fp32, the exact route to bf16
# first, so the two differ by up to a bf16 rounding of each input.
# weight_average divides those roundings by k: no element beyond one
# ulp (the H100 read 0). task_arithmetic sums them: the H100 read
# 1.06e-2 of elements beyond one ulp at 2 layers; the limit is ten times
# that, so a route that dequantized with the wrong scale or tile fails.
QUANT_MAX_DIFF_SHARE = {"weight_average": 0.0, "task_arithmetic": 0.1}
DARE_P = 0.5
# per-leaf API at depth 2 against Replica.resolve. The exact path runs
# slerp in bf16 arithmetic (norms, cosine, magnitude each rounded to
# bf16), a scale error on every element, and each fold step rounds and
# feeds the next: the H100 read shares of 6.85e-2 (k = 2), 0.470 (k = 4
# in sequence) and 0.378 (as a tree) beyond one bf16 ulp at 2 layers.
# Ten times those would exceed 1, so the slerp limits are 1.5 times the
# reading (the data is seeded; the share moves only if the arithmetic
# does). The fp32 checks, the exact path and the kernels over fp32 copies
# of the same contributions (k = 2, and k = 4 in sequence and as a tree),
# hold the kernels and the fold order themselves: no element may lie
# beyond 1e-6 + 1e-5 |exact| (the H100 read 0 at k = 2, max abs diff
# 2.2e-8). Quantile TIES: the exact path trims in bf16, the kernel in
# fp32, as for histogram TIES; the H100 read 3.36e-4, limit ten times
# that.
# serving: batch 4 of a 4064-token prompt and 32 generated tokens, so
# max_len is 4096, Phi-3-mini's 4k context
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4064, 32
# B9 against its plain version on the card, which sums the D-long dots
# and the keys in another order and exponentiates with other code: fp32
# within FLASH_F32_ATOL (outputs of order 1), bf16 no element beyond one
# bf16 ulp of |plain| + 1e-6 (equal fp32 values up to that difference,
# each rounded once)
FLASH_F32_ATOL = 1e-5
# the depth-2 served forward with B9 against the same forward with its
# plain version, on logits while the two runs' tokens agree; tokens must
# agree at every step whose top-2 logit margin exceeds the limit. bf16:
# one attention output a bf16 ulp apart moves the logits by a few bf16
# ulps; fp32: summation order only. Stated for Phi-3-mini and for
# gemma2-27b (at 2 layers an H100 read gemma2's logits 3.5e-2 apart in
# bf16 and 1.3e-5 in fp32, Phi-3-mini's 3.5e-2 and 1.7e-5)
SERVE_LOGIT_LIMIT = {"bfloat16": 0.35, "float32": 1.2e-4}
# B9's bf16 prefill at gemma2's shapes (D = 128, 8160 keys, softcap 50):
# one bf16 ulp of |plain| + 2e-6. Outputs near 0 carry ~1e-6 of the
# kernel's fp32 rounding (tensor-core Q K^T sums, 2^x): an H100 read
# 4.23e-6 where the plain version read 3.26e-6 and a float64 oracle of
# the row 3.31e-6, and 1 of 66.8M elements beyond the 1e-6 floor
FLASH_BF16_FLOOR = {"phi3": 1e-6, "gemma2": 2e-6}
# the whole-model slice: 2 of Phi-3-mini's 32 layers in fp32 (five
# models, 8.5 GB). Memory allows 16 (40.2 GB); 2 (8 before the [gemma2]
# phase came) keeps the script inside its time limit
WHOLE_LAYERS = 2
WHOLE = ("star", "svd_knot_tying", "adarank", "evolutionary_merge",
         "genetic_merge")
SEARCH = ("genetic_merge", "evolutionary_merge")
# the five on the card against the CPU at 512^2, relative to the
# output's magnitude (the card tests' limit): cuSOLVER's gesvd against
# LAPACK, and fitness sums in another order
WHOLE_CARD_TOL = 1e-4
# the sync stack: pump's liveness tripwire for a full-width session
# (each step drains every node's sockets once); C's cache holds its
# weight_average output and fp32 fold accumulators (22.9 GB)
PUMP_STEPS = 10_000_000
C_CACHE_BYTES = 32 * 2 ** 30
# [sync] fleet: benchmarks/bench_antientropy.py's defaults and
# benchmarks/bench_durability.py's
FLEET_NODES, FLEET_SIDE, FLEET_DISTINCT, FLEET_SEED = 100, 32, 40, 7
DURABLE_MIB = 64.0
# training (slice 12): TRAIN_4K's sequence, batch 4 in microbatches of
# 2 (the reference's TRAIN_4K is batch 256); full width and depth, fp32
# parameters and moments, bf16 compute, remat "full" (the config's
# defaults)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ACCUM, TRAIN_STEPS = 4, 4096, 2, 3
# the depth-2 checks: one train step with B9 against the same step with
# B9's plain forward and backward. bf16 compute: B9's outputs and
# gradients one bf16 ulp from the plain version's move the rest through
# the projections, as the port's bf16 gradients against JAX's (CPU,
# 1.4e-2 of a leaf's magnitude): each gradient leaf within
# TRAIN_GRAD_TOL of its largest magnitude, the loss within 1e-4
# relative, and after Adam's first step (each element moves by about
# +-lr, the other way where a near-zero gradient changed sign) no
# parameter beyond TRAIN_PARAM_LRS times that step's learning rate
TRAIN_GRAD_TOL, TRAIN_LOSS_RTOL, TRAIN_PARAM_LRS = 5e-2, 1e-4, 2.5
# [btm]: the reference test's scenario (tests/test_checkpoint_btm.py:
# 88-127) at full width, 2 of 32 layers
BTM_LAYERS, BTM_BRANCHES, BTM_MERGE_EVERY = 2, 3, 2
BTM_BATCH, BTM_SEQ = 4, 512
# B9's gradient against its plain version (fp32 sums in other orders;
# the plain's dP - Dd in float64; each output rounded once): fp32 within
# 1e-5 + 1e-4 |plain|; bf16 no element beyond one bf16 ulp of |plain| +
# 1e-4 max |plain|
# (equal fp32 values up to summation order, which near-zero entries,
# the small differences of large terms, carry in absolute terms)
FLASH_BWD_F32 = (1e-5, 1e-4)
FLASH_BWD_BF16_ATOL = 1e-4
# [gemma2]: Gemma-2 27B (configs/gemma2_27b.py) served at
# full width and depth in bf16: batch 2, a prompt of 8160 tokens (past
# the 4096-key window, so the local layers' mask binds) and 32 greedy
# tokens, max_len 8192 (its context); a model merged through two
# replicas at 2 of its 46 layers (1 period: a base and 2 contributions
# are 3 x 4.62 GB; at full depth they would be 3 x 54.45 GB; 2 rather
# than 4 keeps the script inside its time limit); B9 against its plain
# version at 2 layers (one local, one global)
GEMMA2 = "gemma2-27b"
G2_BATCH, G2_PROMPT, G2_GEN = 2, 8160, 32
G2_MERGE_LAYERS, G2_K, G2_PLAIN_LAYERS = 2, 2, 2
# [gemma2-train]: Gemma-2 27B trained at full width (fp32 parameters and
# AdamW moments, bf16 compute, each sub-layer under remat) at 1 of its 23
# periods (2 layers, a local and a global sub-layer: 2,312,151,552
# parameters, 37.0 GB of parameters, moments and gradients; 2 periods,
# 55.1 GB and a peak of 69.47 GB on an H100, until the [qwen3-moe] phase
# needed their time: the resume's checkpoint is 27.7 GB rather than
# 41.3), batch 2 x 8192 (its context, so the local layers' 4096-key
# window binds in the backward; at 4096 it would not) in microbatches of
# 1; 3 steps, the last traced; a checkpoint written after step 2 and
# restored, step 3 again
G2_TRAIN_PERIODS, G2_TRAIN_STEPS = 1, 3
G2_TRAIN_BATCH, G2_TRAIN_SEQ, G2_TRAIN_ACCUM = 2, 8192, 2
# [durable] journals and syncs the int8 payloads of 2 of Phi-3-mini's 32
# layers (4 before the [qwen3-moe] phase, all 32 before gemma2's, 16 in
# its first runs): it is host-bound, and the later phases need its time
# under the limit
DURABLE_LAYERS = 2
# [main] int8 merges the four int8 payloads at 8 of the 32 layers (all
# 32 before the [qwen3-moe] phase): its planning digests each payload's
# dequantized leaves on the host, 39 s of the script at full depth
INT8_LAYERS = 8
# [qwen3-moe]: Qwen3-MoE-30B-A3B (configs/qwen3_moe_30b_a3b.py) served at
# full width and depth in bf16 (30,532,110,336 parameters, 61.06 GB) at
# Phi-3-mini's serving shape: batch 4, a 4064-token prompt, 32 greedy
# tokens; a base and Q3_K contributions merged through two replicas at
# Q3_MERGE_LAYERS of its 48 layers (5 models at full depth would be 305
# GB); at Q3_PLAIN_LAYERS B9 against its plain version and the gather
# dispatch against the einsum one; and the int8 weight average of
# Q3_INT8_K contributions at Q3_INT8_LAYERS layers, where each stacked
# expert leaf holds 11 x 128 x 2048 x 768 = 2,214,592,512 elements,
# past 2^31 (a bf16 merge of 2 at that depth needs ~82 GB), each expert
# leaf held against `quant_nary_ref` on windows of Q3_WINDOW elements
QWEN3 = "qwen3-moe-30b-a3b"
Q3_MERGE_LAYERS, Q3_K, Q3_PLAIN_LAYERS = 2, 4, 2
Q3_INT8_LAYERS, Q3_INT8_K = 11, 2
Q3_WINDOW = 1 << 20
EXPERT_LEAVES = tuple(f"['blocks']['sub0']['ffn']['experts']['{w}']"
                      for w in ("w_down", "w_gate", "w_up"))
PERLEAF_MAX_DIFF_SHARE = {"slerp k=2": 0.103, "slerp k=4 fold": 0.705,
                          "slerp k=4 tree": 0.567, "slerp k=2 fp32": 0.0,
                          "slerp k=4 fold fp32": 0.0,
                          "slerp k=4 tree fp32": 0.0,
                          "ties quantile": 3.4e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, sleep: bool = True) -> float:
    """Median milliseconds of `fn()` over `reps` CUDA-event-timed runs,
    after one warm-up. With `sleep` the card sleeps ~1 ms ahead of each
    start event, so the host's enqueue time (a wrapper's Python, ~0.05
    ms for B9) falls inside the sleep and the interval is the card's;
    without it (the method up to PR 15) a call shorter than its host
    time reads as that host time."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if sleep:
            torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, ops) -> tuple:
    """(ms, "bytes" | "operations", bytes ms, operations ms): the larger
    of the bytes over the memory rate and the operations over their peak
    rate. `ops` counts fp32 operations, or is a pair (fp32, int32); the
    two pipes issue side by side, so the slower of the two bounds them."""
    fops, iops = ops if isinstance(ops, tuple) else (ops, 0.0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(fops / FP32_OPS_PER_S, iops / INT32_OPS_PER_S) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", t_bytes, t_ops
    return t_ops, "operations", t_bytes, t_ops


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
    """nvcc for every source at once (`build.build_all`, on a thread that
    waits for the compilers), while this thread compiles `flex_library`
    for B9's gemma2 rows (`flex_warm`)."""
    import threading
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = {}

    def run():
        try:
            built["logs"] = build.build_all()
        except BaseException as e:      # raised again on this thread
            built["error"] = e
    nvcc = threading.Thread(target=run)
    nvcc.start()
    try:
        flex_warm()
    finally:
        nvcc.join()
    if "error" in built:
        raise built["error"]
    logs = built["logs"]
    dt = time.perf_counter() - t0
    for src, text in sorted(logs.items()):
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        log(f"[build] {src}.cu: {len(regs)} kernels; "
            + " | ".join(r.split("ptxas info    : ")[-1] for r in regs))
    log(f"[build] nvcc for {sorted(logs)} in parallel: {dt:.1f} s")
    flash_instances(logs.get("flash_attention", ""))
    flash_bwd_instances(logs.get("flash_attention_bwd", ""))


def flex_warm() -> None:
    """Compiles `flex_library` at the shapes and dtypes of B9's gemma2
    rows (`phase_gemma2_flash_kernel`), one compile for each, on zeros;
    the [kernels] phase then reuses them."""
    from repro_torch.configs import get_config
    cfg = get_config(GEMMA2)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w, cap, scale = cfg.sliding_window, cfg.attn_softcap, cfg.query_scale
    t0 = time.perf_counter()

    def zeros(s, n, dtype=torch.bfloat16, b=G2_BATCH):
        return torch.zeros(b, s, n, d, dtype=dtype, device=DEVICE)
    for dtype in (torch.bfloat16, torch.float32):
        flex_library(zeros(G2_PROMPT, h, dtype), zeros(G2_PROMPT, hk, dtype),
                     zeros(G2_PROMPT, hk, dtype), 0, w, cap, scale)()
    for s, q_offset in ((w, w - 1), (G2_PROMPT + G2_GEN, G2_PROMPT)):
        flex_library(zeros(1, h), zeros(s, hk), zeros(s, hk), q_offset, 0,
                     cap, scale)()
    # the gradient's rows: [gemma2-train]'s microbatch, forward and
    # backward
    mb = G2_TRAIN_BATCH // G2_TRAIN_ACCUM
    for dtype in (torch.bfloat16, torch.float32):
        flex_grad_library(*(zeros(G2_TRAIN_SEQ, n, dtype, mb)
                            for n in (h, hk, hk, h)), w, cap, scale)()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[build] flex_attention compiled for B9's gemma2 rows beside nvcc "
        f"(4 forward shapes and dtypes, 2 of forward and backward): "
        f"{time.perf_counter() - t0:.1f} s")


def _instance(mangled: str) -> str:
    """`flash_kernel_decode<bf16, 96, 1>` or `bwd_dkdv_mma<96>` from a
    mangled kernel name."""
    import re
    m = re.search(r"(flash_kernel(?:_mma|_decode)?|bwd_(?:dkdv|dq|dot)"
                  r"(?:_mma)?)I(.*?)EEv", mangled)
    if m is None:
        return mangled[:60]
    args = [{"t": "bf16", "f": "fp32"}.get(a, n) for a, n in
            re.findall(r"(t|f)|Li(\d+)E", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_info(log_text: str) -> dict:
    """{instance: {"regs": ..., "spill": ...}} from a `-Xptxas=-v` log."""
    cur, info = None, {}
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            cur = _instance(ln.split("'")[1])
        elif cur and "spill" in ln:
            info.setdefault(cur, {})["spill"] = ln.split(":")[-1].strip()
        elif cur and "registers" in ln:
            info.setdefault(cur, {})["regs"] = ln.split(":")[-1].strip()
    return info


def hmma_counts(lib: str) -> dict:
    """{instance: bf16 tensor-core (HMMA) instructions} in the SASS of
    the library `lib` (`cuobjdump -sass`)."""
    import re
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build._lib_path(lib))],
                          capture_output=True, text=True,
                          check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = _instance(ln.split("Function :")[1].strip())
        elif cur and re.search(r"\bHMMA\.16816\.F32\.BF16\b", ln):
            counts[cur] = counts.get(cur, 0) + 1
    return counts


def flash_instances(log_text: str) -> None:
    """B9's instances: ptxas registers, spills and static shared memory,
    the dynamic shared memory each launch asks for, and the tensor-core
    (HMMA) instructions in the SASS of the bf16 prefill instances."""
    from repro_torch.kernels import build
    smem = build.function("flash_attention_smem")
    info = ptxas_info(log_text)
    if not info:
        log("[build] flash_attention.cu was built earlier: no ptxas report")
    for name in sorted(info):
        kind, args = name.split("<")[0], name[:-1].split("<")[1].split(", ")
        if kind in ("flash_kernel_mma", "flash_kernel"):   # bf16, fp32
            dyn = smem(0, kind == "flash_kernel_mma", int(args[0]), 0)
        else:
            dyn = smem(1, args[0] == "bf16", int(args[1]), int(args[2]))
        log(f"[build] B9 {name}: {info[name].get('regs', '?')}; "
            f"{info[name].get('spill', '?')}; {dyn} bytes dynamic smem")
    counts = hmma_counts("flash_attention")
    for d in (16, 32, 64, 96, 128):
        name = f"flash_kernel_mma<{d}>"
        # per 64-key tile: Q K^T D/16 k-steps x 8 key tiles, P . V 4
        # k-steps x D/8 dim tiles x 3 terms of P
        qk, pv = d // 16 * 8, 4 * (d // 8) * 3
        log(f"[build] B9 {name} SASS: {counts.get(name, 0)} "
            f"HMMA.16816.F32.BF16 (a fully unrolled tile: Q.K^T {qk} + "
            f"P.V {pv})")
        if not counts.get(name):
            raise AssertionError(f"{name} has no tensor-core instruction")


def flash_bwd_instances(log_text: str) -> None:
    """B9's gradient, as `flash_instances`: every instance's ptxas
    registers and spills and its dynamic shared memory; the HMMA count
    of each bf16 instance (`bwd_dkdv_mma`, `bwd_dq_mma`), which must not
    be 0."""
    from repro_torch.kernels import build
    smem = build.function("flash_attention_bwd_smem")
    info = ptxas_info(log_text)
    if not info:
        log("[build] flash_attention_bwd.cu was built earlier: no ptxas "
            "report")
    for name in sorted(info):
        kind, args = name.split("<")[0], name[:-1].split("<")[1].split(", ")
        part = {"bwd_dkdv": 0, "bwd_dq": 1}.get(kind.replace("_mma", ""))
        dyn = 0 if part is None else smem(part, kind.endswith("_mma"),
                                          int(args[-1]))
        log(f"[build] B9 bwd {name}: {info[name].get('regs', '?')}; "
            f"{info[name].get('spill', '?')}; {dyn} bytes dynamic smem")
    counts = hmma_counts("flash_attention_bwd")
    for d in (16, 64, 96, 128):
        for kind in ("bwd_dkdv_mma", "bwd_dq_mma"):
            name = f"{kind}<{d}>"
            # one step of C columns (the step loop is not unrolled; C
            # as `dkdv_cols` / `kDqCols` in the source): S and dP D/16
            # k-steps x C/8 column tiles each, then C/16 k-steps x D/8
            # dim tiles x 3 terms, for dV and dK, or for dQ
            dkdv = kind == "bwd_dkdv_mma"
            c = 16 if dkdv and d >= 96 else 32
            sp = 2 * (d // 16) * (c // 8)
            acc = (c // 16) * (d // 8) * 3 * (2 if dkdv else 1)
            log(f"[build] B9 bwd {name} SASS: {counts.get(name, 0)} "
                f"HMMA.16816.F32.BF16 (a step of {c} columns: S and dP "
                f"{sp} + {'dV and dK' if dkdv else 'dQ'} {acc})")
            if not counts.get(name):
                raise AssertionError(f"{name} has no tensor-core "
                                     "instruction")


def main_path_lengths(cfg, itemsize: int = 2, k: int = K) -> list:
    """Leaf lengths of the largest fused batch of k contributions the
    engine dispatches for this model, from the engine's own packing
    rule, with every contribution priced at `itemsize` bytes per element
    (2: bf16; 1: int8 payloads). k = K: the dense plan; k = K + 1: the
    sparse path's plan, where the adapter update covers the attention
    leaves (k_i = K + 1 there, K elsewhere)."""
    from repro_torch.core.engine import _dispatch_groups, LeafTask
    from repro_torch.models.model import Model
    from repro_torch.models.schema import schema_leaves
    from repro_torch.strategies import get_strategy
    tasks = []
    for i, (path, pdef) in enumerate(schema_leaves(Model(cfg).schema())):
        n = 1
        for d in pdef.shape:
            n *= d
        ki = K + 1 if k > K and path in SPARSE_LEAVES else K
        tasks.append(LeafTask(index=i, path=path, sub_root=b"",
                              shape=pdef.shape, dtype=torch.bfloat16,
                              stacked_nbytes=ki * n * itemsize,
                              contributors=tuple(range(ki))))
    groups = _dispatch_groups(get_strategy("weight_average"), tasks,
                              max(t.stacked_nbytes for t in tasks))
    big = max((g for g in groups if len(g) > 1 and g[0].k == k),
              key=lambda g: sum(t.stacked_nbytes for t in g))
    return [t.stacked_nbytes // (k * itemsize) for t in big]


def hold_and_time(rows: dict, name: str, kern, plain, nbytes: float,
                  ops, src: str, replaces: str, library=None,
                  library_note: str = "", into: str = "") -> None:
    """One kernel against its plain version (bitwise), then timed: median
    of 10 CUDA-event-timed launches, the plain version's of 3, and the
    one PyTorch call computing the same function (`library`), where
    there is one, of 10; else `library_note` says why there is none.
    `into` files the numbers under that key of the kernel's row (a
    second shape of the same kernel) instead of making the row."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    if got.dtype.is_floating_point:
        err = float((got - want).abs().max())
    else:
        err = float((got.to(torch.int64) - want.to(torch.int64))
                    .abs().max())
    if not same:
        raise AssertionError(f"{name}: kernel != plain version "
                             f"(max abs err {err})")
    del got, want
    ms = cuda_ms(kern, 10)
    plain_ms = cuda_ms(plain, 3)
    lib_ms = cuda_ms(library, 10) if library is not None else None
    bms, by, t_bytes, t_ops = bound_ms(nbytes, ops)
    row = {"name": name, "route": "cuda", "source": src,
           "replaces": replaces, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": lib_ms}
    if library is None:
        row["library_note"] = library_note
    if into:
        rows[name][into] = {k: row[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
    else:
        rows[name] = row
    log(f"[kernels] {name}{f' ({into})' if into else ''}: bitwise equal "
        f"to plain; {ms:.3f} ms "
        f"(bound {bms:.3f} ms by {by}: {nbytes / 1e9:.2f} GB in "
        f"{t_bytes:.3f} ms, operations {t_ops:.3f} ms; "
        f"{nbytes / ms / 1e6:.0f} GB/s); plain "
        f"{plain_ms:.2f} ms; library "
        + (f"{lib_ms:.3f} ms" if lib_ms is not None else
           f"none ({library_note})"))


def merge_batch(cfg, k: int, g) -> dict:
    """One fused bf16 batch of k rows at the engine's largest batch of k
    contributions (`main_path_lengths`), with the per-tile metadata B1
    and B3-B6 take, and the linear-family and histogram-TIES cases:
    name -> (kernel, plain version, bytes, operations, source, the TPU
    kernel it replaces), plus B1's library call."""
    from repro_torch.kernels import histogram as H
    from repro_torch.kernels import nary_accum as N
    from repro_torch.kernels.config import kernel_env
    dev = torch.device(DEVICE)
    block, bins = kernel_env.block, kernel_env.hist_bins
    lengths = main_path_lengths(cfg, k=k)
    leaf_id, valid, npad = H.batch_layout(lengths, block)
    nb = len(leaf_id)
    x = (torch.randn((k, npad), generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    base = torch.randn((npad,), generator=g, device=dev) * 0.02
    w = torch.full((k,), 1.0 / k, device=dev)
    log(f"[kernels] bf16 batch of {len(lengths)} leaves {lengths}: "
        f"stacked [{k}, {npad}] bf16, {nb} tiles of {block}")
    lid = torch.tensor(leaf_id, device=dev)
    vld = torch.tensor(valid, dtype=torch.int32, device=dev)
    bmax = H.block_amax_plain(x, base, block)
    amax_meta = (torch.stack([bmax[lid == j].amax(dim=0)
                              for j in range(len(lengths))])[lid]
                 + 1e-12).contiguous()
    del bmax
    thr_meta = (amax_meta * 0.3).contiguous()
    xe = k * npad * 2                       # stacked bytes (bf16)
    # B1's library call: one addmm over an fp32 copy of the stack,
    # base * (1 - sum w) + w @ x = base + sum_i w_i (x_i - base) (cuBLAS
    # takes no bf16 rows into an fp32 result)
    b = {"x": x, "base": base, "w": w, "lengths": lengths, "npad": npad,
         "nb": nb, "block": block, "xf": x.to(torch.float32),
         "beta": 1.0 - float(w.sum())}
    b["library"] = {"nary_accum": lambda: torch.addmm(
        base, w[None], b["xf"], beta=b["beta"])}
    b["cases"] = {
        "nary_accum": (lambda: N.nary_accum(x, base, w),
                       lambda: N.nary_accum_plain(x, base, w),
                       xe + npad * 4 * 2 + k * 4, 3 * k * npad + npad,
                       "src/repro_torch/csrc/nary_accum.cu",
                       "src/repro/kernels/nary_accum.py:35"),
        "block_amax": (lambda: H.block_amax(x, base, block),
                       lambda: H.block_amax_plain(x, base, block),
                       xe + npad * 4 + nb * k * 4, 3 * k * npad,
                       "src/repro_torch/csrc/histogram.cu",
                       "src/repro/kernels/histogram.py:99"),
        "block_hist": (lambda: H.block_hist(x, base, amax_meta, vld, bins,
                                            block),
                       lambda: H.block_hist_plain(x, base, amax_meta, vld,
                                                  bins, block),
                       xe + npad * 4 + nb * k * 4 + nb * 4
                       + nb * k * bins * 4, 6 * k * npad,
                       "src/repro_torch/csrc/histogram.cu",
                       "src/repro/kernels/histogram.py:118"),
        "ties_block": (lambda: H.ties_block(x, base, thr_meta, block),
                       lambda: H.ties_block_plain(x, base, thr_meta, block),
                       xe + npad * 4 * 2 + nb * k * 4, 12 * k * npad,
                       "src/repro_torch/csrc/histogram.cu",
                       "src/repro/kernels/histogram.py:141"),
    }
    return b


def hold_batch(rows: dict, b: dict, into: str = "") -> None:
    for name, (kern, plain, nbytes, ops, src, replaces) in \
            b["cases"].items():
        hold_and_time(rows, name, kern, plain, nbytes, ops, src, replaces,
                      library=b["library"].get(name),
                      library_note=NO_LIBRARY.get(name, ""), into=into)


def phase_kernels(cfg) -> dict:
    """Each kernel against its plain version on one fused batch of the
    main path: bf16 rows for B1, B3-B6 (as the engine dispatches them),
    int8 rows for B2; B1 and B3-B5 also on the sparse path's batch of
    K + 1 rows (the attention leaves the adapter update covers)."""
    from repro_torch.kernels import dare as D
    from repro_torch.kernels import histogram as H
    from repro_torch.kernels import quant as Q
    from repro_torch.kernels.common import padded_len
    from repro_torch.kernels.config import kernel_env
    dev = torch.device(DEVICE)
    block, bins = kernel_env.block, kernel_env.hist_bins
    g = torch.Generator(device=dev).manual_seed(SEED + 100)
    b = merge_batch(cfg, K, g)
    x, base, w, lengths = b["x"], b["base"], b["w"], b["lengths"]
    npad, nb = b["npad"], b["nb"]
    # (leaf seed, leaf padded length, start column) per tile, as the
    # engine builds them; seeds near the uint32 wrap
    dmeta = torch.cat([D.leaf_meta(2 ** 32 - 1 - j, padded_len(n, block),
                                   block, device=dev)
                       for j, n in enumerate(lengths)])
    # per stacked element: the hash (~17 int32 ops: index, 3 multiplies,
    # 3 shifts, 4 xors, convert, scale, compare) and 4 fp32 ops (sub, 2
    # mul, add); per column a multiply and an add
    b["cases"]["dare_block"] = (
        lambda: D.dare_block(x, base, dmeta, DARE_P, block),
        lambda: D.dare_block_plain(x, base, dmeta, DARE_P, block),
        K * npad * 2 + npad * 4 * 2 + nb * 3 * 4,
        (4 * K * npad + 2 * npad, 17 * K * npad),
        "src/repro_torch/csrc/dare.cu", "src/repro/kernels/dare.py:45")
    rows: dict = {}
    hold_batch(rows, b)
    b.clear()
    # B3 keeps a NaN, as jnp.max does (fmaxf alone would drop it)
    xn = torch.zeros((K, 2 * block), dtype=torch.bfloat16, device=dev)
    xn[2, block + 7] = float("nan")
    got = H.block_amax(xn, torch.zeros(2 * block, device=dev), block)
    if not (bool(torch.isnan(got[1, 2])) and int(torch.isnan(got).sum()) == 1):
        raise AssertionError("block_amax dropped or spread a NaN")
    log("[kernels] block_amax propagates a NaN to its tile only")
    # B4's launch plan at this shape: the CUDA source's and `hist_plan`'s
    import ctypes
    from repro_torch.kernels import build
    plan = (ctypes.c_int * 3)()
    build.check(build.function("block_hist_plan")(
        K, bins, ctypes.addressof(plan)), "block_hist_plan")
    if tuple(plan) != H.hist_plan(K, bins):
        raise AssertionError(f"block_hist plan {tuple(plan)} != hist_plan "
                             f"{H.hist_plan(K, bins)}")
    log(f"[kernels] block_hist plan at k = {K}, {bins} bins: {plan[0]} "
        f"warps (one tile each) a block, {plan[1]} contributions a pass, "
        f"{plan[2]} bytes of shared memory")
    # B6 keeps each element with probability 1 - p: with every tau = 1
    # and base 0, out = (kept rows) * rescale / K exactly, so the kept
    # share is sum(out) / (npad * rescale)
    x.fill_(1.0)
    out = D.dare_block(x, torch.zeros_like(base), dmeta, DARE_P, block)
    kept = float(out.double().sum()) / (npad * D.rescale_of(DARE_P))
    if abs(kept - (1 - DARE_P)) > 1e-3:
        raise AssertionError(f"dare_block kept {kept:.6f}, expected "
                             f"{1 - DARE_P} within 1e-3")
    log(f"[kernels] dare_block kept share {kept:.6f} (1 - p = "
        f"{1 - DARE_P}; limit 1e-3)")
    del x, out
    torch.cuda.empty_cache()
    # the sparse path's k = K + 1 batch (two attention leaves)
    b = merge_batch(cfg, K + 1, g)
    hold_batch(rows, b, into=f"k{K + 1}")
    b.clear()
    torch.cuda.empty_cache()
    # B2 on the largest int8 batch (int8 pricing halves the cap and the
    # leaves alike)
    qlengths = main_path_lengths(cfg, itemsize=1)
    qleaf_id, _, qpad = H.batch_layout(qlengths, block)
    if qpad != npad:
        base = torch.randn((qpad,), generator=g, device=dev) * 0.02
    q = torch.randint(-127, 128, (K, qpad), generator=g, device=dev,
                      dtype=torch.int8)
    scales = torch.rand((len(qlengths), K), generator=g, device=dev) \
        * 1e-3 + 1e-5
    smeta = scales[torch.tensor(qleaf_id, device=dev)].contiguous()
    log(f"[kernels] int8 batch of {len(qlengths)} leaves {qlengths}: "
        f"stacked [{K}, {qpad}] int8")
    hold_and_time(rows, "quant_nary",
                  lambda: Q.quant_nary(q, base, smeta, w, block),
                  lambda: Q.quant_nary_plain(q, base, smeta, w, block),
                  K * qpad + qpad * 4 * 2 + smeta.numel() * 4 + K * 4,
                  4 * K * qpad + qpad, "src/repro_torch/csrc/quant.cu",
                  "src/repro/kernels/quant.py:36",
                  library_note=NO_LIBRARY["quant_nary"])
    del q, base, smeta
    torch.cuda.empty_cache()
    phase_perleaf_kernels(rows, g)
    phase_flash_kernel(rows, cfg, g)
    phase_gemma2_flash_kernel(rows, g)
    phase_qwen3_flash_kernel(rows, g)
    phase_qwen3_quant_kernel(rows, g)
    phase_flash_backward(rows, cfg, g)
    phase_gemma2_flash_backward(rows, g)
    return rows


def phase_perleaf_kernels(rows: dict, g) -> None:
    """B7 and B8 against their plain versions at the per-leaf path's
    largest leaf, an FFN weight of 32 x 3072 x 8192 = 805,306,368
    elements (a multiple of the tile, so no padding): B7 on K bf16 rows
    and on K + 1, B8 on two. B8's library calls take an fp32 copy of the
    two rows (cuBLAS takes no bf16 rows into fp32 sums): the three dot
    products as `X @ X.T`, the combine as `c @ X`."""
    from repro_torch.kernels import slerp as S
    from repro_torch.kernels import ties as T
    from repro_torch.kernels.config import kernel_env
    dev = torch.device(DEVICE)
    block = kernel_env.block
    n = FFN_LEAF
    x = (torch.randn((K, n), generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    base = torch.randn((n,), generator=g, device=dev) * 0.02
    thr = torch.rand((K,), generator=g, device=dev) * 0.01
    nb = n // block
    log(f"[kernels] per-leaf FFN leaf: [{K}, {n}] bf16 rows")
    # per stacked element: sub, abs, compare, mul, add; then sign,
    # compare, add, mul, add; per column a division, a max and an add
    hold_and_time(rows, "ties_leaf",
                  lambda: T.ties_leaf(x, base, thr, block),
                  lambda: T.ties_leaf_plain(x, base, thr, block),
                  K * n * 2 + n * 4 * 2 + K * 4, 10 * K * n + 3 * n,
                  "src/repro_torch/csrc/ties.cu",
                  "src/repro/kernels/ties.py:44",
                  library_note=NO_LIBRARY["ties_leaf"])
    u, v = x[0], x[1]
    c = torch.tensor([0.6, 0.4], device=dev)
    xf = torch.stack([u, v]).to(torch.float32)
    hold_and_time(rows, "slerp_reduce",
                  lambda: S.slerp_reduce(u, v, block),
                  lambda: S.slerp_reduce_plain(u, v, block),
                  2 * n * 2 + nb * 3 * 4, 6 * n,
                  "src/repro_torch/csrc/slerp.cu",
                  "src/repro/kernels/slerp.py:36",
                  library=lambda: torch.mm(xf, xf.T))
    hold_and_time(rows, "slerp_combine",
                  lambda: S.slerp_combine(u, v, c, block),
                  lambda: S.slerp_combine_plain(u, v, c, block),
                  2 * n * 2 + n * 4 + 2 * 4, 3 * n,
                  "src/repro_torch/csrc/slerp.cu",
                  "src/repro/kernels/slerp.py:36",
                  library=lambda: torch.mm(c.view(1, 2), xf))
    del x, xf, u, v
    torch.cuda.empty_cache()
    # B7 at the sparse path's height, K + 1 rows (a reading: the same
    # kernel and dispatch)
    x = (torch.randn((K + 1, n), generator=g, device=dev) * 0.02).to(
        torch.bfloat16)
    thr = torch.rand((K + 1,), generator=g, device=dev) * 0.01
    hold_and_time(rows, "ties_leaf",
                  lambda: T.ties_leaf(x, base, thr, block),
                  lambda: T.ties_leaf_plain(x, base, thr, block),
                  (K + 1) * n * 2 + n * 4 * 2 + (K + 1) * 4,
                  10 * (K + 1) * n + 3 * n,
                  "src/repro_torch/csrc/ties.cu",
                  "src/repro/kernels/ties.py:44",
                  library_note=NO_LIBRARY["ties_leaf"], into=f"k{K + 1}")
    del x, base
    torch.cuda.empty_cache()


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as integers, for byte-identity checks."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def flash_case(q, k, v, q_offset: int, window: int = 0,
               softcap: float = 0.0, scale: float = 0.0,
               floor: float = FLASH_BF16_FLOOR["phi3"]) -> dict:
    """B9 at one shape (causal, with gemma2's `window` and `softcap`
    where given): held against its plain version (FLASH_F32_ATOL, or one
    bf16 ulp + `floor`), then timed, the kernel and the library call
    over 10 CUDA-event-timed calls, the plain version over 3. The
    library call, on [B, H, S, D] copies: `scaled_dot_product_attention`
    over the visible keys, or with a softcap or window `flex_attention`
    (`flex_library`). Bound: the operations of the (query, key) pairs
    each row sees (4 D flops a pair) and the bytes of q, the output and
    the keys some row sees, at the peak rate of q's type."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        DECODE_ROWS, flash_attention, flash_attention_plain, visible_keys)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    kw = dict(q_offset=q_offset, window=window, softcap=softcap,
              scale=scale)

    def kern():
        return flash_attention(q, k, v, **kw)

    def plain():
        return flash_attention_plain(q, k, v, **kw)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    if q.dtype == torch.float32:
        ok = max_err <= FLASH_F32_ATOL
        rule = f"max abs err <= {FLASH_F32_ATOL}"
    else:
        beyond = int((err > 2.0 ** -7 * want.float().abs() + floor).sum())
        ok = beyond == 0
        rule = f"{beyond} elements beyond one bf16 ulp + {floor:g}"
    if not ok:
        raise AssertionError(f"flash_attention {tuple(q.shape)} {q.dtype}: "
                             f"kernel vs plain outside tolerance ({rule}, "
                             f"max abs err {max_err:.3e})")
    del got, err
    kbeg, kmax = visible_keys(sq, sk, True, q_offset, window)
    pairs = sum(min(sk, q_offset + i + 1)
                - (max(0, q_offset + i - window + 1) if window else 0)
                for i in range(sq))
    ops = 4.0 * d * b * h * pairs
    nbytes = (2 * b * sq * h * d + 2 * b * (kmax - kbeg) * hk * d) \
        * q.element_size()
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    out = {"max_abs_err": max_err, "ms": cuda_ms(kern, 10),
           "plain_ms": cuda_ms(plain, 3), "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "rule": rule}
    if softcap or window:
        library = flex_library(q, k, v, q_offset, window, softcap, scale)
        lib_err = float((library().transpose(1, 2).float()
                         - want.float()).abs().max())
        out["library_ms"] = cuda_ms(library, 10)
        lib = (f"(flex_attention) {out['library_ms']:.3f} ms, max abs "
               f"diff from plain {lib_err:.3e}")
    else:
        qt, kt, vt = (x.transpose(1, 2).contiguous()
                      for x in (q, k[:, :kmax], v[:, :kmax]))
        causal = sq > 1

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale or None,
                enable_gqa=h != hk)

        out["library_ms"] = cuda_ms(library, 10)
        lib = f"(sdpa) {out['library_ms']:.3f} ms"
        del qt, kt, vt
    del want
    design = ("decode design" if sq <= DECODE_ROWS else
              "prefill on the tensor cores" if q.dtype == torch.bfloat16
              else "prefill, scalar fp32 instance")
    log(f"[kernels] flash_attention ({design}) q {list(q.shape)} k/v "
        f"{list(k.shape)} {str(q.dtype)[6:]}, q_offset {q_offset}, window "
        f"{window}, softcap {softcap}: {rule}, max abs err "
        f"{max_err:.3e}; {out['ms']:.3f} ms (bound {out['bound_ms']:.3f} ms "
        f"by {out['bound_by']}: {pairs} visible pairs, {ops:.3e} flops in "
        f"{t_ops:.3f} ms, {nbytes / 1e9:.3f} GB in {t_bytes:.3f} ms); plain "
        f"{out['plain_ms']:.2f} ms; library {lib}")
    return out


_FLEX = None
# flex_library's mask parameters: 0-d tensors that the compiled call
# takes as inputs, so the local and global rows of one shape and dtype
# share one compile (a Python int would be baked into each graph)
_FLEX_QOFF = _FLEX_WIN = None
_FLEX_CAP = 0.0


def _flex_mask(b, h, qi, ki):
    qpos = qi + _FLEX_QOFF
    return (ki <= qpos) & (qpos - ki < _FLEX_WIN)


def _flex_softcap(s, b, h, qi, ki):
    return _FLEX_CAP * torch.tanh(s / _FLEX_CAP)


def flex_library(q, k, v, q_offset: int, window: int, softcap: float,
                 scale: float, grad: bool = False):
    """The library call for B9 with a softcap or a window: one call of
    `torch.compile(flex_attention)` on [B, H, S, D] copies of q, k and
    v, with `softcap * tanh(s / softcap)` as its score_mod and B9's
    mask (k <= q_offset + q, q_offset + q - k < window) as its block
    mask, compiled here on the first call at each shape and dtype (with
    `grad`, the copies require grad, and the backward compiles at its
    first call). For timing only: the port never calls it."""
    from torch.nn.attention.flex_attention import (
        create_block_mask, flex_attention)
    global _FLEX, _FLEX_QOFF, _FLEX_WIN, _FLEX_CAP
    if _FLEX is None:
        # compile in this process: no pool of workers outlives the script
        torch._inductor.config.compile_threads = 1
        _FLEX = torch.compile(flex_attention, dynamic=False)
        _FLEX_QOFF = torch.zeros((), dtype=torch.int32, device=q.device)
        _FLEX_WIN = torch.zeros((), dtype=torch.int32, device=q.device)
    _FLEX_QOFF.fill_(q_offset)
    _FLEX_WIN.fill_(window or 2 ** 30)
    _FLEX_CAP = softcap
    sq, sk = q.shape[1], k.shape[1]
    block = create_block_mask(_flex_mask, None, None, sq, sk,
                              device=q.device)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(grad)
                  for x in (q, k, v))

    def call():
        return _FLEX(qt, kt, vt, score_mod=_flex_softcap if softcap
                     else None, block_mask=block, scale=scale or None,
                     enable_gqa=q.shape[2] != k.shape[2])
    call.inputs = (qt, kt, vt)
    return call


def flex_grad_library(q, k, v, dout, window: int, softcap: float,
                      scale: float):
    """The library call for B9's gradient with a softcap or a window:
    `torch.autograd.grad` through one `flex_library` call (q_offset 0)
    on [B, H, S, D] copies, its forward run once here and excluded from
    the thunk, as the SDPA backward's. For timing only."""
    call = flex_library(q, k, v, 0, window, softcap, scale, grad=True)
    out = call()
    gt = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, call.inputs, gt,
                                       retain_graph=True)


def flash_bwd_case(q, k, v, dout, window: int = 0, softcap: float = 0.0,
                   scale: float = 0.0) -> dict:
    """B9's gradient at one shape (q_offset 0, causal; with gemma2's
    `window` and `softcap` where given): the LSE forward held bitwise
    against the served forward, the backward against its plain version
    (FLASH_BWD_*), then timed, the kernel and the library call over 10
    CUDA-event-timed calls, the plain version over 3, and the gradient's
    three kernels apart (`kernel_split_ms`). The library call: the
    backward of `scaled_dot_product_attention`, or with a softcap or
    window of `flex_attention` (`flex_grad_library`), through
    `torch.autograd.grad` over [B, H, S, D] copies, forward excluded.
    Bound: five matrix products over the visible pairs (S, dP, dV, dK,
    dQ: 2 D flops a pair each) at the peak rate of q's type, against
    each input (q, k, v, o, dO, the LSE) read and each output (dq, dk,
    dv) written once."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
        flash_attention_backward_plain, flash_attention_lse)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    # the options only where given, so the case also runs an older
    # checkout's wrappers (tools/b9bwd_time.py --root)
    kw = dict(scale=scale, **({"window": window} if window else {}),
              **({"softcap": softcap} if softcap else {}))
    out, lse = flash_attention_lse(q, k, v, **kw)
    if not torch.equal(bits(out), bits(flash_attention(q, k, v, **kw))):
        raise AssertionError("B9's LSE forward differs from the served "
                             "forward")

    def kern():
        return flash_attention_backward(q, k, v, out, lse, dout, **kw)

    def plain():
        return flash_attention_backward_plain(q, k, v, out, lse, dout, **kw)

    got, want = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    if not all(torch.equal(bits(x), bits(y)) for x, y in zip(got, again)):
        raise AssertionError("B9's backward: two launches differ")
    max_err, beyond = 0.0, 0
    for x, y in zip(got, want):
        x, y = x.float(), y.float()
        err = (x - y).abs()
        max_err = max(max_err, float(err.max()))
        if q.dtype == torch.float32:
            lim = FLASH_BWD_F32[0] + FLASH_BWD_F32[1] * y.abs()
        else:
            lim = 2.0 ** -7 * y.abs() + FLASH_BWD_BF16_ATOL \
                * float(y.abs().max())
        beyond += int((err > lim).sum())
    rule = (f"{beyond} elements beyond "
            + ("1e-5 + 1e-4 |plain|" if q.dtype == torch.float32 else
               "one bf16 ulp + 1e-4 max |plain|"))
    if beyond:
        raise AssertionError(f"flash_attention_backward {tuple(q.shape)} "
                             f"{q.dtype}: kernel vs plain outside "
                             f"tolerance ({rule}, max abs err {max_err:.3e})")
    del got, want, again
    pairs = sum(min(sk, i + 1) - (max(0, i - window + 1) if window else 0)
                for i in range(sq))
    ops = 5 * 2.0 * d * b * h * pairs
    nbytes = ((3 * b * sq * h * d + 2 * b * sk * hk * d) * q.element_size()
              + b * h * sq * 4 + (b * sq * h * d + 2 * b * sk * hk * d)
              * q.element_size())
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    if window or softcap:
        library = flex_grad_library(q, k, v, dout, window, softcap, scale)
        lib_name = "flex_attention backward"
    else:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            scale=scale or None,
                                            enable_gqa=h != hk)
        gt = dout.transpose(1, 2)

        def library():
            return torch.autograd.grad(ot, (qt, kt, vt), gt,
                                       retain_graph=True)
        lib_name = "sdpa backward"
    res = {"max_abs_err": max_err, "ms": cuda_ms(kern, 10),
           "plain_ms": cuda_ms(plain, 3), "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": cuda_ms(library, 10), "rule": rule,
           "split_ms": kernel_split_ms(kern, BWD_KERNELS)}
    del library
    split = ", ".join(f"{k} {'not measured' if t is None else f'{t:.3f}'}"
                      for k, t in res["split_ms"].items())
    log(f"[kernels] flash_attention_backward q [{b}, {sq}, {h}, {d}], k, v "
        f"[{b}, {sk}, {hk}, {d}] {str(q.dtype)[6:]}, causal, window "
        f"{window}, softcap {softcap}: {rule}, max abs err {max_err:.3e}; "
        f"{res['ms']:.3f} ms (bound {res['bound_ms']:.3f} ms by "
        f"{res['bound_by']}: {pairs} visible pairs, {ops:.3e} flops in "
        f"{t_ops:.3f} ms, {nbytes / 1e9:.3f} GB in {t_bytes:.3f} ms; "
        f"kernels traced: {split} ms); plain {res['plain_ms']:.2f} ms; "
        f"library ({lib_name}) {res['library_ms']:.3f} ms")
    return res


# B9's gradient's three kernels, by the part of their names that both
# designs share (bf16 `bwd_dkdv_mma`, fp32 `bwd_dkdv`, ...)
BWD_KERNELS = ("bwd_dot", "bwd_dkdv", "bwd_dq")


def kernel_split_ms(fn, names, reps: int = 10) -> dict:
    """Median device milliseconds of each kernel of `fn()` whose name
    holds one of `names`, over `reps` calls traced by `torch.profiler`
    (device activity only) after one warm-up; None where the profiler
    recorded none (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
    times: dict = {n: [] for n in names}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        for n in names:
            if n in ev.name:
                times[n].append(ev.time_range.elapsed_us() / 1e3)
                break
    return {n: sorted(t)[len(t) // 2] if t else None
            for n, t in times.items()}


def phase_flash_backward(rows: dict, cfg, g) -> None:
    """B9's gradient at the train step's shape: q, k, v, dO [2, 4096, 32,
    96] (a microbatch of TRAIN_4K), bf16 as the training forward runs it
    and fp32 (its second instance)."""
    dev = torch.device(DEVICE)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mb = TRAIN_BATCH // TRAIN_ACCUM
    cases = {}
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        x = [torch.randn((mb, TRAIN_SEQ, n, d), generator=g,
                         device=dev).to(dtype) for n in (h, hk, hk, h)]
        cases[label] = flash_bwd_case(*x)
        del x
    torch.cuda.empty_cache()
    main = cases.pop("bf16")
    rows["flash_attention_backward"] = {
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cuh",
        "replaces": "none: XLA's autodiff of "
                    "src/repro/models/layers.py:149",
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "split_ms": main["split_ms"],
        "shape": f"q, k, v, dO [{mb}, {TRAIN_SEQ}, {h}, {d}] bf16, causal; "
                 f"tolerance: {main['rule']}",
        "library": "torch.autograd.grad of "
                   "torch.nn.functional.scaled_dot_product_attention; "
                   "gemma2 rows: of torch.compile(flex_attention) with a "
                   "tanh score_mod and B9's mask as a block mask",
        "note": "B9's gradient (dQ, dK, dV): bf16 on the tensor cores "
                "(mma.sync, P and dS in three bf16 terms), fp32 on the "
                "scalar pipes; the reference's Pallas B9 has none: its "
                "model trains through XLA's autodiff of chunked_attention "
                "(src/repro/models/layers.py:149)",
        **cases}


def phase_gemma2_flash_backward(rows: dict, g) -> None:
    """B9's gradient at [gemma2-train]'s microbatch: q, dO [1, 8192, 32,
    128], k, v [1, 8192, 16, 128] with softcap 50 and scale 144^-0.5,
    bf16 (as training runs it) and fp32, on a local layer (window 4096:
    the query tiles past a key tile's window are skipped) and a global
    one, each held against the plain backward (FLASH_BWD_*) and timed
    beside `flex_attention`'s backward."""
    from repro_torch.configs import get_config
    cfg = get_config(GEMMA2)
    dev = torch.device(DEVICE)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w, cap, scale = cfg.sliding_window, cfg.attn_softcap, cfg.query_scale
    mb = G2_TRAIN_BATCH // G2_TRAIN_ACCUM
    cases = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        x = [torch.randn((mb, G2_TRAIN_SEQ, n, d), generator=g,
                         device=dev).to(dtype) for n in (h, hk, hk, h)]
        for layer, window in (("local", w), ("global", 0)):
            cases[f"gemma2 {layer} {tag}"] = flash_bwd_case(
                *x, window=window, softcap=cap, scale=scale)
        del x
        torch.cuda.empty_cache()
    rows["flash_attention_backward"].update(cases)


def phase_flash_kernel(rows: dict, cfg, g) -> None:
    """B9 against its plain version at the serving path's shapes: the
    prefill's q, k, v [4, 4064, 32, 96] (causal; bf16 on the tensor
    cores, and fp32 on the scalar instance), and a decode step's q
    [4, 1, 32, 96] against a [4, 4096, 32, 96] cache at q_offset 4063
    (the decode design, its key chunks printed)."""
    from repro_torch.kernels.flash_attention import decode_splits
    dev = torch.device(DEVICE)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    max_len = SERVE_PROMPT + SERVE_GEN

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = {}
    for label, dtype in (("prefill", torch.bfloat16),
                         ("fp32", torch.float32)):
        qkv = [randn(SERVE_BATCH, SERVE_PROMPT, n, d, dtype=dtype)
               for n in (h, hk, hk)]
        cases[label] = flash_case(*qkv, 0)
        del qkv
    q = randn(SERVE_BATCH, 1, h, d, dtype=torch.bfloat16)
    kv = [randn(SERVE_BATCH, max_len, hk, d, dtype=torch.bfloat16)
          for _ in range(2)]
    splits, chunk = decode_splits(SERVE_BATCH, hk, SERVE_PROMPT, d)
    log(f"[kernels] flash_attention decode design at the serving shape: "
        f"{splits} key chunks of {chunk} over {SERVE_PROMPT} visible keys, "
        f"{splits * SERVE_BATCH * hk} blocks")
    cases["decode"] = flash_case(q, *kv, SERVE_PROMPT - 1)
    cases["decode"]["splits"] = [splits, chunk]
    del q, kv
    torch.cuda.empty_cache()
    main = cases.pop("prefill")
    rows["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:79",
        "max_abs_err": main["max_abs_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "shape": f"prefill: q, k, v [{SERVE_BATCH}, {SERVE_PROMPT}, {h}, "
                 f"{d}] bf16, causal; tolerance: {main['rule']}",
        "library": "torch.nn.functional.scaled_dot_product_attention",
        **cases}


def make_models(cfg, device, dtype=torch.bfloat16, k: int = K):
    """A base and k contributions of the form base + small delta, from
    seeded generators on the device (bf16 unless `dtype` says)."""
    from repro_torch import pytree
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    schema = Model(cfg).schema()
    base = init_from_schema(schema, seed=SEED, device=device, dtype=dtype)
    contribs = []
    for j in range(k):
        delta = init_from_schema(schema, seed=SEED + 1 + j, device=device,
                                 dtype=dtype)
        contribs.append(pytree.tree_map(
            lambda b, d: b + d * 0.1, base, delta))
        del delta
    return base, contribs


# why no single PyTorch call computes these kernels' functions
NO_LIBRARY = {
    "block_amax": "no single torch call takes |x - base| per tile and "
                  "contribution",
    "block_hist": "no single torch call histograms |x - base| / amax per "
                  "tile and contribution",
    "ties_block": "no single torch call trims each tile at its own "
                  "thresholds and means the sign-agreeing entries",
    "dare_block": "torch has no counter-hash RNG call",
    "quant_nary": "no torch call dequantizes int8 rows with per-tile "
                  "scales and accumulates",
    "ties_leaf": "no torch call trims each row at its own threshold and "
                 "means the sign-agreeing entries",
}
FFN_LEAF = 32 * 3072 * 8192     # Phi-3-mini's largest leaf (w_up et al.)
STRATEGIES = (("weight_average", {}, False),
              ("task_arithmetic", {"lam": 1.0}, True),
              ("ties", {"trim": 0.2, "trim_method": "histogram"}, True))
QUANT_STRATEGIES = STRATEGIES[:2]
DARE_SPEC = ("dare", {"p": DARE_P}, True)
# the kernels each main path must launch
PATH_KERNELS = {"bf16": ("nary_accum", "block_amax", "block_hist",
                         "ties_block"),
                "dare": ("dare_block",),
                "perleaf": ("slerp_reduce", "slerp_combine", "ties_leaf",
                            "nary_accum"),
                "int8": ("quant_nary",),
                "search": (),
                "sparse": ("nary_accum", "block_amax", "block_hist",
                           "ties_block"),
                "gossip": (),
                "serve": ("flash_attention",),
                "gemma2": ("flash_attention",),
                "qwen3-moe": ("flash_attention",),
                "qwen3-moe merge": ("nary_accum", "block_amax",
                                    "block_hist", "ties_block"),
                "qwen3-moe int8": ("quant_nary",),
                "durable": ("quant_nary", "nary_accum")}
# the sparse path's adapter update: Phi-3-mini's four attention
# projections, 4 x 32 x 3072 x 3072 = 1,207,959,552 parameters
SPARSE_LEAVES = tuple(f"['blocks']['sub0']['attn']['{w}']"
                      for w in ("wk", "wo", "wq", "wv"))


def int8_eid(eid: str, layers: int = 0) -> str:
    """The element id of the int8 payload compressed from the fine-tune
    named `eid` (of its first `layers` layers, where given): a hex name
    derived from that content id. An int8 payload needs one
    (`Replica.contribute` asks for `element_id`), and the compression is
    deterministic, so every replica that compresses the same fine-tune
    derives the same name."""
    cut = f", first {layers} layers" if layers else ""
    return hashlib.sha256(f"int8 payload of {eid}{cut}".encode()).hexdigest()


def first_layers(tree, n: int):
    """The first n layers of a stacked model: every `blocks` leaf cut to
    [:n] and copied (so the full leaves can go), the rest as they are.
    An int8 `CompressedTree` keeps each leaf's scale (one a leaf), so
    the cut payload dequantizes to the cut of the full one."""
    from repro_torch import pytree
    from repro_torch.core.compression import CompressedLeaf, CompressedTree
    if isinstance(tree, CompressedTree):
        paths = pytree.leaf_paths(tree.treedef)
        return CompressedTree([
            CompressedLeaf(leaf.q[:n].clone(), leaf.scale,
                           (n,) + tuple(leaf.shape[1:]), leaf.dtype)
            if path.startswith("['blocks']") else leaf
            for path, leaf in zip(paths, tree.leaves)], tree.treedef)
    flat, treedef = pytree.flatten_with_path(tree)
    return treedef.unflatten([
        t[:n].clone() if pytree.keystr(path).startswith("['blocks']") else t
        for path, t in flat])


def sparse_eid(layers: int) -> str:
    """The update's element id (one per depth: an eid names one
    content). A pinned sort prefix puts it last in the canonical order
    (as benchmarks/bench_sparse.py pins its eids), so the re-resolve
    extends each attention leaf's cached fold by one contribution."""
    tag = f"sparse adapter update, {layers} layers".encode()
    return "ff" + hashlib.sha256(tag).hexdigest()[:62]


# the re-resolve's cache holds every leaf's output and fp32 fold
# accumulator: 3.82e9 parameters x (2 + 4) bytes, and S's four leaves
SPARSE_CACHE_BYTES = 40 * 10 ** 9
# the consortium: nodes, and each node's update under a fixed eid; 2 of
# Phi-3-mini's 32 layers (16 before the [durable] sync sessions came, 8
# before the [gemma2] phase) keep the script inside its time limit
CONSORTIUM = 8
CONSORTIUM_LAYERS = 2


def consortium_eid(i) -> str:
    return hashlib.sha256(f"consortium update {i}".encode()).hexdigest()


# the paper's Tables 6-9 at benchmarks/bench_gossip.py --full sizes,
# but for Table 6's orderings: 2 of its 20 (each ~8 s of host-bound
# resolves on 100 nodes) keep the script inside its time limit
T6_NODES, T6_SIDE, T6_ORDERINGS = 100, 512, 2
T7_NODES, T7_SIDE, T7_PARTS = 100, 64, 10
T8_NODES, T8_SIDE = 10, 64
T9_SIZES, T9_SIDE = (2, 5, 10, 20, 30, 50), 64


def sparse_update(cfg, base, seed: int) -> dict:
    """An adapter update of the attention leaves by `make_models`'
    recipe: base + 0.1 x a delta drawn as the schema initialises those
    leaves from `seed`, in bf16 on the device."""
    from repro_torch import pytree
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    attn = Model(cfg).schema()["blocks"]["sub0"]["attn"]
    delta = init_from_schema({"blocks": {"sub0": {"attn": attn}}},
                             seed=seed, device=DEVICE,
                             dtype=base["embed"].dtype)
    attn_base = {"blocks": {"sub0": {"attn": base["blocks"]["sub0"]["attn"]}}}
    return pytree.tree_map(lambda d, b: b + d * 0.1, delta, attn_base)


def same_bytes(a, b) -> int:
    """Leaves of two trees whose bytes differ."""
    from repro_torch import pytree
    return sum(not torch.equal(bits(x), bits(y.to(x.device)))
               for x, y in zip(pytree.leaves(a), pytree.leaves(b)))


def check_output(name: str, out, base) -> None:
    """Shapes of the base, finite values, and the reference's dtype:
    the base's, but fp32 for genetic_merge over half-precision leaves
    (its linspace grid is fp32)."""
    from repro_torch import pytree
    for o, b in zip(pytree.leaves(out), pytree.leaves(base)):
        want = torch.float32 if name == "genetic_merge" and \
            b.dtype in (torch.bfloat16, torch.float16) else b.dtype
        if o.shape != b.shape or o.dtype != want:
            raise AssertionError(f"{name}: output leaf {o.shape} "
                                 f"{o.dtype} != {b.shape} {want}")
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{name}: non-finite output")


def run_path(path: str, merges, disp=None, expect=None) -> dict:
    """Drive one main path: launch counts set to 0 just before it, read
    just after; every kernel of the path must have launched and, for an
    engine path (`disp`), its dispatch counter grown. `merges`: (label,
    thunk) pairs; `expect`: {label: {kernel: launches}} that a call must
    read exactly."""
    from repro_torch import kernels
    before = disp.snapshot() if disp is not None else None
    kernels.reset_launch_counts()
    per = {}
    for label, thunk in merges:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        c0 = kernels.launch_counts()
        t0 = time.perf_counter()
        thunk()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c1 = kernels.launch_counts()
        per[label] = ms
        delta = {k: c1[k] - c0[k] for k in c1 if c1[k] > c0[k]}
        log(f"[main] {path} {label}: {ms:.0f} ms; launches {delta}; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            f"({live / 1e9:.2f} GB live before the call)")
        if expect is not None and delta != expect[label]:
            raise AssertionError(f"{path} {label}: launches {delta}, "
                                 f"expected {expect[label]}")
    counts = kernels.launch_counts()
    for k in PATH_KERNELS[path]:
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the "
                                 f"{path} main path")
    grown = disp.grown(before) if disp is not None else {}
    log(f"[main] {path} path launches {counts}"
        + (f"; kernel_dispatch_total grew {grown}" if disp else ""))
    return {"launches": counts, "ms": per, "grown": grown}


def perleaf_path(ordered, base, nleaves: int) -> dict:
    """The per-leaf kernel API over the full-width trees: launch counts
    read per call (one slerp_reduce and one slerp_combine per leaf, one
    ties_leaf per leaf, one nary_accum per leaf); the quantile
    thresholds' seconds read from the `kernels.quantile_threshold`
    spans."""
    from repro_torch import kernels
    from repro_torch.obs import set_tracer, Tracer

    def call(label, fn, like):
        def thunk():
            check_output(f"perleaf {label}", fn(), like)
        return label, thunk

    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        out = run_path("perleaf", [
            call("slerp_merge", lambda: kernels.slerp_merge(
                ordered[0], ordered[1], t=0.5), base),
            call("ties_merge(quantile)", lambda: kernels.ties_merge(
                ordered, base, 0.2, trim_method="quantile"), base),
            call("task_arithmetic_merge", lambda: kernels.
                 task_arithmetic_merge(ordered, base), base)],
            expect={"slerp_merge": {"slerp_reduce": nleaves,
                                    "slerp_combine": nleaves},
                    "ties_merge(quantile)": {"ties_leaf": nleaves},
                    "task_arithmetic_merge": {"nary_accum": nleaves}})
    finally:
        set_tracer(prev)
    spans = [sp for sp in tracer.spans
             if sp.name == "kernels.quantile_threshold"]
    thr_s = sum(sp.duration for sp in spans)
    big = max(spans, key=lambda sp: sp.attrs["n"])
    log(f"[main] perleaf quantile thresholds: {thr_s:.2f} s of "
        f"ties_merge's {out['ms']['ties_merge(quantile)'] / 1e3:.2f} s, "
        f"{len(spans)} leaves x {K} rows; largest leaf "
        f"({big.attrs['n']} elements) {big.duration:.3f} s")
    return out


class Dispatches:
    """kernel_dispatch_total{kernel=...} of one registry."""
    KINDS = ("nary_accum", "ties_hist", "dare", "quant_nary")

    def __init__(self, obs):
        self.c = obs.counter("kernel_dispatch_total")

    def snapshot(self) -> dict:
        return {k: self.c.value(kernel=k) for k in self.KINDS}

    def grown(self, before: dict) -> dict:
        now = self.snapshot()
        return {k: now[k] - before[k] for k in self.KINDS
                if now[k] > before[k]}


def phase_main_path(cfg) -> dict:
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.core import engine
    from repro_torch.core.compression import compress_tree
    from repro_torch.core.resolve import canonical_order, seed_from_root
    from repro_torch.kernels.config import kernel_env
    from repro_torch.strategies import get_strategy
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base, contribs = make_models(cfg, DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(base))
    nleaves = len(pytree.leaves(base))
    log(f"[main] {cfg.name}: {nleaves} leaves, {n} "
        f"parameters per model, {K} contributions + base in bf16 "
        f"({(K + 1) * n * 2 / 1e9:.2f} GB) made in "
        f"{time.perf_counter() - t0:.1f} s")
    rep = Replica("chip-smoke", device=DEVICE)
    t0 = time.perf_counter()
    for c in contribs:
        rep.contribute(c)
    t_hash = time.perf_counter() - t0
    del contribs, c
    root = rep.merkle_root()
    seed = seed_from_root(root)
    ref = rep.register_base(base)
    order = canonical_order(rep.state)
    ordered = [rep.state.store[i] for i in order]
    log(f"[main] contribute x{K}: {t_hash:.1f} s "
        f"({K * n * 2 / t_hash / 1e9:.2f} GB/s hashed); merkle root "
        f"{root.hex()[:16]}…; seed {seed}")
    disp = Dispatches(rep.cache.obs)

    def merge_of(contribs, ids, name, cfgd, uses_base, cache=None):
        def thunk():
            spec = MergeSpec(name, cfgd, base_ref=ref if uses_base else None)
            out = engine.merge(contribs, spec=spec, contrib_ids=ids,
                               base=base if uses_base else None, seed=seed,
                               kernels=True, use_cache=False,
                               cache=cache or rep.cache)
            check_output(name, out, base)
        return thunk

    paths = {"bf16": run_path("bf16", [
        (name, merge_of(ordered, order, name, cfgd, ub))
        for name, cfgd, ub in STRATEGIES], disp)}
    if not {"nary_accum", "ties_hist"} <= set(paths["bf16"]["grown"]):
        raise AssertionError("kernel_dispatch_total{nary_accum, ties_hist} "
                             "did not grow on the bf16 path")

    # DARE through the kernel RNG, seeded from the Merkle root: the
    # fused groups launch dare_block; the FFN leaves, each alone in its
    # group, take the exact threefry path
    kernel_env.dare_kernel_rng = True
    try:
        paths["dare"] = run_path("dare", [("dare", merge_of(
            ordered, order, *DARE_SPEC))], disp)
    finally:
        kernel_env.dare_kernel_rng = False
    if "dare" not in paths["dare"]["grown"]:
        raise AssertionError("kernel_dispatch_total{kernel=dare} did not "
                             "grow")
    paths["perleaf"] = perleaf_path(ordered, base, nleaves)
    paths["search"] = search_path(ordered, order, base, ref, seed,
                                  rep.cache)
    paths["sparse"] = sparse_path(cfg, ordered, order, base)

    # int8 merge-on-arrival: compress on the card, drop the bf16 copies
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cts = [compress_tree(c) for c in ordered]
    torch.cuda.synchronize()
    log(f"[main] compress x{K} to int8 on the card: "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(ct.nbytes() for ct in cts) / 1e9:.2f} GB of payloads)")
    del ordered, rep
    # the int8 merges run at INT8_LAYERS of the 32 layers: the payloads
    # and the base cut (`first_layers`), the full ones freed
    cts = [first_layers(ct, INT8_LAYERS) for ct in cts]
    qbase = first_layers(base, INT8_LAYERS)
    torch.cuda.empty_cache()
    qids = [int8_eid(e, INT8_LAYERS) for e in order]
    qcache = engine.EngineCache()

    def qmerge(name, cfgd, uses_base):
        def thunk():
            out = engine.merge(cts, spec=MergeSpec(name, cfgd),
                               contrib_ids=qids,
                               base=qbase if uses_base else None,
                               seed=seed, kernels=True, use_cache=False,
                               cache=qcache)
            check_output(name, out, qbase)
        return thunk

    # the first int8 merge pays for planning: digests of the four
    # payloads, dequantized one leaf at a time
    log(f"[main] int8 path at {INT8_LAYERS} of {cfg.n_layers} layers "
        f"({sum(ct.nbytes() for ct in cts) / 1e9:.2f} GB of payloads)")
    paths["int8"] = run_path("int8", [
        (name, qmerge(name, cfgd, ub))
        for name, cfgd, ub in QUANT_STRATEGIES], Dispatches(qcache.obs))
    plan = engine.plan_for(cts, contrib_ids=qids, spec=MergeSpec(
        "weight_average"))
    groups = engine._dispatch_groups(
        get_strategy("weight_average"), list(plan.tasks),
        max(t.stacked_nbytes for t in plan.tasks))
    singles = sum(1 for grp in groups if len(grp) == 1)
    multi = nleaves - singles
    nq = len(QUANT_STRATEGIES)
    merged = qcache.obs.counter("engine_quant_leaves_merged_total").value()
    dequant = qcache.stats["dequant_leaves"]
    log(f"[main] int8: {multi} leaves in multi-leaf groups, {singles} "
        f"alone; over {nq} merges engine_quant_leaves_merged_total "
        f"{merged}, dequant_leaves {dequant} ({K} slices per leaf)")
    if merged != nq * multi or dequant != nq * K * singles \
            or merged + dequant // K != nq * nleaves:
        raise AssertionError("int8 leaves not accounted for: expected "
                             f"{nq * multi} merged on arrival and "
                             f"{nq * K * singles} slices densified")
    if "quant_nary" not in paths["int8"]["grown"]:
        raise AssertionError("kernel_dispatch_total{kernel=quant_nary} "
                             "did not grow")
    t0 = time.perf_counter()
    # the phase frees the base, and the payloads: DURABLE_LAYERS of them
    held = {"base": first_layers(base, DURABLE_LAYERS)}
    dcts = [first_layers(ct, DURABLE_LAYERS) for ct in cts]
    del base, qbase, cts
    torch.cuda.empty_cache()
    paths["durable"] = phase_durable(
        dcts, [int8_eid(e, DURABLE_LAYERS) for e in order], held)
    log(f"[time] phase_durable: {time.perf_counter() - t0:.0f} s")
    del dcts, held
    torch.cuda.empty_cache()
    launches = {k: sum(p["launches"][k] for p in paths.values())
                for k in paths["bf16"]["launches"]}
    return {"launches": launches,
            "ms": {f"{p} {k}": v for p, d in paths.items()
                   for k, v in d["ms"].items()}}


def ulp_diff(exact, kern) -> tuple:
    """(elements beyond one bf16 ulp, elements, max abs diff)."""
    from repro_torch import pytree
    total = bad = 0
    worst = 0.0
    for e, k in zip(pytree.leaves(exact), pytree.leaves(kern)):
        e32, k32 = e.to(torch.float32), k.to(torch.float32)
        d = (e32 - k32).abs()
        worst = max(worst, float(d.max()))
        bad += int((d > LIN_ATOL + LIN_RTOL * e32.abs()).sum())
        total += d.numel()
    return bad, total, worst


def report(label: str, bad: int, total: int, worst: float, ok: bool,
           rule: str, beyond: str = "one bf16 ulp") -> None:
    log(f"[exact-vs-kernels] {label}: max abs diff {worst:.3e}; "
        f"{bad}/{total} = {bad / total:.2e} beyond {beyond}; rule: "
        f"{rule}: {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel route outside tolerance")


def perleaf_vs_exact(rep, ordered, base, ref, layers: int) -> None:
    """The per-leaf kernel API against `Replica.resolve`: slerp at k = 2
    (a replica of the first two contributions), slerp at k = 4 folded in
    sequence and as a tree (the kernels folded by the same
    `pairwise_fold`), and quantile TIES at k = 4; then the three slerp
    merges over fp32 copies, the exact path (`reference_apply`) against
    the kernels with both in fp32. A fold of the kernels in reversed
    order is read once against the exact fold, for scale."""
    from repro_torch import kernels, pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.core.resolve import canonical_order, reference_apply
    from repro_torch.strategies.base import pairwise_fold

    def hold(label, exact, kern):
        bad, total, worst = ulp_diff(exact, kern)
        limit = PERLEAF_MAX_DIFF_SHARE[label]
        report(f"{label} ({layers} layers)", bad, total, worst,
               bad / total <= limit, f"share beyond one bf16 ulp <= {limit}")

    def hold_f32(label, exact, kern):
        total = bad = 0
        worst = 0.0
        for e, k in zip(pytree.leaves(exact), pytree.leaves(kern)):
            d = (e - k).abs()
            worst = max(worst, float(d.max()))
            bad += int((d > 1e-6 + 1e-5 * e.abs()).sum())
            total += d.numel()
        limit = PERLEAF_MAX_DIFF_SHARE[label]
        report(f"{label} ({layers} layers)", bad, total, worst,
               bad / total <= limit,
               f"share beyond 1e-6 + 1e-5 |exact| <= {limit}",
               beyond="1e-6 + 1e-5 |exact|")

    def folded(trees, red):
        return pairwise_fold(trees, lambda a, b, _: kernels.slerp_merge(
            a, b, t=0.5), 0, red)

    rep2 = Replica("chip-smoke-slerp", device=DEVICE)
    for c in ordered[:2]:
        rep2.contribute(c)
    pair = [rep2.state.store[i] for i in canonical_order(rep2.state)]
    hold("slerp k=2", rep2.resolve(MergeSpec("slerp", {"t": 0.5}),
                                   use_cache=False), folded(pair, "fold"))
    del rep2
    for red in ("fold", "tree"):
        exact = rep.resolve(MergeSpec("slerp", {"t": 0.5}, reduction=red),
                            use_cache=False)
        hold(f"slerp k=4 {red}", exact, folded(ordered, red))
        if red == "fold":
            bad, total, _ = ulp_diff(exact, folded(ordered[::-1], red))
            log(f"[exact-vs-kernels] slerp k=4 fold, kernels folded in "
                f"reversed order ({layers} layers, no limit): "
                f"{bad}/{total} = {bad / total:.2e} beyond one bf16 ulp")
        del exact
    for label, trees in (("slerp k=2 fp32", pair),
                         ("slerp k=4 fold fp32", ordered),
                         ("slerp k=4 tree fp32", ordered)):
        red = "tree" if "tree" in label else "fold"
        f32 = [pytree.tree_map(lambda t: t.to(torch.float32), c)
               for c in trees]
        hold_f32(label, reference_apply("slerp", f32, t=0.5, reduction=red),
                 folded(f32, red))
        del f32
    del pair
    spec = MergeSpec("ties", {"trim": 0.2, "trim_method": "quantile"},
                     base_ref=ref)
    hold("ties quantile", rep.resolve(spec, use_cache=False),
         kernels.ties_merge(ordered, base, 0.2, trim_method="quantile"))
    torch.cuda.empty_cache()


def phase_exact_vs_kernels(cfg) -> None:
    """Kernel routes against the exact routes at full width, depth 2;
    the exact DARE path's threefry draw on the card against the CPU's."""
    from repro_torch import pytree
    from repro_torch import random as prng
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.core import engine
    from repro_torch.core.compression import compress_tree
    from repro_torch.core.resolve import canonical_order, seed_from_root
    from repro_torch.strategies.base import leaf_key
    cfg = cfg.replace(n_layers=2)
    base, contribs = make_models(cfg, DEVICE)
    rep = Replica("chip-smoke-d2", device=DEVICE)
    for c in contribs:
        rep.contribute(c)
    del contribs
    ref = rep.register_base(base)
    order = canonical_order(rep.state)
    ordered = [rep.state.store[i] for i in order]
    seed = seed_from_root(rep.merkle_root())
    for name, cfgd, uses_base in STRATEGIES:
        spec = MergeSpec(name, cfgd, base_ref=ref if uses_base else None)
        exact = rep.resolve(spec, use_cache=False)
        kern = engine.merge(ordered, spec=spec, contrib_ids=order,
                            seed=seed, base=base if uses_base else None,
                            kernels=True, use_cache=False)
        bad, total, worst = ulp_diff(exact, kern)
        if name == "ties":
            ok = bad / total <= TIES_MAX_DIFF_SHARE
            rule = f"share beyond one bf16 ulp <= {TIES_MAX_DIFF_SHARE}"
        else:
            ok = bad == 0
            rule = f"|exact - kernel| <= {LIN_ATOL} + {LIN_RTOL} |exact|"
        report(f"{name} ({cfg.n_layers} layers)", bad, total, worst, ok,
               rule)
        del exact, kern

    perleaf_vs_exact(rep, ordered, base, ref, cfg.n_layers)

    # int8: merge on arrival (fp32 dequantize in registers) against the
    # exact path over the same payloads (dequantize to bf16, then fold)
    cts = [compress_tree(c) for c in ordered]
    qids = [int8_eid(e) for e in order]
    for name, cfgd, uses_base in QUANT_STRATEGIES:
        spec = MergeSpec(name, cfgd, base_ref=ref if uses_base else None)
        kw = dict(spec=spec, contrib_ids=qids, seed=seed,
                  base=base if uses_base else None, use_cache=False)
        exact = engine.merge(cts, **kw)
        kern = engine.merge(cts, kernels=True, **kw)
        bad, total, worst = ulp_diff(exact, kern)
        limit = QUANT_MAX_DIFF_SHARE[name]
        report(f"int8 {name} ({cfg.n_layers} layers)", bad, total, worst,
               bad / total <= limit,
               f"share beyond one bf16 ulp <= {limit}")
        del exact, kern
    del cts

    # exact DARE (threefry, kernel RNG off) through Replica.resolve
    spec = MergeSpec(*DARE_SPEC[:2], base_ref=ref)
    t0 = time.perf_counter()
    out = rep.resolve(spec, use_cache=False)
    torch.cuda.synchronize()
    check_output("dare (exact)", out, base)
    flat, _ = pytree.flatten_with_path(base)
    i = max(range(len(flat)), key=lambda j: flat[j][1].numel())
    path, leaf = pytree.keystr(flat[i][0]), flat[i][1]
    shape = (len(order),) + tuple(leaf.shape)
    key = leaf_key(seed, i)
    m = min(1 << 20, leaf.numel())
    on_card = prng.uniform(key, shape, torch.float32, count=m,
                           device=DEVICE).cpu()
    on_host = prng.uniform(key, shape, torch.float32, count=m,
                           device="cpu")
    if not torch.equal(on_card, on_host):
        raise AssertionError("threefry on the card != threefry on the CPU")
    # the leaf's first 2^20 merged values, recomputed on the CPU
    n = leaf.numel()
    b = leaf.reshape(-1)[:m].cpu()
    acc = torch.zeros(m)
    for j, eid in enumerate(order):
        tau = rep.state.store[eid]
        tau = pytree.flatten(tau)[0][i].reshape(-1)[:m].cpu() - b
        keep = prng.bernoulli(key, 1.0 - DARE_P, shape, device="cpu",
                              start=j * n, count=m).to(tau.dtype)
        acc += (tau * keep) / torch.tensor(1.0 - DARE_P, dtype=tau.dtype)
    want = b + (acc * (torch.tensor(1.0) / torch.tensor(
        float(len(order))))).to(b.dtype)
    got = pytree.flatten(out)[0][i].reshape(-1)[:m].cpu()
    differ = int((got != want).sum())
    log(f"[exact-vs-kernels] dare exact path (Replica.resolve, "
        f"{cfg.n_layers} layers) in {time.perf_counter() - t0:.1f} s; "
        f"leaf {path}: threefry draw of its first {m} elements equal on "
        f"the card and the CPU; merged values vs a CPU recomputation: "
        f"{differ} of {m} differ, max abs diff "
        f"{float((got.float() - want.float()).abs().max()):.3e}")
    if differ:
        raise AssertionError("exact DARE on the card != its CPU "
                             "recomputation")
    del out
    sparse_vs_exact(cfg, rep, order, base, ref)
    del base, ordered, rep
    torch.cuda.empty_cache()


def sparse_vs_exact(cfg, rep, order, base, ref) -> None:
    """The sparse path at depth 2: the adapter update S lands on the
    replica of the K dense contributions. The kernel routes are held to
    the main path's limits against the exact path (`Replica.resolve`),
    which is bitwise the engine-free `sparse_reference_apply` on the
    card; over fp32 copies the exact linear-family merges on the card
    are bitwise the CPU's (their fold order is pinned)."""
    from repro_torch import pytree
    from repro_torch.api import MergeSpec
    from repro_torch.core import engine
    from repro_torch.core.resolve import seed_from_root, \
        sparse_reference_apply
    layers, eid_s = cfg.n_layers, sparse_eid(cfg.n_layers)
    upd = sparse_update(cfg, base, SEED + 50)
    rep.contribute(upd, eid_s, leaves=SPARSE_LEAVES)
    ids = sorted(list(order) + [eid_s])
    payloads = [rep.state.store[i] for i in ids]
    covs = [SPARSE_LEAVES if i == eid_s else None for i in ids]
    seed = seed_from_root(rep.merkle_root())
    for name, cfgd, uses_base in STRATEGIES:
        spec = MergeSpec(name, cfgd, base_ref=ref if uses_base else None)
        exact = rep.resolve(spec, use_cache=False)
        want = sparse_reference_apply(name, payloads, covs, base=base,
                                      seed=seed, **cfgd)
        differ = same_bytes(exact, want)
        log(f"[exact-vs-kernels] sparse {name} ({layers} layers): the exact "
            f"path vs sparse_reference_apply on the card, {differ} leaves "
            "differ (bitwise)")
        if differ:
            raise AssertionError(f"sparse {name}: the exact path is not "
                                 "sparse_reference_apply")
        kern = engine.merge(payloads, spec=spec, contrib_ids=ids, seed=seed,
                            base=base if uses_base else None, kernels=True,
                            use_cache=False, coverages=covs)
        bad, total, worst = ulp_diff(exact, kern)
        if name == "ties":
            ok = bad / total <= TIES_MAX_DIFF_SHARE
            rule = f"share beyond one bf16 ulp <= {TIES_MAX_DIFF_SHARE}"
        else:
            ok = bad == 0
            rule = f"|exact - kernel| <= {LIN_ATOL} + {LIN_RTOL} |exact|"
        report(f"sparse {name} ({layers} layers)", bad, total, worst, ok,
               rule)
        del exact, want, kern
    f32 = [pytree.tree_map(lambda t: t.to(torch.float32), p)
           for p in payloads]
    b32 = pytree.tree_map(lambda t: t.to(torch.float32), base)
    fids = ["fp32:" + i for i in ids]
    for name, cfgd, uses_base in STRATEGIES[:2]:
        outs = []
        for dev in (DEVICE, "cpu"):
            outs.append(engine.merge(
                [pytree.tree_map(lambda t: t.to(dev), p) for p in f32],
                name, contrib_ids=fids, seed=seed, use_cache=False,
                base=pytree.tree_map(lambda t: t.to(dev), b32)
                if uses_base else None, coverages=covs, **cfgd))
        differ = same_bytes(outs[0], outs[1])
        log(f"[exact-vs-kernels] sparse {name} ({layers} layers, fp32): the "
            f"exact path on the card vs the CPU, {differ} leaves differ "
            "(bitwise)")
        if differ:
            raise AssertionError(f"sparse {name} fp32: card != CPU")
        del outs
    del f32, b32, upd, payloads
    torch.cuda.empty_cache()


def serve_batch(cfg, batch: int = SERVE_BATCH,
                prompt: int = SERVE_PROMPT) -> dict:
    from repro_torch.configs import ShapeSpec
    from repro_torch.data.synthetic import make_batch
    shape = ShapeSpec("serve", prompt, batch, "prefill")
    return {k: torch.as_tensor(v, device=DEVICE)
            for k, v in make_batch(cfg, shape, step=SEED).items()}


def check_served(label: str, tokens, logits, cfg, batch: int = SERVE_BATCH,
                 gen: int = SERVE_GEN) -> None:
    if tuple(tokens.shape) != (batch, gen) \
            or tuple(logits.shape) != (batch, cfg.vocab_size):
        raise AssertionError(f"{label}: tokens {tuple(tokens.shape)}, "
                             f"logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()) or int(tokens.min()) < 0 \
            or int(tokens.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label}: non-finite logits or tokens out of "
                             "the vocabulary")


# kernel-name words of the MoE layer's routing and data movement: the
# router's sort, the positions' scan, the one-hot scatter, and the
# gathers of the dispatch table, the expert inputs and the combine
ROUTING_WORDS = ("sort", "scan", "index", "gather", "scatter")


def trace_device(label: str, fn, tag: str = "serve",
                 host: bool = True, routing: bool = False) -> dict:
    """One warm call of `fn` under `torch.profiler`: its wall time (host
    clock to a synchronize, profiler on), the device time of its kernels
    by group (B9, B9's gradient where it ran, matrix products, with
    `routing` the MoE routing / gather kernels (ROUTING_WORDS), the rest)
    and its three costliest kernels, the share of the wall time the
    device was idle, and (with `host`) the host's three costliest CUDA
    runtime calls. Without `host` only the device is traced: a train
    step launches ~23,000 kernels from ~100,000 host ops, and recording
    those took 12 s of a 3.5 s step on an H100 80GB HBM3). Logs one line
    and returns {"wall_ms", "kernels", "groups" (ms by group)}, empty
    where the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups = {"B9": 0.0, "B9 bwd": 0.0, "matmul": 0.0, "routing": 0.0,
              "other": 0.0}
    runtime: dict = {}
    kernels: dict = {}
    n = 0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            if ev.name.startswith("cuda"):     # CUDA runtime calls
                runtime[ev.name] = runtime.get(ev.name, 0.0) \
                    + ev.time_range.elapsed_us() / 1e3
            continue
        name = ev.name.lower()
        # cuBLAS's Hopper kernels are named nvjet_*, its older ones *gemm*
        key = "B9" if "flash_kernel" in name else (
            "B9 bwd" if any(w in name for w in ("bwd_dkdv", "bwd_dq",
                                                "bwd_dot")) else
            "matmul" if any(w in name for w in ("nvjet", "gemm", "gemv",
                                                "cutlass", "xmma")) else
            "routing" if routing and any(w in name for w in ROUTING_WORDS)
            else "other")
        ms = ev.time_range.elapsed_us() / 1e3
        groups[key] += ms
        kernels[ev.name[:40]] = kernels.get(ev.name[:40], 0.0) + ms
        n += 1
    if not n:
        log(f"[{tag}] {label}, traced: the profiler recorded no device "
            "time (device split not measured)")
        return {}
    busy = sum(groups.values())
    def top(d):
        return ", ".join(f"{k} {v:.2f} ms" for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:3])

    bwd = f", B9 bwd {groups['B9 bwd']:.2f}" if groups["B9 bwd"] else ""
    rt = f", routing/gather {groups['routing']:.2f}" if routing else ""
    log(f"[{tag}] {label}, traced: wall {wall:.2f} ms; {n} kernels, device "
        f"busy {busy:.2f} ms (B9 {groups['B9']:.2f}{bwd}, matmuls "
        f"{groups['matmul']:.2f}{rt}, other {groups['other']:.2f}); device "
        "idle "
        f"{max(0.0, 1 - busy / wall):.3f} of the wall time; costliest "
        f"kernels {top(kernels)}; host runtime calls "
        + (top(runtime) if host else "not traced"))
    return {"wall_ms": wall, "kernels": n, "groups": groups}


def phase_serve(cfg) -> dict:
    """Merge, then serve: two replicas fed the same K contributions in
    opposite orders resolve TIES to byte-identical trees; A's tree is
    served through `greedy_decode` (the main path: every attention call
    on B9, exactly n_layers * (SERVE_GEN + 1) launches) and B's must give
    the same tokens and last logits, byte for byte. A's call is the
    process's first at these shapes; B's, timed too, is warm, and the
    prefill alone after it splits its time; one decode step and one
    prefill are then traced."""
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.model import Model
    from repro_torch.train.serve import greedy_decode
    base, contribs = make_models(cfg, DEVICE)
    t0 = time.perf_counter()
    rep_a = Replica("chip-smoke-serve-a", device=DEVICE)
    eids = [rep_a.contribute(c) for c in contribs]
    ref_a = rep_a.register_base(base)
    t_a = time.perf_counter() - t0
    # B receives the same contributions in the opposite order, named by
    # their content hashes as a sync delivers them (not hashed again)
    t0 = time.perf_counter()
    rep_b = Replica("chip-smoke-serve-b", device=DEVICE)
    for c, eid in zip(contribs[::-1], eids[::-1]):
        rep_b.contribute(c, eid)
    ref_b = rep_b.register_base(base)
    t_b = time.perf_counter() - t0
    if rep_a.merkle_root() != rep_b.merkle_root() or ref_a != ref_b:
        raise AssertionError("the two replicas disagree on Layer 1")
    log(f"[serve] replica A: contribute x{K} + register_base in {t_a:.1f} "
        f"s; replica B (reverse order, eids given): {t_b:.1f} s; equal "
        f"merkle roots {rep_a.merkle_root().hex()[:16]}…")
    del contribs, base
    merged = {}
    for label, rep, ref in (("A", rep_a, ref_a), ("B", rep_b, ref_b)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tree = rep.resolve(MergeSpec("ties", base_ref=ref))
        torch.cuda.synchronize()
        log(f"[serve] replica {label}: resolve ties in "
            f"{time.perf_counter() - t0:.1f} s; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
            f"({live / 1e9:.2f} GB live before the call)")
        # A's tree waits in host memory while B resolves: the exact TIES
        # path of an FFN leaf takes ~20 GB beside the five models
        merged[label] = pytree.tree_map(lambda t: t.cpu(), tree) \
            if label == "A" else tree
        del tree
    # the replicas hold the five models (38.2 GB)
    del rep_a, rep_b, rep
    torch.cuda.empty_cache()
    merged["A"] = pytree.tree_map(lambda t: t.to(DEVICE), merged["A"])
    check_output("ties (replica A)", merged["A"], merged["B"])
    differ = sum(not torch.equal(bits(a), bits(b)) for a, b in zip(
        pytree.leaves(merged["A"]), pytree.leaves(merged["B"])))
    if differ:
        raise AssertionError(f"merged trees differ in {differ} leaves")
    log(f"[serve] merged trees byte-identical "
        f"({len(pytree.leaves(merged['A']))} leaves)")

    model = Model(cfg)
    batch = serve_batch(cfg)
    launches = cfg.n_layers * (SERVE_GEN + 1)
    out = {}

    def serve(label):
        def thunk():
            out[label] = greedy_decode(model, merged[label], batch,
                                       SERVE_GEN, return_logits=True)
        return thunk

    path = run_path("serve", [("greedy_decode A", serve("A"))],
                    expect={"greedy_decode A": {"flash_attention":
                                                launches}})
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve("B")()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    if launch_counts()["flash_attention"] != launches:
        raise AssertionError("serving B's tree did not launch B9 "
                             f"{launches} times")
    (tok_a, lg_a), (tok_b, lg_b) = ((t, lg[-1]) for t, lg in
                                    (out["A"], out["B"]))
    check_served("serve A", tok_a, lg_a, cfg)
    if not (torch.equal(tok_a, tok_b) and torch.equal(bits(lg_a),
                                                      bits(lg_b))):
        raise AssertionError("the two replicas' trees served different "
                             "tokens or logits")
    log(f"[serve] replica B's tree: {launches} B9 launches; tokens and last "
        f"logits byte-identical to A's; tokens[0] {tok_a[0].tolist()}")
    # the prefill alone, for the split of the served time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(merged["A"], batch,
                                   max_len=SERVE_PROMPT + SERVE_GEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    decode_ms = (total - t_prefill) * 1e3 / SERVE_GEN
    log(f"[serve] Phi-3-mini, {cfg.n_layers} layers, batch {SERVE_BATCH}, "
        f"prompt {SERVE_PROMPT}, {SERVE_GEN} tokens: greedy_decode "
        f"{path['ms']['greedy_decode A'] / 1e3:.3f} s (A, first call); "
        f"{total:.3f} s (B, warm) = prefill {t_prefill:.3f} s (timed alone) "
        f"+ {decode_ms:.2f} ms per decode step; "
        f"{SERVE_BATCH * SERVE_GEN / total:.1f} generated tokens/s "
        f"({SERVE_BATCH * SERVE_GEN / (total - t_prefill):.1f} after the "
        "prefill)")
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    trace_device("decode step", lambda: model.decode_step(
        merged["A"], caches, tok, SERVE_PROMPT))
    del caches
    trace_device("prefill", lambda: model.prefill(
        merged["A"], batch, max_len=SERVE_PROMPT + SERVE_GEN))
    del merged, out
    torch.cuda.empty_cache()
    return path


def phase_serve_vs_plain(cfg) -> None:
    """The served forward at full width, depth 2, with B9 against the
    same forward with B9's plain version on the card, in bf16 and fp32
    compute: logits compared while both runs' tokens agree, tokens at
    every step whose top-2 margin exceeds SERVE_LOGIT_LIMIT."""
    served_vs_plain(cfg.replace(n_layers=2), serve_batch(cfg),
                    "serve-vs-plain")


def served_vs_plain(cfg, batch: dict, tag: str, other=None,
                    what: str = "B9 vs plain") -> None:
    """`greedy_decode` of 8 tokens with B9 and with its plain version
    (`flash_attention_plain`) on the same bf16 weights
    (`init_from_schema`), in bf16 and fp32 compute: per row, the logits
    within SERVE_LOGIT_LIMIT[cd] at every step while both runs' tokens
    agree, and the tokens equal at every step whose top-2 margin exceeds
    it. `other(cfg)` gives the model to compare with instead (the MoE
    layer's einsum dispatch against its gather one).

    With routed experts (`cfg.moe`) a router input a rounding apart can
    send a token to another expert where two of its probabilities tie,
    and that moves the output by a whole expert's difference: each run's
    routing is recorded (`moe_routes`), a row is compared only at the
    steps before its first routing difference (a token sent to another
    set of experts), and at that difference every token routed otherwise
    must have been a near tie (the first run's k-th and (k+1)-th
    probabilities within FLIP_GAP[cd] of the k-th)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    if other is None:
        def other(c):
            return Model(c, attention=flash_attention_plain)
    params = init_from_schema(Model(cfg).schema(), seed=SEED,
                              device=DEVICE, dtype=torch.bfloat16)
    nb, prompt = batch["tokens"].shape
    steps = 8
    for cd in ("bfloat16", "float32"):
        c = cfg.replace(compute_dtype=cd)
        with moe_routes() as ra:
            kt, kl = greedy_decode(Model(c), params, batch, steps,
                                   return_logits=True)
        with moe_routes() as rb:
            pt, pl = greedy_decode(other(c), params, batch, steps,
                                   return_logits=True)
        limit = SERVE_LOGIT_LIMIT[cd]
        upto, flips = first_route_flips(ra, rb, nb, cfg.n_layers, steps)
        flip_ok = all(gap <= FLIP_GAP[cd] for _, _, gap, _ in flips)
        worst, compared, bad = 0.0, 0, []
        for r in range(nb):
            for i in range(upto[r]):
                worst = max(worst, float((kl[i][r] - pl[i][r]).abs().max()))
                if i == steps:
                    break
                top2 = kl[i][r].topk(2).values
                if float(top2[0] - top2[1]) <= limit:
                    break
                compared += 1
                if int(kt[r, i]) != int(pt[r, i]):
                    bad.append((r, i))
                    break
        share = float((kt == pt).float().mean())
        ok = worst <= limit and not bad and flip_ok
        firsts = [(r, i, f"{g:.2e}", t) for r, i, g, t in flips]
        routing = "" if not cfg.moe else (
            f"; routing identical in every call of {nb - len(flips)} of "
            f"{nb} rows" + (f", first differences (row, step, largest "
                            f"relative top-k gap, limit {FLIP_GAP[cd]}; "
                            f"tokens routed otherwise) {firsts}, rows "
                            f"compared up to steps {upto}"
                            if flips else ""))
        log(f"[{tag}] {cfg.name} {what}, {cd} compute, {cfg.n_layers} "
            "layers, batch "
            f"{nb}, prompt {prompt}, {steps} tokens: logits "
            f"max abs diff {worst:.3e} while the tokens agree (limit "
            f"{limit}); {compared} tokens past the margin rule, "
            f"{len(bad)} differ; {share:.4f} of all tokens agree{routing}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"served forward, {what} ({cd}), outside "
                                 "its limit")
        del kt, kl, pt, pl
    del params
    torch.cuda.empty_cache()


# a token routed to other experts by two runs of the served forward must
# have been a near tie: its k-th and (k+1)-th router probabilities within
# this share of the k-th. fp32: the two attention versions' outputs
# differ by ~1e-6 of their size, and move the router's probabilities by
# as much; bf16: by a bf16 ulp (2^-8) of the router's input, times its
# logits of a few units
FLIP_GAP = {"float32": 1e-4, "bfloat16": 5e-2}


@contextlib.contextmanager
def moe_routes():
    """Records every router call of the MoE layers (`models.moe._router`)
    made inside the block: per call the top-k indices [G, s, k] and each
    token's relative gap between its k-th and (k+1)-th probabilities,
    (p_k - p_{k+1}) / p_k, recomputed from the same fp32 logits."""
    from repro_torch.models import moe as MOE
    real = MOE._router
    calls = []

    def recorded(p, x, m):
        out = real(p, x, m)
        probs = torch.softmax(x.to(torch.float32)
                              @ p["router"].to(torch.float32), dim=-1)
        top = probs.topk(m.top_k + 1, dim=-1).values
        calls.append((out[1], (top[..., -2] - top[..., -1]) / top[..., -2]))
        return out

    MOE._router = recorded
    try:
        yield calls
    finally:
        MOE._router = real


def first_route_flips(ra, rb, nb: int, n_layers: int, steps: int):
    """(steps to compare per row, [(row, step, largest relative gap,
    tokens routed otherwise)] at each row's first routing difference) of
    two recorded runs of
    `greedy_decode`: call c runs at step c // n_layers (0 the prefill),
    one router call per MoE layer. A token is routed otherwise when its
    set of k experts differs (their order within the top k changes only
    the order the combine sums in). Without routers every row compares
    all steps + 1 logits."""
    upto = [steps + 1] * nb
    flips = []
    for c, ((ia, gap), (ib, _)) in enumerate(zip(ra, rb)):
        diff = (ia.sort(-1).values != ib.sort(-1).values).any(-1)  # [G, s]
        for r in range(nb):
            if upto[r] == steps + 1 and bool(diff[r].any()):
                upto[r] = c // n_layers
                flips.append((r, c // n_layers,
                              float(gap[r][diff[r]].max()),
                              int(diff[r].sum())))
    return upto, flips


def phase_gemma2() -> dict:
    """`[gemma2]`: Gemma-2 27B served on the card. Full depth: its
    27,227,128,320 parameters seeded in bf16 (`init_from_schema`, 54.45
    GB), then `greedy_decode` twice (batch 2, an 8160-token prompt from
    `make_batch`, 32 tokens; every attention call on B9 with the softcap,
    the local layers' window in prefill and their 4096-slot rings in
    decode: exactly 46 x 33 launches a call), byte-identical tokens and
    logits; the prefill alone for the split; one decode step and one
    prefill traced. Merged: at 2 layers, a base and 2 contributions
    (base + 0.1 x a seeded delta) go to two replicas in opposite orders,
    which resolve TIES (exact path) to byte-identical trees and serve
    them to byte-identical tokens and logits (the reference's
    `examples/serve_merged.py` flow). Last, at 2 layers, the served
    forward with B9 against its plain version (`served_vs_plain`)."""
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    cfg = get_config(GEMMA2)
    model = Model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_from_schema(model.schema(), seed=SEED, device=DEVICE,
                              dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(params))
    if n != count_params(cfg)[0]:
        raise AssertionError(f"{n} parameters, count_params says "
                             f"{count_params(cfg)[0]}")
    log(f"[gemma2] {cfg.name}: {n} bf16 parameters "
        f"({n * 2 / 1e9:.2f} GB, {model.n_periods} periods of "
        f"{len(model.layout)} sub-layers, windows "
        f"{[sl.window for sl in model.layout]}) seeded in "
        f"{time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    batch = serve_batch(cfg, G2_BATCH, G2_PROMPT)
    per_call = cfg.n_layers * (G2_GEN + 1)
    out = {}

    def serve(label, m, p, b=batch):
        def thunk():
            out[label] = greedy_decode(m, p, b, G2_GEN, return_logits=True)
        return thunk

    calls = [("greedy_decode 1", serve("1", model, params)),
             ("greedy_decode 2", serve("2", model, params))]
    path = run_path("gemma2", calls, expect={
        label: {"flash_attention": per_call} for label, _ in calls})
    (tok1, lg1), (tok2, lg2) = out.pop("1"), out.pop("2")
    check_served("gemma2", tok1, lg1[-1], cfg, G2_BATCH, G2_GEN)
    if not (torch.equal(tok1, tok2) and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(lg1, lg2))):
        raise AssertionError("[gemma2] two greedy_decode calls differ")
    total = path["ms"]["greedy_decode 2"] / 1e3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch,
                                   max_len=G2_PROMPT + G2_GEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    decode_ms = (total - t_prefill) * 1e3 / G2_GEN
    log(f"[gemma2] {cfg.n_layers} layers, batch {G2_BATCH}, prompt "
        f"{G2_PROMPT}, {G2_GEN} tokens: {per_call} B9 launches a call; "
        f"tokens and all {G2_GEN + 1} logits byte-identical across the two "
        f"calls; greedy_decode {path['ms']['greedy_decode 1'] / 1e3:.3f} s "
        f"(first call), {total:.3f} s (second) = prefill {t_prefill:.3f} s "
        f"(timed alone; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB) + {decode_ms:.2f} ms per decode step; "
        f"{G2_BATCH * G2_GEN / total:.1f} generated tokens/s "
        f"({G2_BATCH * G2_GEN / (total - t_prefill):.1f} after the "
        f"prefill); tokens[0] {tok1[0].tolist()}")
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    trace_device("decode step", lambda: model.decode_step(
        params, caches, tok, G2_PROMPT), tag="gemma2")
    del caches, logits, lg1, lg2
    trace_device("prefill", lambda: model.prefill(
        params, batch, max_len=G2_PROMPT + G2_GEN), tag="gemma2")
    del params, calls      # the thunks hold the 54.45 GB of weights too
    torch.cuda.empty_cache()

    # merged at G2_MERGE_LAYERS through two replicas, then served
    cfg4 = cfg.replace(n_layers=G2_MERGE_LAYERS)
    t0 = time.perf_counter()
    base, contribs = make_models(cfg4, DEVICE, k=G2_K)
    rep_a = Replica("gemma2-a", device=DEVICE)
    eids = [rep_a.contribute(c) for c in contribs]
    ref_a = rep_a.register_base(base)
    rep_b = Replica("gemma2-b", device=DEVICE)
    for c, eid in zip(contribs[::-1], eids[::-1]):
        rep_b.contribute(c, eid)
    ref_b = rep_b.register_base(base)
    if rep_a.merkle_root() != rep_b.merkle_root() or ref_a != ref_b:
        raise AssertionError("[gemma2] the two replicas disagree on Layer 1")
    del contribs
    merged = {}
    for label, rep, ref in (("A", rep_a, ref_a), ("B", rep_b, ref_b)):
        t1 = time.perf_counter()
        merged[label] = rep.resolve(MergeSpec("ties", base_ref=ref))
        torch.cuda.synchronize()
        log(f"[gemma2] merged, {G2_MERGE_LAYERS} layers: replica {label} "
            f"resolves ties in {time.perf_counter() - t1:.1f} s")
    check_output("gemma2 ties (replica A)", merged["A"], base)
    differ = same_bytes(merged["A"], merged["B"])
    if differ:
        raise AssertionError(f"[gemma2] merged trees differ in {differ} "
                             "leaves")
    del rep_a, rep_b, rep, base
    model4 = Model(cfg4)
    calls = [(f"greedy_decode merged {label}",
              serve(label, model4, merged[label])) for label in ("A", "B")]
    per4 = cfg4.n_layers * (G2_GEN + 1)
    merged_path = run_path("gemma2", calls, expect={
        label: {"flash_attention": per4} for label, _ in calls})
    (ta, la), (tb, lb) = out.pop("A"), out.pop("B")
    check_served("gemma2 merged", ta, la[-1], cfg4, G2_BATCH, G2_GEN)
    if not (torch.equal(ta, tb) and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(la, lb))):
        raise AssertionError("[gemma2] the replicas' merged trees served "
                             "different tokens or logits")
    log(f"[gemma2] merged, {G2_MERGE_LAYERS} layers ({G2_K} contributions "
        f"+ base, {sum(t.numel() for t in pytree.leaves(merged['A']))} "
        "parameters a model): replicas A and B (opposite orders) resolve "
        "byte-identical trees and serve byte-identical tokens and logits "
        f"({per4} B9 launches each); {time.perf_counter() - t0:.1f} s "
        f"with the merges; tokens[0] {ta[0].tolist()}")
    del merged, out, la, lb, calls
    torch.cuda.empty_cache()
    served_vs_plain(cfg.replace(n_layers=G2_PLAIN_LAYERS), batch,
                    "gemma2-vs-plain")
    launches = {k: path["launches"][k] + merged_path["launches"][k]
                for k in path["launches"]}
    return {"launches": launches, "ms": {**path["ms"],
                                         **merged_path["ms"]}}


def phase_gemma2_flash_kernel(rows: dict, g) -> None:
    """B9 at gemma2-27b's serving shapes, each held against its plain
    version and timed: the prefill's q [2, 8160, 32, 128], k, v [2,
    8160, 16, 128] with softcap 50 and scale 144^-0.5, bf16 and fp32,
    on a local layer (window 4096: key tiles below it are skipped) and a
    global one; a decode step's q [2, 1, 32, 128] over a local layer's
    4096-slot ring at q_offset 4095 and over a global layer's 8192-slot
    cache at position 8160."""
    from repro_torch.configs import get_config
    cfg = get_config(GEMMA2)
    dev = torch.device(DEVICE)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w, cap, scale = cfg.sliding_window, cfg.attn_softcap, cfg.query_scale

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        qkv = [randn(G2_BATCH, G2_PROMPT, n, d, dtype=dtype)
               for n in (h, hk, hk)]
        for layer, window in (("local", w), ("global", 0)):
            cases[f"gemma2 prefill {layer} {tag}"] = flash_case(
                *qkv, 0, window=window, softcap=cap, scale=scale,
                floor=FLASH_BF16_FLOOR["gemma2"])
        del qkv
        torch.cuda.empty_cache()
    q = randn(G2_BATCH, 1, h, d)
    kv = [randn(G2_BATCH, w, hk, d) for _ in range(2)]
    cases["gemma2 decode ring bf16"] = flash_case(q, *kv, w - 1,
                                                  softcap=cap, scale=scale)
    kv = [randn(G2_BATCH, G2_PROMPT + G2_GEN, hk, d) for _ in range(2)]
    cases["gemma2 decode global bf16"] = flash_case(
        q, *kv, G2_PROMPT, softcap=cap, scale=scale)
    del q, kv
    torch.cuda.empty_cache()
    rows["flash_attention"].update(cases)


def phase_qwen3_moe() -> dict:
    """`[qwen3-moe]`: Qwen3-MoE-30B-A3B on the card. Full depth: its
    30,532,110,336 parameters seeded in bf16 (`init_from_schema`, 61.06
    GB), then `greedy_decode` twice (batch 4, a 4064-token prompt from
    `make_batch`, 32 tokens; every attention call on B9 at H / HK = 8,
    exactly 48 x 33 launches a call; every FFN the routed experts of
    `models.moe`, the gather dispatch), byte-identical tokens and
    logits; the prefill alone for the split; one decode step and one
    prefill traced, the routing / gather kernels a group of their own.
    Merged at Q3_MERGE_LAYERS: a base and Q3_K contributions (base + 0.1
    x a seeded delta) go to two replicas in opposite orders, each
    resolves histogram TIES and weight_average on the kernel routes
    (`engine.merge(..., kernels=True)` over its canonical order, B1 and
    B3-B5 on the multi-leaf groups, the expert leaves alone in theirs on
    the exact path) to byte-identical trees, and the TIES trees serve
    byte-identical tokens and logits; at Q3_PLAIN_LAYERS the served
    forward with B9 against its plain version, and the gather dispatch
    against the einsum one. Last, `qwen3_int8`."""
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.core.resolve import canonical_order, seed_from_root
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params
    from repro_torch.models.schema import init_from_schema
    from repro_torch.strategies import get_strategy
    from repro_torch.train.serve import greedy_decode
    cfg = get_config(QWEN3)
    model = Model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_from_schema(model.schema(), seed=SEED, device=DEVICE,
                              dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(params))
    if n != count_params(cfg)[0]:
        raise AssertionError(f"{n} parameters, count_params says "
                             f"{count_params(cfg)[0]}")
    experts = params["blocks"]["sub0"]["ffn"]["experts"]["w_gate"]
    log(f"[qwen3-moe] {cfg.name}: {n} bf16 parameters ({n * 2 / 1e9:.2f} "
        f"GB; {cfg.n_layers} layers of attention ({cfg.n_heads} query / "
        f"{cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}) and "
        f"{cfg.moe.num_experts} experts, top-{cfg.moe.top_k}; a stacked "
        f"expert leaf {list(experts.shape)}, {experts.numel()} elements) "
        f"seeded in {time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del experts
    batch = serve_batch(cfg, SERVE_BATCH, SERVE_PROMPT)
    per_call = cfg.n_layers * (SERVE_GEN + 1)
    out = {}

    def serve(label, m, p, b=batch):
        def thunk():
            out[label] = greedy_decode(m, p, b, SERVE_GEN,
                                       return_logits=True)
        return thunk

    calls = [("greedy_decode 1", serve("1", model, params)),
             ("greedy_decode 2", serve("2", model, params))]
    torch.cuda.reset_peak_memory_stats()
    path = run_path("qwen3-moe", calls, expect={
        label: {"flash_attention": per_call} for label, _ in calls})
    serve_peak = torch.cuda.max_memory_allocated()
    (tok1, lg1), (tok2, lg2) = out.pop("1"), out.pop("2")
    check_served("qwen3-moe", tok1, lg1[-1], cfg, SERVE_BATCH, SERVE_GEN)
    if not (torch.equal(tok1, tok2) and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(lg1, lg2))):
        raise AssertionError("[qwen3-moe] two greedy_decode calls differ")
    total = path["ms"]["greedy_decode 2"] / 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch,
                                   max_len=SERVE_PROMPT + SERVE_GEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    decode_ms = (total - t_prefill) * 1e3 / SERVE_GEN
    log(f"[qwen3-moe] {cfg.n_layers} layers, batch {SERVE_BATCH}, prompt "
        f"{SERVE_PROMPT} (expert capacity {_q3_capacity(cfg, SERVE_PROMPT)} "
        f"slots a prefill group, {_q3_capacity(cfg, 1)} a decode step), "
        f"{SERVE_GEN} tokens: {per_call} B9 launches a call; tokens and "
        f"all {SERVE_GEN + 1} logits byte-identical across the two calls; "
        f"greedy_decode {path['ms']['greedy_decode 1'] / 1e3:.3f} s (first "
        f"call), {total:.3f} s (second) = prefill {t_prefill:.3f} s (timed "
        f"alone) + {decode_ms:.2f} ms per decode step; "
        f"{SERVE_BATCH * SERVE_GEN / total:.1f} generated tokens/s "
        f"({SERVE_BATCH * SERVE_GEN / (total - t_prefill):.1f} after the "
        f"prefill); peak {serve_peak / 1e9:.2f} GB over the two calls; "
        f"tokens[0] {tok1[0].tolist()}")
    q3_drops(model, params, batch)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    trace_device("decode step", lambda: model.decode_step(
        params, caches, tok, SERVE_PROMPT), tag="qwen3-moe", routing=True)
    del caches, logits, lg1, lg2
    trace_device("prefill", lambda: model.prefill(
        params, batch, max_len=SERVE_PROMPT + SERVE_GEN), tag="qwen3-moe",
        routing=True)
    del params, calls      # the thunks hold the 61 GB of weights too
    torch.cuda.empty_cache()

    # merged at Q3_MERGE_LAYERS through two replicas on the kernel
    # routes, then served
    cfg2 = cfg.replace(n_layers=Q3_MERGE_LAYERS)
    t0 = time.perf_counter()
    base, contribs = make_models(cfg2, DEVICE, k=Q3_K)
    rep_a = Replica("qwen3-a", device=DEVICE)
    eids = [rep_a.contribute(c) for c in contribs]
    ref_a = rep_a.register_base(base)
    rep_b = Replica("qwen3-b", device=DEVICE)
    for c, eid in zip(contribs[::-1], eids[::-1]):
        rep_b.contribute(c, eid)
    ref_b = rep_b.register_base(base)
    if rep_a.merkle_root() != rep_b.merkle_root() or ref_a != ref_b:
        raise AssertionError("[qwen3-moe] the two replicas disagree on "
                             "Layer 1")
    del contribs
    log(f"[qwen3-moe] merged, {Q3_MERGE_LAYERS} layers: {Q3_K} "
        f"contributions + base ({sum(t.numel() for t in pytree.leaves(base))}"
        f" bf16 parameters a model) on two replicas in "
        f"{time.perf_counter() - t0:.1f} s")
    merged = {}

    def kernel_merge(label, rep, ref, name, cfgd, uses_base):
        def thunk():
            order = canonical_order(rep.state)
            spec = MergeSpec(name, cfgd, base_ref=ref if uses_base else None)
            merged[label] = engine.merge(
                [rep.state.store[e] for e in order], spec=spec,
                contrib_ids=order, base=base if uses_base else None,
                seed=seed_from_root(rep.merkle_root()), kernels=True,
                use_cache=False, cache=rep.cache)
            check_output(f"qwen3 {label}", merged[label], base)
        return thunk

    merges = [(f"{name} {rl}", kernel_merge(f"{name} {rl}", rep, ref, name,
                                            cfgd, ub))
              for name, cfgd, ub in (STRATEGIES[2], STRATEGIES[0])
              for rl, rep, ref in (("A", rep_a, ref_a), ("B", rep_b, ref_b))]
    merge_path = run_path("qwen3-moe merge", merges)
    for name in ("ties", "weight_average"):
        differ = same_bytes(merged[f"{name} A"], merged[f"{name} B"])
        if differ:
            raise AssertionError(f"[qwen3-moe] {name}: the replicas' trees "
                                 f"differ in {differ} leaves")
    plan = engine.plan_for([rep_a.state.store[e] for e in eids],
                           contrib_ids=eids,
                           spec=MergeSpec("weight_average"))
    groups = engine._dispatch_groups(
        get_strategy("weight_average"), list(plan.tasks),
        max(t.stacked_nbytes for t in plan.tasks))
    log(f"[qwen3-moe] merged, {Q3_MERGE_LAYERS} layers: replicas A and B "
        "(opposite orders) resolve histogram TIES and weight_average on "
        "the kernel routes to byte-identical trees; groups "
        f"{[len(g) for g in groups]} (leaves alone take the exact path)")
    # the thunks hold the replicas (their contributions) and the base
    del rep_a, rep_b, base, merges, plan, merged["weight_average A"], \
        merged["weight_average B"]
    model2 = Model(cfg2)
    per2 = cfg2.n_layers * (SERVE_GEN + 1)
    calls = [(f"greedy_decode merged {rl}",
              serve(rl, model2, merged[f"ties {rl}"])) for rl in ("A", "B")]
    served_path = run_path("qwen3-moe", calls, expect={
        label: {"flash_attention": per2} for label, _ in calls})
    (ta, la), (tb, lb) = out.pop("A"), out.pop("B")
    check_served("qwen3-moe merged", ta, la[-1], cfg2, SERVE_BATCH,
                  SERVE_GEN)
    if not (torch.equal(ta, tb) and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(la, lb))):
        raise AssertionError("[qwen3-moe] the replicas' merged trees "
                             "served different tokens or logits")
    log(f"[qwen3-moe] merged TIES trees serve byte-identical tokens and "
        f"logits ({per2} B9 launches each); tokens[0] {ta[0].tolist()}")
    del merged, out, la, lb, calls
    torch.cuda.empty_cache()
    cfgp = cfg.replace(n_layers=Q3_PLAIN_LAYERS)
    served_vs_plain(cfgp, batch, "qwen3-vs-plain")
    served_vs_plain(cfgp, batch, "qwen3-gather-vs-einsum",
                    other=lambda c: Model(c, moe_impl="einsum"),
                    what="gather vs einsum dispatch")
    int8 = qwen3_int8(cfg)
    launches = {k: path["launches"][k] + merge_path["launches"][k]
                + served_path["launches"][k] + int8["launches"][k]
                for k in path["launches"]}
    return {"launches": launches,
            "ms": {**path["ms"], **merge_path["ms"], **served_path["ms"],
                   **int8["ms"]}}


def _q3_capacity(cfg, s: int) -> int:
    from repro_torch.models.moe import _capacity
    return _capacity(cfg.moe, s)


def q3_drops(model, params, batch) -> None:
    """The routing of the served prompt's first MoE layer, read apart:
    the share of assignments dropped at the capacity (prefill groups
    are batch rows of SERVE_PROMPT tokens)."""
    from repro_torch import pytree
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    cfg = model.cfg
    with torch.inference_mode():
        bp = pytree.tree_map(lambda t: t[0], params["blocks"]["sub0"])
        x = model._embed(params, batch["tokens"])
        h = L.rmsnorm(bp["pre_norm"], x, cfg.rms_eps)
        x = x + model._apply_mixer(model.layout[0], bp, h, mode="train",
                                   cache=None, pos=None)
        h = L.rmsnorm(bp["ffn_norm"], x, cfg.rms_eps)
        _, idx, aux = MOE._router(bp["ffn"], h, cfg.moe)
        c = _q3_capacity(cfg, x.shape[1])
        _, keep, _, used = MOE._dispatch(idx, cfg.moe.num_experts, c)
        dropped = int((~keep).sum())
        log(f"[qwen3-moe] routing of layer 0 of the served prompt: "
            f"capacity {c} slots an expert a group; "
            f"{dropped} of {keep.numel()} assignments dropped "
            f"({dropped / keep.numel():.4f}); slots used "
            f"{int(used.sum())} of {used.numel()}; aux {float(aux):.4f}")


def qwen3_int8(cfg) -> dict:
    """The int8 weight average over expert leaves past 2^31 elements:
    Qwen3-MoE at Q3_INT8_LAYERS of its 48 layers (each stacked expert
    leaf 11 x 128 x 2048 x 768 = 2,214,592,512 elements), a base and
    Q3_INT8_K contributions (base + 0.1 x a seeded delta) made on the
    card and compressed to int8 one at a time, contributed to a
    `Replica` (eids given) with the base registered, then weight_average
    through `engine.merge(..., kernels=True)` with a batch cap of two
    expert leaves, so every group holds more than one leaf and every
    leaf merges on arrival through B2 (`quant_nary`, no base row: the
    weight average needs none): engine_quant_leaves_merged_total counts
    every leaf and no slice is densified. Each expert leaf of the merged
    tree is held bitwise against `quant_nary_ref` on three block-aligned
    windows, [0, 2^20), [2^31 - 2^20, 2^31 + 2^20) and [N - 2^20, N), on
    the payloads' own int8 rows and scales."""
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.core import engine
    from repro_torch.core.compression import compress_tree
    from repro_torch.core.resolve import canonical_order, seed_from_root
    from repro_torch.kernels.ref import quant_nary_ref
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    cfgq = cfg.replace(n_layers=Q3_INT8_LAYERS)
    schema = Model(cfgq).schema()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = init_from_schema(schema, seed=SEED, device=DEVICE,
                            dtype=torch.bfloat16)
    cts = []
    for j in range(Q3_INT8_K):
        delta = init_from_schema(schema, seed=SEED + 1 + j, device=DEVICE,
                                 dtype=torch.bfloat16)
        c = pytree.tree_map(lambda b, d: b + d * 0.1, base, delta)
        del delta
        cts.append(compress_tree(c))
        del c
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(base))
    big = max(t.numel() for t in pytree.leaves(base))
    log(f"[qwen3-moe] int8, {Q3_INT8_LAYERS} layers: a base ({n} bf16 "
        f"parameters, {n * 2 / 1e9:.2f} GB; each expert leaf {big} "
        f"elements, {'past' if big > 2 ** 31 else 'within'} 2^31) and "
        f"{Q3_INT8_K} contributions made and compressed to int8 on the "
        f"card ({sum(ct.nbytes() for ct in cts) / 1e9:.2f} GB of payloads) "
        f"in {time.perf_counter() - t0:.1f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rep = Replica("qwen3-int8", device=DEVICE)
    t0 = time.perf_counter()
    for j, ct in enumerate(cts):
        rep.contribute(ct, int8_eid(f"qwen3-moe contribution {j}",
                                    Q3_INT8_LAYERS))
    ref = rep.register_base(base)
    log(f"[qwen3-moe] int8: {Q3_INT8_K} payloads contributed (eids "
        "given; planning digests each dequantized leaf) and the base "
        f"registered ({ref[:16]}…) in {time.perf_counter() - t0:.1f} s")
    del cts
    order = canonical_order(rep.state)
    payloads = [rep.state.store[e] for e in order]
    cap = 2 * Q3_INT8_K * big
    disp = Dispatches(rep.cache.obs)
    merged_before = rep.cache.obs.counter(
        "engine_quant_leaves_merged_total").value()
    dequant_before = rep.cache.stats["dequant_leaves"]
    out = {}

    def thunk():
        out["tree"] = engine.merge(
            payloads, spec=MergeSpec("weight_average"), contrib_ids=order,
            seed=seed_from_root(rep.merkle_root()), kernels=True,
            use_cache=False, max_batch_bytes=cap, cache=rep.cache)

    torch.cuda.reset_peak_memory_stats()
    path = run_path("qwen3-moe int8", [("weight_average", thunk)], disp)
    peak = torch.cuda.max_memory_allocated()
    tree = out.pop("tree")
    check_output("qwen3 int8 weight_average", tree, base)
    nleaves = len(pytree.leaves(base))
    merged = rep.cache.obs.counter(
        "engine_quant_leaves_merged_total").value() - merged_before
    dequant = rep.cache.stats["dequant_leaves"] - dequant_before
    if merged != nleaves or dequant != 0 or \
            path["launches"]["quant_nary"] < 1:
        raise AssertionError(
            f"[qwen3-moe] int8: {merged} of {nleaves} leaves merged on "
            f"arrival, {dequant} slices densified, "
            f"{path['launches']['quant_nary']} quant_nary launches")
    w = torch.full((Q3_INT8_K,), 1.0 / Q3_INT8_K, dtype=torch.float32,
                   device=DEVICE)
    flat = dict(zip(pytree.leaf_paths(pytree.flatten(base)[1]),
                    pytree.leaves(tree)))
    qflat = [dict(zip(pytree.leaf_paths(p.treedef), p.leaves))
             for p in payloads]
    checked = []
    for path_ in EXPERT_LEAVES:
        got = flat[path_].reshape(-1)
        nn = got.numel()
        rows = [q[path_] for q in qflat]
        scales = torch.stack([r.scale for r in rows]).to(torch.float32)
        for lo, hi in ((0, Q3_WINDOW), (2 ** 31 - Q3_WINDOW,
                                        2 ** 31 + Q3_WINDOW),
                       (nn - Q3_WINDOW, nn)):
            lo, hi = max(lo, 0), min(hi, nn)
            if lo >= hi:
                raise AssertionError(f"[qwen3-moe] int8 {path_}: no "
                                     f"window at [{lo}, {hi})")
            q = torch.stack([r.q.reshape(-1)[lo:hi] for r in rows])
            want = quant_nary_ref(q, scales, torch.zeros(
                hi - lo, dtype=torch.float32, device=DEVICE), w).to(
                got.dtype)
            if not torch.equal(bits(got[lo:hi]), bits(want)):
                raise AssertionError(f"[qwen3-moe] int8 {path_} [{lo}, "
                                     f"{hi}) != quant_nary_ref")
            checked.append((lo, hi))
    log(f"[qwen3-moe] int8 weight_average over {Q3_INT8_K} payloads, "
        f"{Q3_INT8_LAYERS} layers: {merged:.0f} of {nleaves} leaves merged "
        f"on arrival (engine_quant_leaves_merged_total), {dequant} slices "
        f"densified, quant_nary launches {path['launches']['quant_nary']} "
        f"(batch cap {cap / 1e9:.2f} GB: two expert leaves); peak "
        f"{peak / 1e9:.2f} GB; each of the {len(EXPERT_LEAVES)} expert "
        f"leaves bitwise quant_nary_ref on the windows {checked[:3]}")
    del tree, flat, qflat, payloads, rep, base
    torch.cuda.empty_cache()
    return path


def phase_qwen3_flash_kernel(rows: dict, g) -> None:
    """B9 at Qwen3-MoE's serving shapes (32 query heads over 4 KV heads
    of 128: H / HK = 8), held against its plain version and timed beside
    `scaled_dot_product_attention(enable_gqa=True)`: the prefill's q
    [4, 4064, 32, 128], k, v [4, 4064, 4, 128], causal, bf16 and fp32;
    a decode step's q [4, 1, 32, 128] over a 4096-slot cache at
    q_offset 4063 (the decode design's 16-row instance with 8 rows
    live)."""
    from repro_torch.configs import get_config
    cfg = get_config(QWEN3)
    dev = torch.device(DEVICE)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    cases = {}
    for tag, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        qkv = [randn(SERVE_BATCH, SERVE_PROMPT, n, d, dtype=dtype)
               for n in (h, hk, hk)]
        cases[f"qwen3 prefill {tag}"] = flash_case(
            *qkv, 0, floor=FLASH_BF16_FLOOR["gemma2"])
        del qkv
        torch.cuda.empty_cache()
    q = randn(SERVE_BATCH, 1, h, d)
    kv = [randn(SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, hk, d)
          for _ in range(2)]
    cases["qwen3 decode bf16"] = flash_case(q, *kv, SERVE_PROMPT - 1)
    del q, kv
    torch.cuda.empty_cache()
    rows["flash_attention"].update(cases)


def phase_qwen3_quant_kernel(rows: dict, g) -> None:
    """B2 on a batch of one Qwen3-MoE expert leaf at Q3_INT8_LAYERS
    layers, Q3_INT8_K int8 rows of 2,214,592,512 elements (past 2^31),
    without a base row (the weight average's launch): bitwise against
    its plain version over the whole output, then timed."""
    from repro_torch.kernels import quant as Q
    from repro_torch.kernels.config import kernel_env
    from repro_torch.configs import get_config
    cfg = get_config(QWEN3)
    dev = torch.device(DEVICE)
    block = kernel_env.block
    n = Q3_INT8_LAYERS * cfg.moe.num_experts * cfg.d_model \
        * cfg.moe.d_ff_expert
    k = Q3_INT8_K
    q = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                      dtype=torch.int8)
    scales = torch.rand((k,), generator=g, device=dev) * 1e-3 + 1e-5
    smeta = scales.expand(n // block, k).contiguous()
    w = torch.full((k,), 1.0 / k, device=dev)
    log(f"[kernels] quant_nary on a Qwen3-MoE expert leaf at "
        f"{Q3_INT8_LAYERS} layers: [{k}, {n}] int8 ({n - 2 ** 31} columns "
        "past 2^31), no base row")
    hold_and_time(rows, "quant_nary",
                  lambda: Q.quant_nary(q, None, smeta, w, block),
                  lambda: Q.quant_nary_plain(q, None, smeta, w, block),
                  k * n + n * 4 + smeta.numel() * 4 + k * 4, 4 * k * n,
                  "src/repro_torch/csrc/quant.cu",
                  "src/repro/kernels/quant.py:36",
                  library_note=NO_LIBRARY["quant_nary"],
                  into="qwen3 expert leaf")
    del q, smeta
    torch.cuda.empty_cache()


def search_path(ordered, order, base, ref, seed, cache) -> dict:
    """genetic_merge and evolutionary_merge through `engine.merge` on
    the main path's bf16 contributions at full depth: whole-model
    dispatches that launch no kernel (the counts must not move)."""
    from repro_torch.api import MergeSpec
    from repro_torch.core import engine

    def merge(name):
        def thunk():
            out = engine.merge(ordered, spec=MergeSpec(name, base_ref=ref),
                               contrib_ids=order, base=base, seed=seed,
                               use_cache=False, cache=cache)
            check_output(name, out, base)
        return name, thunk
    before = cache.stats["whole_model_dispatches"]
    out = run_path("search", [merge(n) for n in SEARCH],
                   expect={n: {} for n in SEARCH})
    if cache.stats["whole_model_dispatches"] != before + len(SEARCH):
        raise AssertionError("the search merges did not take the "
                             "whole-model route")
    return out


def sparse_reresolve(cfg, ordered, order, base, eid_s: str) -> dict:
    """The adapter update landing on a warm replica: A holds the K
    dense contributions and the base and resolves weight_average (cold);
    then S is made, lands through `contribute(leaves=...)` and A resolves
    again (warm): exactly the 4 attention leaves run, each resuming its
    cached fold, and the other 8 are cache hits. The warm tree must be
    bitwise the cold resolve of the same state and replica B's, which
    took the five contributions in reverse order under A's eids.
    Returns S."""
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.obs import set_tracer, Tracer
    rep_a = Replica("chip-smoke-sparse-a", device=DEVICE)
    for c, eid in zip(ordered, order):
        rep_a.contribute(c, eid)
    t0 = time.perf_counter()
    ref = rep_a.register_base(base)
    t_base = time.perf_counter() - t0
    rep_a.set_cache_limit(bytes=SPARSE_CACHE_BYTES)
    spec = MergeSpec("weight_average", base_ref=ref)

    def timed(label, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tracer = Tracer()
        prev = set_tracer(tracer)
        t0 = time.perf_counter()
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            set_tracer(prev)
        dt = time.perf_counter() - t0
        split = {sp.name: sp.duration for sp in tracer.spans
                 if sp.name in ("engine.plan", "engine.execute")}
        log(f"[sparse] {label}: {dt:.1f} s (planning, the base's digest "
            f"included, {split.get('engine.plan', 0):.1f} s; executing "
            f"{split.get('engine.execute', 0):.1f} s; the rest, the "
            "element digests of a payload first seen and Layer 1, "
            f"{dt - sum(split.values()):.1f} s); peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        return out, dt

    cold, t_cold = timed("replica A, cold resolve of K dense "
                         "contributions", lambda: rep_a.resolve(spec))
    del cold
    # S is made after the cold resolve: its 2.42 GB would sit beside the
    # cache's 23 GB there
    t0 = time.perf_counter()
    upd = sparse_update(cfg, base, SEED + 50)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(upd))
    log(f"[sparse] adapter update S over {len(SPARSE_LEAVES)} attention "
        f"leaves: {n} parameters ({n * 2 / 1e9:.2f} GB bf16), made in "
        f"{time.perf_counter() - t0:.1f} s; eid {eid_s[:16]}… (sorts "
        "last)")
    rep_a.cache.reset_exec_stats()
    obs = rep_a.cache.obs
    folds = obs.counter("resolve_fold_updates_total").value()
    rep_a.contribute(upd, eid_s, leaves=SPARSE_LEAVES)
    warm, t_warm = timed("replica A, warm resolve after S lands",
                         lambda: rep_a.resolve(spec))
    st = rep_a.cache.exec_stats()
    got = {"leaf_tasks": st.get("leaf_tasks", 0), "hits": st.get("hits", 0),
           "fold_resumes": st.get("fold_resumes", 0),
           "resolve_fold_updates_total":
               obs.counter("resolve_fold_updates_total").value() - folds,
           "engine_sparse_leaves_skipped":
               obs.gauge("engine_sparse_leaves_skipped").value()}
    want = {"leaf_tasks": 4, "hits": 8, "fold_resumes": 4,
            "resolve_fold_updates_total": 4.0,
            "engine_sparse_leaves_skipped": 8.0}
    log(f"[sparse] warm accounting {got}; warm / cold seconds "
        f"{t_warm / t_cold:.2f} (a reading; register_base took "
        f"{t_base:.1f} s)")
    if got != want:
        raise AssertionError(f"warm re-resolve accounting {got} != {want}")
    rep_a.clear_cache()
    cold, _ = timed("replica A, cold resolve of the same state "
                    "(use_cache=False)",
                    lambda: rep_a.resolve(spec, use_cache=False))
    differ = same_bytes(warm, cold)
    del cold
    rep_b = Replica("chip-smoke-sparse-b", device=DEVICE)
    for c, eid in zip([upd] + ordered[::-1], [eid_s] + order[::-1]):
        rep_b.contribute(c, eid,
                         leaves=SPARSE_LEAVES if eid == eid_s else None)
    if rep_b.register_base(base) != ref or \
            rep_b.merkle_root() != rep_a.merkle_root():
        raise AssertionError("the two replicas disagree on Layer 1")
    other, _ = timed("replica B (reverse order, A's eids), resolve",
                     lambda: rep_b.resolve(spec))
    differ_b = same_bytes(warm, other)
    log(f"[sparse] the warm tree vs A's cold resolve: {differ} leaves "
        f"differ; vs replica B's: {differ_b} (bitwise, int16 views)")
    if differ or differ_b:
        raise AssertionError("the re-resolve is not bitwise the cold "
                             "resolve / replica B's")
    del warm, other, rep_a, rep_b
    torch.cuda.empty_cache()
    return upd


def sparse_path(cfg, ordered, order, base) -> dict:
    """The adapter-update scenario of benchmarks/bench_sparse.py at
    Phi-3-mini's full width: the re-resolve (`sparse_reresolve`), then
    `engine.merge(..., coverages=..., kernels=True)` over the K dense
    contributions and S in canonical order for weight_average,
    task_arithmetic and histogram TIES: the attention leaves' fused
    groups have K + 1 contributions, the others K, so B1 and B3-B5
    launch at both heights in one merge."""
    from repro_torch.api import MergeSpec
    from repro_torch.core import engine
    from repro_torch.core.merkle import merkle_root
    from repro_torch.core.resolve import seed_from_root
    from repro_torch.strategies import get_strategy
    eid_s = sparse_eid(cfg.n_layers)
    if eid_s <= max(order):
        raise AssertionError("S's eid does not sort after the dense ones")
    upd = sparse_reresolve(cfg, ordered, order, base, eid_s)
    ids = sorted(list(order) + [eid_s])
    by_id = dict(zip(order, ordered))
    by_id[eid_s] = upd
    payloads = [by_id[i] for i in ids]
    covs = [SPARSE_LEAVES if i == eid_s else None for i in ids]
    seed = seed_from_root(merkle_root([bytes.fromhex(i) for i in ids]))
    # the engine's own grouping: fused groups of K + 1 and of K rows
    plan = engine.plan_for(payloads, contrib_ids=ids, coverages=covs,
                           spec=MergeSpec("weight_average"))
    groups = [grp for grp in engine._dispatch_groups(
        get_strategy("weight_average"), list(plan.tasks),
        max(t.stacked_nbytes for t in plan.tasks)) if len(grp) > 1]
    heights = sorted({grp[0].k for grp in groups})
    log("[sparse] fused groups (k_i: leaves): " + "; ".join(
        f"{grp[0].k}: {[t.path.split('[')[-1][1:-2] for t in grp]}"
        for grp in groups) + f"; {len(plan.tasks) - sum(map(len, groups))} "
        "leaves alone (exact path)")
    if heights != [K, K + 1]:
        raise AssertionError(f"fused groups of heights {heights}, expected "
                             f"{[K, K + 1]}")
    nb = len(groups)
    cache = engine.EngineCache()

    def merge_of(name, cfgd, uses_base):
        def thunk():
            spec = MergeSpec(name, cfgd)
            out = engine.merge(payloads, spec=spec, contrib_ids=ids,
                               base=base if uses_base else None, seed=seed,
                               kernels=True, use_cache=False,
                               coverages=covs, cache=cache)
            check_output(name, out, base)
        return name, thunk

    expect = {name: ({"block_amax": nb, "block_hist": nb, "ties_block": nb}
                     if name == "ties" else {"nary_accum": nb})
              for name, _, _ in STRATEGIES}
    out = run_path("sparse", [merge_of(*st) for st in STRATEGIES],
                   Dispatches(cache.obs), expect=expect)
    del upd, payloads, by_id
    torch.cuda.empty_cache()
    return out


def gossip_payloads(n: int, side: int, seed: int) -> list:
    """bench_gossip's contributions: one [side, side] fp32 normal draw a
    node from `numpy.random.default_rng(seed)`, on the card, with their
    eids (hashed once: the orderings reuse them)."""
    import numpy as np
    from repro_torch.core.hashing import pytree_digest
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.standard_normal((side, side)).astype(
        np.float32)).to(DEVICE) for _ in range(n)]
    return [(x, pytree_digest(x).hex()) for x in xs]


def gossip_net(n: int, seed: int, payloads, **kw):
    from repro_torch.core.gossip import GossipNetwork
    net = GossipNetwork(n, seed=seed, device=DEVICE, **kw)
    for node, (x, eid) in zip(net.nodes, payloads):
        node.contribute(x, eid)
    return net


def identical(outs) -> bool:
    return all(torch.equal(bits(outs[0]), bits(o)) for o in outs[1:])


def divergence(probe, net) -> float:
    """One `ConvergenceProbe` observation of the fleet's roots: the
    `probe_root_divergence` it sets (distinct roots - 1)."""
    probe.observe({n.node_id: n.root().hex() for n in net.nodes})
    return probe.registry.gauge("probe_root_divergence").value()


def round_probe(net):
    from repro_torch.obs import ConvergenceProbe
    clock = iter(range(1 << 20))
    return ConvergenceProbe(registry=net.obs, clock=clock.__next__)


def phase_gossip_tables() -> None:
    """The paper's Tables 6-9 (benchmarks/bench_gossip.py --full) on the
    card: gossip rounds, then every node resolves on its own; no merge
    kernel runs (the reference's nodes resolve on the exact path)."""
    from repro_torch.strategies import list_strategies
    out = {}

    def table6():
        pl = gossip_payloads(T6_NODES, T6_SIDE, 123)
        final, g_ms, r_ms, div = None, [], [], set()
        for o in range(T6_ORDERINGS):
            net = gossip_net(T6_NODES, o, pl)
            probe = round_probe(net)
            before = divergence(probe, net)
            t0 = time.perf_counter()
            net.all_pairs_round()
            g_ms.append((time.perf_counter() - t0) * 1e3)
            div.add((before, divergence(probe, net)))
            if not net.converged():
                raise AssertionError(f"table 6 ordering {o}: not converged")
            t0 = time.perf_counter()
            outs = net.resolve_all("slerp", use_cache=False)
            torch.cuda.synchronize()
            r_ms.append((time.perf_counter() - t0) * 1e3 / T6_NODES)
            if final is None:
                final = outs[0]
            if not identical([final] + outs):
                raise AssertionError(f"table 6 ordering {o}: outputs differ")
            del outs
        out["6"] = (f"{T6_NODES} nodes, {T6_SIDE}x{T6_SIDE} fp32, "
                    f"{T6_ORDERINGS} orderings, slerp: every node's and "
                    "every ordering's output byte-identical; gossip "
                    f"{sum(g_ms) / len(g_ms):.1f} ms a round, resolve "
                    f"{sum(r_ms) / len(r_ms):.2f} ms a node; probe "
                    f"divergence before / after the round {sorted(div)}")

    def table7():
        pl = gossip_payloads(T7_NODES, T7_SIDE, 0)
        net = gossip_net(T7_NODES, 0, pl)
        probe = round_probe(net)
        div = [divergence(probe, net)]
        size = T7_NODES // T7_PARTS
        net.partition([range(i * size, (i + 1) * size)
                       for i in range(T7_PARTS)])
        t0 = time.perf_counter()
        net.all_pairs_round()
        part_ms = (time.perf_counter() - t0) * 1e3
        div.append(divergence(probe, net))
        distinct = len(set(net.roots()))
        net.heal()
        t0 = time.perf_counter()
        net.all_pairs_round()
        heal_ms = (time.perf_counter() - t0) * 1e3
        div.append(divergence(probe, net))
        healed = len(set(net.roots()))
        if distinct != T7_PARTS or healed != 1 or not net.converged():
            raise AssertionError(f"table 7: {distinct} roots in "
                                 f"{T7_PARTS} partitions, {healed} after "
                                 "the heal")
        out["7"] = (f"{T7_NODES} nodes in {T7_PARTS} partitions: "
                    f"{distinct} distinct roots, {healed} after the heal; "
                    f"partitioned round {part_ms:.1f} ms, healing round "
                    f"{heal_ms:.1f} ms; probe divergence by round {div}, "
                    f"episodes {probe.episodes}")

    def table8():
        pl = gossip_payloads(T8_NODES, T8_SIDE, 7)
        ok, slow = 0, []
        for name in list_strategies():
            net = gossip_net(T8_NODES, 1, pl)
            net.all_pairs_round()
            t0 = time.perf_counter()
            outs = net.resolve_all(name, use_cache=False)
            torch.cuda.synchronize()
            slow.append(((time.perf_counter() - t0) * 1e3 / T8_NODES, name))
            ok += identical(outs)
        if ok != len(list_strategies()):
            raise AssertionError(f"table 8: {ok} strategies converge")
        slow.sort(reverse=True)
        out["8"] = (f"{T8_NODES} nodes, {T8_SIDE}x{T8_SIDE}: {ok} of "
                    f"{len(list_strategies())} strategies byte-identical "
                    "on every node; resolve ms a node, slowest: "
                    + ", ".join(f"{n} {ms:.1f}" for ms, n in slow[:3]))

    def table9():
        pl = gossip_payloads(max(T9_SIZES), T9_SIDE, 11)
        rows = []
        for n in T9_SIZES:
            net = gossip_net(n, 2, pl[:n])
            probe = round_probe(net)
            before = divergence(probe, net)
            t0 = time.perf_counter()
            net.all_pairs_round()
            g_ms = (time.perf_counter() - t0) * 1e3
            after = divergence(probe, net)
            t0 = time.perf_counter()
            outs = net.resolve_all("slerp", use_cache=False)
            torch.cuda.synchronize()
            r_ms = (time.perf_counter() - t0) * 1e3
            if not (net.converged() and identical(outs)):
                raise AssertionError(f"table 9: {n} nodes did not converge")
            rows.append(f"n={n} ({n * (n - 1)} merges) gossip {g_ms:.1f} "
                        f"ms, resolve {r_ms:.1f} ms, divergence {before:.0f}"
                        f" -> {after:.0f}")
        for n in T9_SIZES[-2:]:
            net = gossip_net(n, 3, pl[:n])
            probe = round_probe(net)
            div = [divergence(probe, net)]
            t0 = time.perf_counter()
            rounds = 0
            while not net.converged() and rounds < 64:
                net.epidemic_round(fanout=3)
                rounds += 1
                div.append(divergence(probe, net))
            e_ms = (time.perf_counter() - t0) * 1e3
            if not net.converged():
                raise AssertionError(f"table 9: epidemic n={n} did not "
                                     "converge")
            rows.append(f"epidemic n={n} fanout 3: {rounds} rounds, "
                        f"{e_ms:.1f} ms, divergence by round "
                        f"{[int(d) for d in div]}")
        out["9"] = "; ".join(rows)

    tables = [("table 6", table6), ("table 7", table7),
              ("table 8", table8), ("table 9", table9)]
    run_path("gossip", tables, expect={label: {} for label, _ in tables})
    for t in sorted(out):
        log(f"[gossip] Table {t}: {out[t]}")
    torch.cuda.empty_cache()


def peak_rss_gb() -> float:
    """The process's peak resident set so far (Linux reports KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def frames_by_type(transport) -> dict:
    """{message type: (frames, bytes)} from the transport's
    `net_frames_total` / `net_bytes_total` series."""
    from repro_torch.net import wire
    f = transport.obs.counter("net_frames_total")
    b = transport.obs.counter("net_bytes_total")
    out = {}
    for cls in wire.MESSAGE_TYPES.values():
        n = int(f.value(type=cls.__name__))
        if n:
            out[cls.__name__] = (n, int(b.value(type=cls.__name__)))
    return out


def frames_since(transport, before: dict) -> dict:
    now = frames_by_type(transport)
    return {k: (n - before.get(k, (0, 0))[0], nb - before.get(k, (0, 0))[1])
            for k, (n, nb) in now.items()
            if n != before.get(k, (0, 0))[0]}


def sha256_gbps(chunk) -> float:
    """One thread's SHA-256 rate over a chunk-sized buffer (the rate the
    receiver verifies each ChunkData at)."""
    t0 = time.perf_counter()
    for _ in range(16):
        hashlib.sha256(chunk).digest()
    return 16 * len(chunk) / (time.perf_counter() - t0) / 1e9


def phase_durable(cts: list, eids, held: dict) -> dict:
    """`[durable]`: the main path's K int8 payloads (compressed on the
    card; DURABLE_LAYERS of their layers, as `first_layers` cuts them)
    under their eids, journaled, recovered, synced and merged on
    arrival, at Phi-3-mini's full width.

    An in-memory replica resolves weight_average with the kernels over
    them (B2) and over `decompress_tree` of them (B1), and on the exact
    path (`Replica.resolve`, the fetch-on-resolve reference). Replica A
    (`Replica(path=)` in a fresh temporary directory) contributes them
    with `element_id` and registers the base; closed and reopened, it
    must recover A's Merkle root and visible set (`cts` is emptied then:
    its tensors are freed). A, its DurableStore handed to
    `SyncNode("durable-a")`, and replica B on a `keep_quantized` node
    meet on one `PersistentLoopbackTransport`: B's session with A must
    bring B to A's root with the four payloads int8 on the card, every
    chunk shipped once; a second session only SyncReq and SyncDone.
    Replica C, a client outside the storage domain (placement over A and
    B, r = 2), takes Layer 1 from A with no blob frame, then resolves
    weight_average through a fetch hook that pulls the payloads from A
    and B by multi-source chunk fetch (`resolve_blob_pulls` 4), byte-
    identical to the in-memory exact resolve; with the kernels over C's
    store (B2); after `shed_blobs` a second resolve is a cache hit that
    pulls and ships nothing. The base goes before C's step (`held` holds
    the last reference; bases are not journaled, so the reopened A has
    none): weight_average needs none. Last, B's payloads
    decompressed on arrival by `msg_to_state` (B1). Each kernel resolve
    must be byte-identical to the in-memory one."""
    import shutil
    import tempfile
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.core import engine
    from repro_torch.core.compression import CompressedTree, decompress_tree
    from repro_torch.core.resolve import canonical_order, seed_from_root
    from repro_torch.net import (
        PersistentLoopbackTransport, Placement, pump, SyncNode, wire)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    path = os.path.join(workdir, "replica_a")
    free = shutil.disk_usage(workdir).free
    shapes = pytree.tree_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), held["base"])
    log(f"[durable] journal directory {workdir}: {free / 1e9:.1f} GB free; "
        f"{K} int8 payloads ({sum(ct.nbytes() for ct in cts) / 1e9:.2f} "
        "GB) under the int8 path's eids")
    refs, rep, net = {}, {}, {}
    spec = MergeSpec("weight_average")

    def to_host(tree):
        return pytree.tree_map(lambda t: t.cpu(), tree)

    def weight_average(state, cache, decompress: bool = False):
        order = canonical_order(state)
        payloads = [state.store[e] for e in order]
        if decompress:
            payloads = [decompress_tree(p) for p in payloads]
        out = engine.merge(payloads, spec=spec, contrib_ids=order,
                           seed=seed_from_root(state.merkle_root()),
                           kernels=True, use_cache=False, cache=cache)
        check_output("weight_average", out, shapes)
        return out

    def against(label: str, ref: str, out) -> None:
        differ = same_bytes(refs[ref], out)
        log(f"[durable] {label}: {differ} leaves differ from the in-memory "
            f"replica's {ref} resolve")
        if differ:
            raise AssertionError(f"[durable] {label} != in-memory {ref}")

    def in_memory():
        mem = Replica("durable-mem", device=DEVICE)
        for ct, eid in zip(cts, eids):
            mem.contribute(ct, element_id=eid)
        refs["int8"] = to_host(weight_average(mem.state, mem.cache))
        t0 = time.perf_counter()
        exact = mem.resolve(spec, use_cache=False)
        torch.cuda.synchronize()
        t_exact = time.perf_counter() - t0
        check_output("weight_average", exact, shapes)
        refs["exact"] = to_host(exact)
        log(f"[durable] in-memory Replica.resolve(MergeSpec("
            f"'weight_average')) on the exact path (C's reference): "
            f"{t_exact:.1f} s")

    def in_memory_decompressed():
        mem = Replica("durable-mem", device=DEVICE)
        for ct, eid in zip(cts, eids):
            mem.contribute(ct, element_id=eid)
        refs["decompressed"] = to_host(weight_average(
            mem.state, mem.cache, decompress=True))

    def journal():
        a = Replica("durable-a", device=DEVICE, path=path)
        t0 = time.perf_counter()
        for ct, eid in zip(cts, eids):
            a.contribute(ct, element_id=eid)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        a.register_base(held["base"])
        t_base = time.perf_counter() - t0
        root, visible = a.merkle_root(), a.visible()
        a.close()
        del a
        cts.clear()          # the recovered replica decodes its own
        torch.cuda.empty_cache()
        sizes = {f: os.path.getsize(os.path.join(path, f))
                 for f in sorted(os.listdir(path))}
        total = sum(sizes.values())
        log(f"[durable] replica A: {K} contributions written through in "
            f"{t_write:.1f} s ({total / t_write / 1e9:.2f} GB/s, encode, "
            f"SHA-256, CRC-32, write and fsync); on disk {sizes} = "
            f"{total / 1e9:.2f} GB; register_base {t_base:.1f} s (bases "
            "are not journaled, as in the reference)")
        t0 = time.perf_counter()
        rep["a"] = Replica("durable-a", device=DEVICE, path=path)
        torch.cuda.synchronize()
        t_open = time.perf_counter() - t0
        ok = rep["a"].merkle_root() == root and rep["a"].visible() == visible
        log(f"[durable] replica A reopened: recovered in {t_open:.1f} s "
            f"({total / t_open / 1e9:.2f} GB/s: scan and CRC-32, SHA-256 of "
            f"each blob, decode onto the card); root "
            f"{rep['a'].merkle_root().hex()[:16]}… "
            f"equal to the root before the close: {ok}; visible "
            f"{len(rep['a'].visible())}")
        if not ok:
            raise AssertionError("[durable] recovered root or visible set "
                                 "differs from A's before the close")

    def recovered_a():
        against("recovered A, int8 kept (B2)", "int8",
                weight_average(rep["a"].state, rep["a"].cache))

    def session(t, nodes, src, dst) -> float:
        t0 = time.perf_counter()
        t.send(src.node_id, dst.node_id, src.begin_sync(dst.node_id))
        pump(nodes, t, max_steps=PUMP_STEPS)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def int8_on_card(node) -> bool:
        dev = torch.device(DEVICE).type
        return all(isinstance(node.state.store.get(e), CompressedTree)
                   and all(leaf.q.device.type == leaf.scale.device.type
                           == dev for leaf in node.state.store[e].leaves)
                   for e in eids)

    def sync_a_to_b():
        a = rep["a"]
        na = SyncNode("durable-a", device=DEVICE)
        a.attach(na)
        b = Replica("durable-b", device=DEVICE)
        nb = SyncNode("durable-b", device=DEVICE, keep_quantized=True)
        b.attach(nb)
        t = PersistentLoopbackTransport(device=DEVICE)
        net["t"] = t
        nodes = net["nodes"] = {na.node_id: na, nb.node_id: nb}
        for n in nodes.values():
            t.register(n.node_id)
        secs = session(t, nodes, nb, na)
        fr = frames_by_type(t)
        chunks = sum(-(-len(na._enc_cache[e]) // na._chunk_payload)
                     for e in eids)
        net["chunks"] = chunks
        data = fr.get("ChunkData", (0, 0))
        rate = sha256_gbps(na._enc_cache[eids[0]][:na._chunk_payload])
        log(f"[durable] sync A -> B (PersistentLoopbackTransport, B "
            f"initiates): {secs:.1f} s, {data[1] / secs / 1e9:.3f} GB/s of "
            f"ChunkData; frames and bytes by type {fr}; connections_opened "
            f"{t.connections_opened}; the manifests' chunks {chunks}; "
            f"B's chunks verified {nb.stats['chunks_verified']}, redundant "
            f"{nb.stats['chunks_redundant']}; per-chunk SHA-256 verify on "
            f"one thread at {rate:.2f} GB/s, {data[1] / rate / 1e9:.1f} s "
            f"of the session (timed apart); host peak RSS "
            f"{peak_rss_gb():.1f} GB")
        if nb.root() != na.root():
            raise AssertionError("[durable] B's root != A's after the "
                                 "session")
        if not int8_on_card(nb):
            raise AssertionError("[durable] B's payloads are not int8 "
                                 "CompressedTrees on the card")
        if data[0] != chunks or nb.stats["chunks_redundant"] \
                or nb.stats["chunks_verified"] != chunks:
            raise AssertionError(f"[durable] {data[0]} ChunkData frames for "
                                 f"{chunks} chunks")
        before = frames_by_type(t)
        secs2 = session(t, nodes, nb, na)
        second = frames_since(t, before)
        log(f"[durable] second session A -> B: {secs2 * 1e3:.1f} ms, frames "
            f"{second}")
        if set(second) != {"SyncReq", "SyncDone"}:
            raise AssertionError(f"[durable] a second session sent {second}")
        rep["b"] = b

    def wire_b():
        against("B synced, int8 kept (B2)", "int8",
                weight_average(rep["b"].state, rep["b"].cache))

    def fetch_on_resolve_c():
        t, nodes = net["t"], net["nodes"]
        na, nb = nodes["durable-a"], nodes["durable-b"]
        # weight_average needs no base: `held` holds the last reference
        held.clear()
        torch.cuda.empty_cache()
        c = Replica("durable-c", device=DEVICE)
        c.set_cache_limit(bytes=C_CACHE_BYTES)
        nc = SyncNode("durable-c", device=DEVICE,
                      placement=Placement(["durable-a", "durable-b"], r=2),
                      keep_quantized=True, chunk_timeout=30.0)
        c.attach(nc)
        t.register(nc.node_id)
        nodes[nc.node_id] = nc
        before = frames_by_type(t)
        secs = session(t, nodes, nc, na)
        layer1 = frames_since(t, before)
        blob = {k: v for k, v in layer1.items()
                if k in ("BlobReq", "BlobResp", "BlobManifest", "ChunkReq",
                         "ChunkData", "HaveReq", "HaveMap")}
        log(f"[durable] C's session with A: {secs * 1e3:.1f} ms, frames "
            f"{layer1}; C's root equal to A's: {nc.root() == na.root()}; "
            f"C holds {len(nc.state.store)} payloads")
        if nc.root() != na.root() or blob or nc.state.store:
            raise AssertionError("[durable] C's Layer-1 session shipped "
                                 f"blob frames {blob} or missed A's root")

        def fetch(node, want):
            want = tuple(e for e in want if e not in node.state.store)
            node.want_blobs(want)
            try:
                for peer, msg in node.query_holders(want):
                    t.send(node.node_id, peer, msg)
                pump(nodes, t, max_steps=PUMP_STEPS)
            finally:
                node.unwant_blobs(want)
            return {e: node.state.store[e] for e in want
                    if e in node.state.store}

        nc.fetch_hook = fetch
        served = (na.stats["chunks_served"], nb.stats["chunks_served"])
        before = frames_by_type(t)
        t0 = time.perf_counter()
        out = c.resolve(spec)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        fr = frames_since(t, before)
        by_a = na.stats["chunks_served"] - served[0]
        by_b = nb.stats["chunks_served"] - served[1]
        pulls = nc.stats["resolve_blob_pulls"]
        check_output("weight_average", out, shapes)
        data = fr.get("ChunkData", (0, 0))
        log(f"[durable] fetch-on-resolve C: C.resolve(MergeSpec("
            f"'weight_average')) {secs:.1f} s (fetch and the exact path), "
            f"resolve_blob_pulls {pulls}; ChunkData from A {by_a}, from B "
            f"{by_b} (the manifests' chunks {net['chunks']}), "
            f"{data[1] / secs / 1e9:.3f} GB/s over the resolve; frames "
            f"{fr}; chunks redundant {nc.stats['chunks_redundant']}; "
            f"connections_opened {t.connections_opened}; host peak RSS "
            f"{peak_rss_gb():.1f} GB")
        if pulls != K or not by_a or not by_b \
                or by_a + by_b != net["chunks"] or data[0] != net["chunks"] \
                or nc.stats["chunks_redundant"]:
            raise AssertionError("[durable] C's fetch: pulls or chunks off")
        if not int8_on_card(nc):
            raise AssertionError("[durable] C's payloads are not int8 "
                                 "CompressedTrees on the card")
        against("fetch-on-resolve C, exact path", "exact", out)
        # A served its last chunk: released (its storage closes with it)
        rep.pop("a").close()
        del nodes["durable-a"], na
        torch.cuda.empty_cache()
        against("C's store with the kernels (B2)", "int8",
                weight_average(c.state, c.cache))
        dropped = nc.shed_blobs()
        before = frames_by_type(t)
        hits, misses = c.cache.stats["hits"], c.cache.stats["misses"]
        t0 = time.perf_counter()
        again = c.resolve(spec)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        fr = frames_since(t, before)
        hits = c.cache.stats["hits"] - hits
        misses = c.cache.stats["misses"] - misses
        log(f"[durable] C shed {len(dropped)} payloads ({len(c.state.store)}"
            f" left); second C.resolve {secs:.2f} s: resolve_blob_pulls "
            f"{nc.stats['resolve_blob_pulls']}, frames {fr}, leaf cache "
            f"hits {hits}, misses {misses}")
        if len(dropped) != K or c.state.store or fr or misses or not hits \
                or nc.stats["resolve_blob_pulls"] != K:
            raise AssertionError("[durable] the warm re-resolve after "
                                 "shed_blobs pulled, shipped or missed")
        against("second C.resolve, from the cache", "exact", again)
        del out, again
        c.close()
        c.clear_cache()
        del nodes["durable-c"]
        torch.cuda.empty_cache()

    def b_decompressed():
        b = rep.pop("b")
        net.pop("t").close()
        msg = wire.StateMsg("durable-b", b.state.adds, b.state.removes,
                            b.state.vv, dict(b.state.store))
        b.close()
        del b
        state = wire.msg_to_state(msg, keep_quantized=False, device=DEVICE)
        del msg
        against("B, decompressed on arrival by msg_to_state (B1)",
                "decompressed",
                weight_average(state, engine.EngineCache()))

    # one launch per fused group of the payloads' leaves, at
    # DURABLE_LAYERS = 2 (the engine's packing: int8 payloads priced at
    # a byte an element, decompressed ones at bf16's two; groups of 5 and
    # 3 leaves, 4 leaves alone; at 4 layers groups of 5 and 2, 5 alone)
    quant = {"quant_nary": 2}
    dense = {"nary_accum": 2}
    try:
        out = run_path("durable", [
            ("in-memory int8 weight_average", in_memory),
            ("in-memory decompress_tree weight_average",
             in_memory_decompressed),
            ("journal, close, reopen", journal),
            ("recovered A weight_average", recovered_a),
            ("sync A -> B", sync_a_to_b),
            ("B weight_average", wire_b),
            ("fetch-on-resolve C", fetch_on_resolve_c),
            ("B msg_to_state weight_average", b_decompressed)],
            expect={"in-memory int8 weight_average": quant,
                    "in-memory decompress_tree weight_average": dense,
                    "journal, close, reopen": {},
                    "recovered A weight_average": quant,
                    "sync A -> B": {},
                    "B weight_average": quant,
                    "fetch-on-resolve C": quant,
                    "B msg_to_state weight_average": dense})
    finally:
        for r in rep.values():
            r.close()
        rep.clear()
        if "t" in net:
            net.pop("t").close()
        net.clear()
        shutil.rmtree(workdir, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"[durable] host peak RSS after the phase {peak_rss_gb():.1f} GB")
    return out


def phase_sync_fleet() -> None:
    """`[sync] fleet`: benchmarks/bench_antientropy.py's scenario (100
    nodes, 40 distinct 32x32 fp32 contributions, fanout 3, seed 7) in
    the state, delta and antientropy modes, and
    benchmarks/bench_durability.py's (4 nodes, 64 MiB of fp32, seed 7:
    kill and restart warm, then cold), on the card through the port's
    `SimGossipNetwork(device="cuda")`. Gates: anti-entropy ships at least
    5x fewer bytes than full-state push; warm_zero_bytes, exact_root,
    bounded_replay (30 s) and cold_refetch."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.net import SimGossipNetwork
    res = {}
    for mode in ("state", "delta", "antientropy"):
        rng = np.random.default_rng(FLEET_SEED)
        pool = [{"w": torch.from_numpy(rng.standard_normal(
            (FLEET_SIDE, FLEET_SIDE)).astype(np.float32)).to(DEVICE)}
            for _ in range(FLEET_DISTINCT)]
        pick = rng.integers(0, FLEET_DISTINCT, size=FLEET_NODES)
        g = SimGossipNetwork(FLEET_NODES, seed=FLEET_SEED, mode=mode,
                             device=DEVICE)
        g.contribute_all(lambda i: pool[pick[i]])
        t0 = time.perf_counter()
        rounds = g.run_epidemic(fanout=3, require_blobs=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not g.converged(require_blobs=True) or len(set(g.roots())) != 1:
            raise AssertionError(f"[sync] fleet {mode}: not converged")
        res[mode] = (rounds, g.bytes_sent, g.net.msgs_sent, secs)
        log(f"[sync] fleet bench_antientropy {mode}: {FLEET_NODES} nodes, "
            f"{rounds} rounds, {g.bytes_sent} bytes in {g.net.msgs_sent} "
            f"frames, {secs:.1f} s")
        del g, pool
    ratio = res["state"][1] / res["antientropy"][1]
    log(f"[sync] fleet bench_antientropy: full-state / anti-entropy bytes "
        f"{ratio:.2f}x (gate >= 5)")
    if ratio < 5.0:
        raise AssertionError(f"[sync] fleet: anti-entropy ratio {ratio:.2f}")

    victim = "node001"
    dirname = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        g = SimGossipNetwork(4, seed=FLEET_SEED, mode="antientropy",
                             device=DEVICE)
        side = int(round((DURABLE_MIB / 4 * 2 ** 20 / 4) ** 0.5))
        rng = np.random.default_rng(FLEET_SEED)
        pl = [{"w": torch.from_numpy(rng.standard_normal(
            (side, side)).astype(np.float32)).to(DEVICE)} for _ in range(4)]
        g.contribute_all(lambda i: pl[i])
        g.attach_storage(dirname)
        g.run_epidemic(fanout=3, require_blobs=True)

        def blob_bytes():
            c = g.net.obs.counter("net_bytes_total")
            return sum(c.value(type=ty) for ty in
                       ("BlobResp", "ChunkData", "BlobManifest"))

        pre = g.by_id[victim].state.merkle_root()
        n_blobs = len(g.by_id[victim].state.store)
        g.crash_node(victim)
        before = blob_bytes()
        t0 = time.perf_counter()
        node = g.restart_node(victim)
        torch.cuda.synchronize()
        replay = time.perf_counter() - t0
        exact = node.state.merkle_root() == pre \
            and len(node.state.store) == n_blobs
        g.run_epidemic(fanout=3, require_blobs=True)
        warm = blob_bytes() - before
        reconverged = g.converged(require_blobs=True)
        g.crash_node(victim)
        shutil.rmtree(os.path.join(dirname, victim))
        before = blob_bytes()
        g.restart_node(victim)
        g.run_epidemic(fanout=3, require_blobs=True)
        cold = blob_bytes() - before
        cold_ok = g.converged(require_blobs=True) \
            and g.by_id[victim].state.merkle_root() == pre
        gates = {"warm_zero_bytes": warm == 0 and reconverged,
                 "exact_root": exact,
                 "bounded_replay": replay <= 30.0,
                 "cold_refetch": cold > 0 and cold_ok}
        log(f"[sync] fleet bench_durability: {DURABLE_MIB:.0f} MiB over 4 "
            f"nodes, {n_blobs} blobs held by {victim}; replay {replay:.3f} "
            f"s; warm blob-phase bytes {warm:.0f}; cold {cold:.0f}; gates "
            f"{gates}")
        if not all(gates.values()):
            raise AssertionError(f"[sync] fleet durability gates {gates}")
    finally:
        shutil.rmtree(dirname, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_consortium(cfg) -> None:
    """A consortium at Phi-3-mini's full width and CONSORTIUM_LAYERS of
    its layers: CONSORTIUM gossip nodes on the card, delta gossip; each
    node contributes its own sparse attention update, nodes 0 and 1
    also a dense fine-tune (`make_models`' first two, under fixed
    eids); every payload is one tensor that all stores share.
    Partitioned into two halves, a round leaves two roots; healed, one.
    Then each node resolves weight_average with the base, one node at a
    time, each tree bitwise node 0's; nodes 0 and 7 resolve histogram
    TIES, bitwise each other's."""
    from repro_torch import pytree
    from repro_torch.api import MergeSpec
    from repro_torch.core.gossip import GossipNetwork
    t0 = time.perf_counter()
    cfg = cfg.replace(n_layers=CONSORTIUM_LAYERS)
    base, dense = make_models(cfg, DEVICE, k=2)
    eids = [consortium_eid(f"dense {j}") for j in range(len(dense))]
    net = GossipNetwork(CONSORTIUM, seed=SEED, use_deltas=True,
                        device=DEVICE)
    for i, node in enumerate(net.nodes):
        node.contribute(sparse_update(cfg, base, SEED + 60 + i),
                        consortium_eid(i), leaves=SPARSE_LEAVES)
    for node, c, eid in zip(net.nodes, dense, eids):
        node.contribute(c, eid)
    del dense
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    log(f"[gossip] consortium of {CONSORTIUM} nodes: an attention update "
        f"each, dense fine-tunes on nodes 0 and 1, the base; "
        f"{live / 1e9:.2f} GB on the card, made in "
        f"{time.perf_counter() - t0:.1f} s")
    probe = round_probe(net)
    half = CONSORTIUM // 2
    for label, parts in (("partitioned", [range(half),
                                          range(half, CONSORTIUM)]),
                         ("healed", None)):
        if parts is None:
            net.heal()
        else:
            net.partition(parts)
        sent = net.bytes_sent
        t0 = time.perf_counter()
        net.all_pairs_round()
        ms = (time.perf_counter() - t0) * 1e3
        div = divergence(probe, net)
        distinct = sorted({r.hex()[:16] for r in net.roots()})
        log(f"[gossip] consortium, {label} all-pairs round: {ms:.1f} ms; "
            f"bytes_sent {net.bytes_sent - sent}; roots {distinct}; probe "
            f"divergence {div}")
        if len(distinct) != (2 if parts else 1):
            raise AssertionError(f"consortium, {label}: {len(distinct)} "
                                 "distinct roots")
    stores = [n.state.store for n in net.nodes]
    shared = all(s[e] is stores[0][e] for s in stores for e in stores[0])
    if not shared or torch.cuda.memory_allocated() != live:
        raise AssertionError("the consortium's stores copied payloads")
    log(f"[gossip] consortium: {len(stores[0])} payloads, one tensor each "
        f"shared by all {CONSORTIUM} stores ({live / 1e9:.2f} GB before and "
        f"after gossip); counters sends "
        f"{net.obs.counter('gossip_sends_total').value():.0f}, payloads "
        f"shipped "
        f"{net.obs.counter('gossip_payloads_shipped_total').value():.0f}; "
        f"probe episodes {probe.episodes}")

    def resolve(i, spec):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree = net.nodes[i].resolve(spec, base, use_cache=False)
        torch.cuda.synchronize()
        log(f"[gossip] consortium node {i}: resolve {spec.strategy} "
            f"{time.perf_counter() - t0:.1f} s; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        check_output(spec.strategy, tree, base)
        return tree

    spec = MergeSpec("weight_average")
    # node 0's tree waits in host memory: the FFN leaves' fp32 folds
    # took the card to 76.8 GB beside it
    first = pytree.tree_map(lambda t: t.cpu(), resolve(0, spec))
    for i in range(1, CONSORTIUM):
        tree = resolve(i, spec)
        if same_bytes(first, tree):
            raise AssertionError(f"consortium node {i}'s tree != node 0's")
        del tree
    del first
    ties = MergeSpec("ties", {"trim_method": "histogram"})
    first = pytree.tree_map(lambda t: t.cpu(), resolve(0, ties))
    last = resolve(CONSORTIUM - 1, ties)
    differ = same_bytes(last, first)
    log(f"[gossip] consortium: weight_average bitwise equal on all "
        f"{CONSORTIUM} nodes; histogram TIES on nodes 0 and "
        f"{CONSORTIUM - 1}: {differ} leaves differ")
    if differ:
        raise AssertionError("consortium TIES trees differ")
    del first, last, net, base
    torch.cuda.empty_cache()


def svd_drivers(x: torch.Tensor) -> None:
    """Seconds of each cuSOLVER SVD driver on x, two runs each, the runs'
    byte identity and the reconstruction error; the pinned one (gesvd)
    must repeat its bytes."""
    torch.backends.cuda.preferred_linalg_library("cusolver")
    for drv in ("gesvd", "gesvdj", "gesvda"):
        ts, res = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res.append(torch.linalg.svd(x, full_matrices=False, driver=drv))
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        same = all(torch.equal(bits(a), bits(b))
                   for a, b in zip(res[0], res[1]))
        u, sv, vt = res[0]
        err = float(((u * sv) @ vt - x).norm() / x.norm())
        log(f"[whole] svd {tuple(x.shape)} fp32, driver {drv}: "
            f"{ts[0]:.3f} / {ts[1]:.3f} s; two runs byte-identical {same}; "
            f"reconstruction error {err:.2e} (relative)")
        if drv == "gesvd" and not same:
            raise AssertionError("gesvd, the pinned driver, is not "
                                 "deterministic on this card")
        del res, u, sv, vt
    torch.cuda.empty_cache()


def phase_whole(cfg) -> None:
    """The five whole-model strategies at Phi-3-mini's full width,
    WHOLE_LAYERS of its 32 layers, fp32, through two replicas: A contributes in order,
    B in reverse order under A's eids; each replica resolves each
    strategy and the trees must be byte-identical. A's tree waits in
    host memory while B resolves. A second resolve on A must hit A's
    whole-model cache entry without a dispatch."""
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    cfg = cfg.replace(n_layers=WHOLE_LAYERS)
    t0 = time.perf_counter()
    base, contribs = make_models(cfg, DEVICE, torch.float32)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(base))
    log(f"[whole] {cfg.name}, {WHOLE_LAYERS} layers, fp32: {n} parameters "
        f"per model, {K} contributions + base ({(K + 1) * n * 4 / 1e9:.2f} "
        f"GB) made in {time.perf_counter() - t0:.1f} s")
    svd_drivers(contribs[0]["embed"] - base["embed"])
    t0 = time.perf_counter()
    rep_a = Replica("chip-smoke-whole-a", device=DEVICE)
    eids = [rep_a.contribute(c) for c in contribs]
    ref = rep_a.register_base(base)
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep_b = Replica("chip-smoke-whole-b", device=DEVICE)
    for c, eid in zip(contribs[::-1], eids[::-1]):
        rep_b.contribute(c, eid)
    if rep_b.register_base(base) != ref or \
            rep_a.merkle_root() != rep_b.merkle_root():
        raise AssertionError("the two replicas disagree on Layer 1")
    t_b = time.perf_counter() - t0
    log(f"[whole] replica A: contribute x{K} + register_base in {t_a:.1f} s "
        f"({(K + 1) * n * 4 / t_a / 1e9:.2f} GB/s hashed); replica B "
        f"(reverse order, eids given) + register_base: {t_b:.1f} s")
    del contribs
    # room for one model's entry in A's cache, for the hit check
    rep_a.set_cache_limit(bytes=2 * n * 4)
    for name in WHOLE:
        spec = MergeSpec(name, base_ref=ref)
        trees = {}
        for label, rep in (("A", rep_a), ("B", rep_b)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            tree = rep.resolve(spec)
            torch.cuda.synchronize()
            log(f"[whole] {name}, replica {label}: resolve "
                f"{time.perf_counter() - t0:.1f} s; peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
                f"({live / 1e9:.2f} GB live before the call)")
            check_output(name, tree, base)
            if label == "A":
                stats = dict(rep_a.cache.stats)
                t0 = time.perf_counter()
                again = rep_a.resolve(spec)
                hit_s = time.perf_counter() - t0
                if again is not tree or rep_a.cache.stats["hits"] != \
                        stats.get("hits", 0) + 1 or \
                        rep_a.cache.stats["whole_model_dispatches"] != \
                        stats["whole_model_dispatches"]:
                    raise AssertionError(f"{name}: A's second resolve was "
                                         "not a whole-model cache hit")
                log(f"[whole] {name}, replica A again: cache hit in "
                    f"{hit_s * 1e3:.1f} ms, whole_model_dispatches "
                    f"{stats['whole_model_dispatches']} unchanged")
                del again
                rep_a.clear_cache()
                trees[label] = pytree.tree_map(lambda t: t.cpu(), tree)
            else:
                trees[label] = tree
            del tree
        differ = sum(not torch.equal(bits(a.to(DEVICE)), bits(b))
                     for a, b in zip(pytree.leaves(trees["A"]),
                                     pytree.leaves(trees["B"])))
        if differ:
            raise AssertionError(f"{name}: the replicas' trees differ in "
                                 f"{differ} leaves")
        log(f"[whole] {name}: the two replicas' trees byte-identical "
            f"({len(pytree.leaves(trees['B']))} leaves)")
        del trees
        torch.cuda.empty_cache()
    del rep_a, rep_b, base
    torch.cuda.empty_cache()


def phase_audits() -> None:
    """The paper's Tables 3 and 4 on the card, and the five whole-model
    strategies on the card against the CPU on the 512^2 slices."""
    from repro_torch.core import properties as props
    from repro_torch.core.resolve import reference_apply
    t0 = time.perf_counter()
    tensors = props.controlled_tensors(device=DEVICE)
    raw = props.audit_all_raw(tensors)
    bad = [n for n, r in raw.items() if (r.commutative, r.associative,
                                         r.idempotent)
           != props.TABLE3_EXPECTED[n]]
    log(f"[audit] Table 3, raw (C, A, I) on the card, float64 4x4 seed 42: "
        f"{len(raw) - len(bad)} of {len(raw)} equal TABLE3_EXPECTED"
        + (f"; differ: {bad}" if bad else ""))
    if bad or len(raw) != 26:
        raise AssertionError(f"Table 3 pattern differs for {bad}")
    wrapped = props.audit_all_wrapped(tensors)
    held = sum(r.commutative + r.associative + r.idempotent + r.convergent
               for r in wrapped.values())
    log(f"[audit] Table 4, wrapped (C, A, I, 3-replica convergence), "
        f"bitwise: {held} of {4 * len(wrapped)}")
    if held != 104:
        raise AssertionError(f"wrapped audit {held} of 104")
    for dim in (128, 512):
        base, outs = props.production_slices(None, slice_dim=dim,
                                             device=DEVICE)
        res = props.audit_all_wrapped(outs, base)
        failed = [n for n, r in res.items() if not r.crdt]
        log(f"[audit] tier-2 slices {dim}x{dim} fp32, wrapped: "
            f"{len(res) - len(failed)} of {len(res)} CRDT")
        if failed:
            raise AssertionError(f"tier-2 {dim}: {failed} not CRDT")
    errs = {}
    for name in WHOLE:
        card = reference_apply(name, outs[:K], base=base, seed=7)
        cpu = reference_apply(name, [o.cpu() for o in outs[:K]],
                              base=base.cpu(), seed=7)
        scale = max(1.0, float(cpu.abs().max()))
        errs[name] = float((card.cpu() - cpu).abs().max()) / scale
    log(f"[audit] the five on the card vs the CPU at 512x512 (max abs diff "
        f"over max(1, |cpu|); limit {WHOLE_CARD_TOL}): "
        + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    if max(errs.values()) > WHOLE_CARD_TOL:
        raise AssertionError("a whole-model strategy on the card is off "
                             "the CPU's result")
    log(f"[audit] {time.perf_counter() - t0:.1f} s")


def bits_fingerprint(t: torch.Tensor) -> tuple:
    """(dtype, shape, sum over elements i of bits_i (2 i + 1) mod 2^64),
    computed on t's device in int64 chunks. Each weight is odd, so a
    change to any one element's bits changes the sum: two tensors with
    equal fingerprints are bitwise equal short of a contrived
    cancellation across elements."""
    x = bits(t.detach()).reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    step = 1 << 26
    for i in range(0, x.numel(), step):
        c = x[i:i + step].to(torch.int64)
        w = torch.arange(i, i + c.numel(), dtype=torch.int64,
                         device=x.device).mul_(2).add_(1)
        total += c.mul_(w).sum()
    return str(t.dtype), tuple(t.shape), int(total)


def leaf_samples(tree) -> list:
    """A strided sample of every leaf (one element in 101), to tell
    later whether the leaf changed without a copy of the model."""
    from repro_torch import pytree
    return [t.detach().reshape(-1)[::101].clone() for t in
            pytree.leaves(tree)]


def phase_train(cfg) -> dict:
    """[train], the main path of the training slice: Phi-3-mini at full
    width and depth (32 layers, 3,821,079,552 fp32 parameters, fp32
    AdamW moments, bf16 compute, each layer under remat) from
    `init_from_schema` (the threefry init draws on the host), then
    TRAIN_STEPS steps of `make_train_step` at batch TRAIN_BATCH x
    TRAIN_SEQ in microbatches of TRAIN_BATCH / TRAIN_ACCUM on
    `SyntheticTask` batches. Per step: loss, grad norm, seconds, tokens
    per second, peak device memory; the last step traced (device busy
    time by kernel group, idle share). Every loss and norm finite, every
    parameter leaf changed, the step counter TRAIN_STEPS, and B9's
    forward and backward launched exactly as many times as the layers,
    microbatches and remat ask."""
    import gc
    from repro_torch import kernels, pytree
    from repro_torch.core import engine
    from repro_torch.data.synthetic import SyntheticTask
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.step import init_train_state, make_train_step
    engine.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg)
    t0 = time.perf_counter()
    state = init_train_state(model, params=init_from_schema(
        model.schema(), seed=SEED, device=DEVICE), device=DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(state["params"]))
    log(f"[train] {cfg.name} {cfg.n_layers} layers, {n:,} parameters "
        f"{cfg.param_dtype}, moments {cfg.opt_state_dtype}, compute "
        f"{cfg.compute_dtype}, remat {cfg.remat}: state in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    before = leaf_samples(state["params"])
    step_fn = make_train_step(model, total_steps=TRAIN_STEPS,
                              grad_accum=TRAIN_ACCUM)
    task = SyntheticTask(cfg.vocab_size, TRAIN_SEQ, task_id=0)
    kernels.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        batch = {"tokens": torch.as_tensor(task.batch(i, TRAIN_BATCH),
                                           device=DEVICE)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = {}

        def step(batch=batch, out=out):
            out["state"], out["mets"] = step_fn(state, batch)
            torch.cuda.synchronize()

        t0 = time.perf_counter()
        if i == TRAIN_STEPS - 1:
            trace_device(f"train step {i + 1}", step, tag="train",
                         host=False)
        else:
            step()
        dt = time.perf_counter() - t0
        loss = float(out["mets"]["loss"])
        gnorm = float(out["mets"]["grad_norm"])
        log(f"[train] step {i + 1}: loss {loss:.4f}, grad norm {gnorm:.4f}, "
            f"{dt:.2f} s{' (traced)' if i == TRAIN_STEPS - 1 else ''}, "
            f"{TRAIN_BATCH * TRAIN_SEQ / dt:.0f} tokens/s, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"train step {i + 1}: loss {loss}, grad "
                                 f"norm {gnorm}")
    counts = kernels.launch_counts()
    after = leaf_samples(state["params"])
    shares = [float((a != b).float().mean()) for a, b in zip(before, after)]
    if min(shares) == 0.0:
        raise AssertionError(f"a parameter leaf did not change: {shares}")
    if int(state["step"]) != TRAIN_STEPS:
        raise AssertionError(f"step counter {int(state['step'])}")
    micro = TRAIN_STEPS * TRAIN_ACCUM * cfg.n_layers
    want = {"flash_attention": micro * (2 if cfg.remat != "none" else 1),
            "flash_attention_backward": micro}
    got = {k: counts[k] for k in want}
    log(f"[train] launches {got} (expected {want}: {cfg.n_layers} layers x "
        f"{TRAIN_ACCUM} microbatches x {TRAIN_STEPS} steps, the forward "
        f"again in each remat); every parameter leaf changed (shares of "
        f"sampled elements changed {min(shares):.4f}-{max(shares):.4f}); "
        f"step counter {int(state['step'])}")
    if got != want:
        raise AssertionError(f"train launches {got} != {want}")
    del state, out, before, after
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts}


def clone_tree(tree):
    from repro_torch import pytree
    return pytree.tree_map(lambda t: t.clone(), tree)


def phase_train_depth2(cfg) -> dict:
    """At full width, 2 layers: (1) the loss and every gradient leaf, and
    one train step, with B9 against the same with B9's plain forward and
    backward (TRAIN_*_TOL); (2) 4 steps straight against 2 steps +
    `save_checkpoint` + `restore_checkpoint` + 2 steps: parameters,
    moments and step bitwise; (3) two branch checkpoints (task 0 after 4
    steps, task 1 after 2) and the base's handed to `python -m
    repro_torch.launch.merge --strategy ties --base ...`, started in a
    process of its own as soon as they are written, and the in-process
    `Replica.resolve(MergeSpec("ties"), base=...)` over the same
    parameters, which `phase_merge_cli` compares with the CLI's output
    once [btm] is done."""
    import shutil
    import tempfile
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data.synthetic import SyntheticTask
    from repro_torch.kernels.flash_attention import (
        flash_attention_grad_plain)
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.optim.adamw import lr_schedule
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        train_state_shapes)
    c2 = cfg.replace(n_layers=2)
    models = {"B9": Model(c2),
              "plain": Model(c2, attention=flash_attention_grad_plain)}
    model = models["B9"]
    params0 = init_from_schema(model.schema(), seed=SEED, device=DEVICE)

    def batch(i, task_id=0):
        return {"tokens": torch.as_tensor(SyntheticTask(
            c2.vocab_size, TRAIN_SEQ, task_id).batch(i, TRAIN_BATCH),
            device=DEVICE)}

    def fresh():
        return init_train_state(model, params=clone_tree(params0),
                                device=DEVICE)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # the branches: task 0 for 4 steps (also the uninterrupted run
        # of (2)), task 1 for 2; the base; their checkpoints go to the
        # merge CLI at once
        step = make_train_step(model, total_steps=4, grad_accum=TRAIN_ACCUM)
        a = fresh()
        t0 = time.perf_counter()
        for i in range(4):
            a, _ = step(a, batch(i))
        torch.cuda.synchronize()
        t_steps = time.perf_counter() - t0
        st2 = fresh()
        for i in range(2):
            st2, _ = step(st2, batch(i, task_id=1))
        base = fresh()
        t0 = time.perf_counter()
        pa = save_checkpoint(os.path.join(tmp, "a"), a, 4,
                             metadata={"data_step": 4})
        pb = save_checkpoint(os.path.join(tmp, "b"), st2, 2,
                             metadata={"data_step": 2})
        pbase = save_checkpoint(os.path.join(tmp, "base"), base, 0,
                                metadata={"data_step": 0})
        log(f"[train-d2] 3 checkpoints for the merge CLI written in "
            f"{time.perf_counter() - t0:.1f} s; the CLI starts now and "
            "runs beside the rest of this phase and [btm]")
        out_dir = os.path.join(tmp, "merged")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        cli = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.merge", "--arch",
             cfg.name, "--strategy", "ties", "--base", pbase, "--inputs",
             pa, pb, "--out", out_dir], cwd=str(ROOT), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        pending = {"cli": cli, "t0": time.perf_counter(), "tmp": tmp,
                   "out": out_dir, "model": model}

        # (1) B9 against its plain version: loss, gradients, one step
        mb = {"tokens": batch(0)["tokens"][:TRAIN_BATCH // TRAIN_ACCUM]}
        res = {}
        for label, m in models.items():
            p = pytree.tree_map(lambda t: t.clone().requires_grad_(),
                                params0)
            loss, _ = m.loss(p, mb)
            loss.backward()
            res[label] = (float(loss.detach()),
                          [t.grad for t in pytree.leaves(p)])
            del p, loss
        (lk, gk), (lp, gp) = res["B9"], res["plain"]
        worst = max(float((x - y).abs().max())
                    / max(float(y.abs().max()), 1e-30)
                    for x, y in zip(gk, gp))
        ok = abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp) and \
            worst <= TRAIN_GRAD_TOL
        log(f"[train-d2] loss and gradients, B9 vs its plain version "
            f"({c2.name} 2 layers, microbatch [{TRAIN_BATCH // TRAIN_ACCUM}"
            f", {TRAIN_SEQ}]): loss {lk:.6f} vs {lp:.6f}; worst gradient "
            f"leaf {worst:.3e} of its largest magnitude (limit "
            f"{TRAIN_GRAD_TOL}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train: B9 vs plain loss or gradients")
        del res, gk, gp
        after = {}
        for label, m in models.items():
            st = init_train_state(m, params=clone_tree(params0),
                                  device=DEVICE)
            st, mets = make_train_step(m, total_steps=TRAIN_STEPS,
                                       grad_accum=TRAIN_ACCUM)(st, batch(0))
            after[label] = (float(mets["loss"]), st["params"])
            del st
        lr0 = float(lr_schedule(0, cfg, TRAIN_STEPS))
        pdiff = max(float((x - y).abs().max()) for x, y in zip(
            pytree.leaves(after["B9"][1]), pytree.leaves(after["plain"][1])))
        ok = pdiff <= TRAIN_PARAM_LRS * lr0 and \
            abs(after["B9"][0] - after["plain"][0]) <= \
            TRAIN_LOSS_RTOL * abs(after["plain"][0])
        log(f"[train-d2] one train step, B9 vs plain: loss "
            f"{after['B9'][0]:.6f} vs {after['plain'][0]:.6f}; updated "
            f"parameters max abs diff {pdiff:.3e} (limit {TRAIN_PARAM_LRS} "
            f"x lr {lr0:.3e}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("train: B9 vs plain updated parameters")
        del after
        torch.cuda.empty_cache()

        # (2) resume against uninterrupted, bitwise
        b = fresh()
        for i in range(2):
            b, _ = step(b, batch(i))
        t0 = time.perf_counter()
        path = save_checkpoint(os.path.join(tmp, "resume"), b, 2,
                               metadata={"data_step": 2})
        t_save = time.perf_counter() - t0
        del b
        t0 = time.perf_counter()
        b, meta = restore_checkpoint(path, train_state_shapes(model),
                                     device=DEVICE)
        t_restore = time.perf_counter() - t0
        for i in range(int(meta["data_step"]), 4):
            b, _ = step(b, batch(i))
        flat_a, flat_b = pytree.leaves(a), pytree.leaves(b)
        same = sum(torch.equal(bits(x), bits(y))
                   for x, y in zip(flat_a, flat_b))
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        log(f"[train-d2] resume: 4 steps straight vs 2 + save "
            f"({size / 1e9:.2f} GB, {t_save:.1f} s) + restore "
            f"({t_restore:.1f} s) + 2: {same} of {len(flat_a)} leaves "
            f"(params, m, v, step) bitwise equal; 4 steps {t_steps:.1f} s")
        if same != len(flat_a):
            raise AssertionError("resume differs from the uninterrupted run")
        del b, flat_a, flat_b

        # (3) the in-process resolve the CLI's output is held against
        r = Replica("in-process", device=DEVICE)
        r.contribute(a["params"])
        r.contribute(st2["params"])
        t0 = time.perf_counter()
        pending["want"] = r.resolve(MergeSpec("ties"), base=base["params"])
        pending["root"] = r.merkle_root().hex()
        log(f"[train-d2] in-process resolve (ties over the 2 branches, "
            f"base): {time.perf_counter() - t0:.1f} s")
        r.close()
        del a, st2, base, r
    except BaseException:
        if "pending" in locals() and pending["cli"].poll() is None:
            pending["cli"].kill()
            pending["cli"].wait()
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    del params0
    torch.cuda.empty_cache()
    return pending


def phase_merge_cli(pending: dict) -> None:
    """The merge CLI started in `phase_train_depth2`: its output
    checkpoint's parameters byte-identical to the in-process resolve,
    and its Merkle root the in-process replica's."""
    import shutil
    from repro_torch import pytree
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.train.step import train_state_shapes
    try:
        out, err = pending["cli"].communicate(timeout=900)
        t_cli = time.perf_counter() - pending["t0"]
        if pending["cli"].returncode:
            raise AssertionError(f"merge CLI failed: {err[-2000:]}")
        for line in out.strip().splitlines():
            log(f"[train-d2] merge CLI: {line}")
        got, meta = restore_checkpoint(
            os.path.join(pending["out"], "step_00000000"),
            train_state_shapes(pending["model"]), device=DEVICE)
        want = pending.pop("want")
        same = sum(torch.equal(bits(x), bits(y)) for x, y in
                   zip(pytree.leaves(got["params"]), pytree.leaves(want)))
        n = len(pytree.leaves(want))
        log(f"[train-d2] merge CLI (ties over 2 branch checkpoints, base; "
            f"{t_cli:.1f} s from its start to its exit): {same} of {n} "
            f"leaves byte-identical to the in-process resolve; root "
            f"{meta['merkle_root'][:16]} vs {pending['root'][:16]}")
        if same != n or meta["merkle_root"] != pending["root"]:
            raise AssertionError("merge CLI output != in-process resolve")
        del got, want
    finally:
        if pending["cli"].poll() is None:
            pending["cli"].kill()
            pending["cli"].wait()
        shutil.rmtree(pending["tmp"], ignore_errors=True)
        torch.cuda.empty_cache()


def phase_btm(cfg) -> dict:
    """[btm]: `BranchTrainMerge` at full width, BTM_LAYERS of 32 layers,
    BTM_BRANCHES branches, weight_average, merge_every BTM_MERGE_EVERY,
    batch BTM_BATCH x BTM_SEQ, all-pairs full-state gossip: the
    reference test's scenario (a round; branch 2 killed; a straggler
    included the round after; an elastic join). After every round the
    alive branches' parameters are byte-identical and gossip has
    converged."""
    from repro_torch import kernels, pytree
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.btm import BranchTrainMerge
    bc = cfg.replace(n_layers=BTM_LAYERS, grad_accum=TRAIN_ACCUM)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    btm = BranchTrainMerge(
        bc, n_branches=BTM_BRANCHES, strategy="weight_average",
        merge_every=BTM_MERGE_EVERY, batch_size=BTM_BATCH, seq_len=BTM_SEQ,
        device=DEVICE, params=init_from_schema(Model(bc).schema(),
                                               seed=SEED, device=DEVICE))
    log(f"[btm] {BTM_BRANCHES} branches of {bc.name} at {BTM_LAYERS} "
        f"layers: set up in {time.perf_counter() - t0:.1f} s")

    def round_(label):
        t0 = time.perf_counter()
        rec = btm.train_round()
        dt = time.perf_counter() - t0
        alive = [b for b in btm.branches if b.alive]
        first = pytree.leaves(alive[0].state["params"])
        same = all(all(torch.equal(bits(x), bits(y)) for x, y in
                       zip(first, pytree.leaves(b.state["params"])))
                   for b in alive[1:])
        conv = btm.net.converged()
        vis = len(btm.net.nodes[0].state.visible())
        log(f"[btm] round {rec['round']} ({label}): {dt:.1f} s; losses "
            + ", ".join(f"{i}: {v:.4f}" for i, v in
                        sorted(rec["losses"].items()))
            + f"; {len(alive)} alive branches byte-identical: {same}; "
            f"gossip converged: {conv}; {vis} visible contributions")
        if not (same and conv):
            raise AssertionError(f"btm round {rec['round']}: identical "
                                 f"{same}, converged {conv}")
        return rec, vis

    round_("all branches")
    btm.kill_branch(2)
    rec, _ = round_("branch 2 killed")
    if 2 in rec["losses"]:
        raise AssertionError("a killed branch trained")
    btm.mark_straggler(1, rounds=1)
    _, n_before = round_("branch 1 straggles")
    _, n_after = round_("the straggler's add lands")
    if n_after <= n_before:
        raise AssertionError("the straggler's contribution did not land")
    idx = btm.add_branch()
    rec, _ = round_(f"branch {idx} joined")
    if idx not in rec["losses"] or btm.net.nodes[idx].state.visible() != \
            btm.net.nodes[0].state.visible():
        raise AssertionError("the joining branch did not train or sync")
    counts = kernels.launch_counts()
    log(f"[btm] launches: flash_attention {counts['flash_attention']}, "
        f"flash_attention_backward {counts['flash_attention_backward']}")
    del btm
    torch.cuda.empty_cache()
    return {"launches": counts}


def phase_gemma2_train() -> dict:
    """[gemma2-train]: Gemma-2 27B trained on the card at full width,
    G2_TRAIN_PERIODS of its 23 periods (a local sub-layer, window 4096,
    and a global one, each with the attention softcap, sandwich norms;
    the tied 256,000-row embedding, the final softcap), fp32 parameters
    and moments, bf16 compute, remat, from `init_from_schema`; then
    G2_TRAIN_STEPS steps of `make_train_step` at batch G2_TRAIN_BATCH x
    G2_TRAIN_SEQ in microbatches of G2_TRAIN_BATCH / G2_TRAIN_ACCUM on
    `SyntheticTask` batches. Per step: loss, grad norm, seconds, tokens
    per second, peak device memory; the last step traced. B9's forward
    and backward launch exactly as the layers, microbatches and remat
    ask (the window and softcap on the kernels: B9's gradient raises
    nowhere and never gives way to its plain version on CUDA tensors).
    Resume: a checkpoint written after step G2_TRAIN_STEPS - 1, the
    finished state fingerprinted (`bits_fingerprint`), the checkpoint
    restored and the last step run again: every leaf's fingerprint the
    uninterrupted run's."""
    import gc
    import shutil
    import tempfile
    from repro_torch import kernels, pytree
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.data.synthetic import SyntheticTask
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        train_state_shapes)
    engine.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(GEMMA2).replace(n_layers=2 * G2_TRAIN_PERIODS,
                                     grad_accum=G2_TRAIN_ACCUM)
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_train_state(model, params=init_from_schema(
        model.schema(), seed=SEED, device=DEVICE), device=DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(state["params"]))
    log(f"[gemma2-train] {cfg.name} at full width, {model.n_periods} of 23 "
        f"periods (sub-layers with windows "
        f"{[sl.window for sl in model.layout]}; depth cut so that 16 bytes "
        f"a parameter and the logits stage of a {G2_TRAIN_SEQ}-token "
        f"microbatch fit 80 GB), {n:,} parameters {cfg.param_dtype}, "
        f"moments {cfg.opt_state_dtype}, compute {cfg.compute_dtype}, remat "
        f"{cfg.remat}: state in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"({held0 / 1e9:.2f} GB before it)")
    before = leaf_samples(state["params"])
    step_fn = make_train_step(model, total_steps=G2_TRAIN_STEPS,
                              grad_accum=G2_TRAIN_ACCUM)
    task = SyntheticTask(cfg.vocab_size, G2_TRAIN_SEQ, task_id=0)

    def batch(i):
        return {"tokens": torch.as_tensor(task.batch(i, G2_TRAIN_BATCH),
                                          device=DEVICE)}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_g2ckpt_")
    try:
        kernels.reset_launch_counts()
        ckpt_path, t_save = None, 0.0
        for i in range(G2_TRAIN_STEPS):
            b = batch(i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mets = {}

            def step(b=b, mets=mets):           # the state in place
                mets.update(step_fn(state, b)[1])
                torch.cuda.synchronize()

            last = i == G2_TRAIN_STEPS - 1
            t0 = time.perf_counter()
            if last:
                trace_device(f"train step {i + 1}", step,
                             tag="gemma2-train", host=False)
            else:
                step()
            dt = time.perf_counter() - t0
            loss = float(mets["loss"])
            gnorm = float(mets["grad_norm"])
            log(f"[gemma2-train] step {i + 1}: loss {loss:.4f}, grad norm "
                f"{gnorm:.4f}, {dt:.2f} s{' (traced)' if last else ''}, "
                f"{G2_TRAIN_BATCH * G2_TRAIN_SEQ / dt:.0f} tokens/s, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"gemma2 train step {i + 1}: loss "
                                     f"{loss}, grad norm {gnorm}")
            if i == G2_TRAIN_STEPS - 2:
                t0 = time.perf_counter()
                ckpt_path = save_checkpoint(
                    tmp, state, i + 1, metadata={"data_step": i + 1})
                t_save = time.perf_counter() - t0
        counts = kernels.launch_counts()
        after = leaf_samples(state["params"])
        shares = [float((a != b).float().mean())
                  for a, b in zip(before, after)]
        if min(shares) == 0.0:
            raise AssertionError(f"a parameter leaf did not change: "
                                 f"{shares}")
        if int(state["step"]) != G2_TRAIN_STEPS:
            raise AssertionError(f"step counter {int(state['step'])}")
        micro = G2_TRAIN_STEPS * G2_TRAIN_ACCUM * cfg.n_layers
        want = {"flash_attention": micro * (2 if cfg.remat != "none"
                                            else 1),
                "flash_attention_backward": micro}
        got = {k: counts[k] for k in want}
        log(f"[gemma2-train] launches {got} (expected {want}: "
            f"{cfg.n_layers} layers x {G2_TRAIN_ACCUM} microbatches x "
            f"{G2_TRAIN_STEPS} steps, the forward again in each remat); "
            f"every parameter leaf changed (shares of sampled elements "
            f"changed {min(shares):.4f}-{max(shares):.4f})")
        if got != want:
            raise AssertionError(f"gemma2 train launches {got} != {want}")
        del before, after
        # resume: the finished state's fingerprints, the checkpoint back
        # on the card (two states do not fit), the last step again
        t0 = time.perf_counter()
        want = [bits_fingerprint(t) for t in pytree.leaves(state)]
        t_print = time.perf_counter() - t0
        del state
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state, meta = restore_checkpoint(ckpt_path, train_state_shapes(model),
                                         device=DEVICE)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        for i in range(int(meta["data_step"]), G2_TRAIN_STEPS):
            state, _ = step_fn(state, batch(i))
        got = [bits_fingerprint(t) for t in pytree.leaves(state)]
        same = sum(x == y for x, y in zip(got, want))
        size = sum(os.path.getsize(os.path.join(ckpt_path, f))
                   for f in os.listdir(ckpt_path))
        log(f"[gemma2-train] resume: {G2_TRAIN_STEPS} steps straight vs "
            f"{G2_TRAIN_STEPS - 1} + save ({size / 1e9:.2f} GB, {t_save:.1f} "
            f"s) + restore ({t_restore:.1f} s) + 1: {same} of {len(want)} "
            f"leaves (params, m, v, step) with the uninterrupted run's bit "
            f"fingerprint (bits_fingerprint, not an element-wise "
            f"comparison; {t_print:.1f} s for the state)")
        if same != len(want):
            raise AssertionError("gemma2: resume differs from the "
                                 "uninterrupted run")
        del state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    cfg = get_config("phi3-mini-3.8b")
    t_start = time.perf_counter()

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        log(f"[time] {phase.__name__}: {time.perf_counter() - t0:.0f} s")
        return out

    dev = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timed(phase_build)
    rows = timed(phase_kernels, cfg)
    main = timed(phase_main_path, cfg)
    timed(phase_consortium, cfg)
    timed(phase_exact_vs_kernels, cfg)
    serve = timed(phase_serve, cfg)
    timed(phase_serve_vs_plain, cfg)
    gemma2 = timed(phase_gemma2)
    qwen3 = timed(phase_qwen3_moe)
    timed(phase_whole, cfg)
    timed(phase_audits)
    timed(phase_gossip_tables)
    timed(phase_sync_fleet)
    train = timed(phase_train, cfg)
    pending = timed(phase_train_depth2, cfg)
    btm = timed(phase_btm, cfg)
    timed(phase_merge_cli, pending)
    g2train = timed(phase_gemma2_train)
    for name, row in rows.items():
        row["launches"] = sum(p["launches"][name] for p in
                              (main, serve, gemma2, qwen3, train, btm,
                               g2train))
    log(f"[done] {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
