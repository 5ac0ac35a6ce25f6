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
          byte-identical tokens and logits; at 1 layer (2 before the
          whisper and vlm phases came) the served forward with B9
          against its plain version and the gather dispatch against the
          einsum one; then the int8 weight average
          of 2 contributions at 11 of its layers, where each stacked
          expert leaf holds 2,214,592,512 elements (past 2^31), merged
          on arrival through B2 with no slice densified and held
          bitwise against `quant_nary_ref` on windows at its start,
          across 2^31 and at its end. `[kernels]` holds B9 at Qwen3's
          shapes (H / HK = 8; prefill bf16 and fp32, decode) and B2 on
          one such expert leaf, bitwise over the whole output.

  mamba2  Mamba2-780M (configs/mamba2_780m.py), the SSM family, at full
          width and depth: 780,148,992 bf16 parameters seeded on the
          card (1.56 GB), `greedy_decode` twice (batch 4, a 4096-token
          prompt, a multiple of its 256-token SSD chunk, 32 tokens;
          every mixer the chunked SSD in prefill and the recurrent
          update in decode, plain PyTorch ops, no kernel launched),
          byte-identical tokens and logits, one decode step and one
          prefill traced; `ssd_chunked` alone at the served and
          trained shapes beside its bound and the prefill's busy time;
          at 2 layers fp32 the chunked prefill against a shorter
          prefill and 256 recurrent steps, and the card against the
          CPU; a base and 4 contributions at full depth through two
          replicas in opposite orders, histogram TIES and
          weight_average on the kernel routes (B1, B3-B5) to
          byte-identical trees, each held leaf by leaf against the
          exact route on replica A, the TIES trees served
          byte-identical; then 2 train steps at full
          width and depth (fp32 parameters and moments, bf16 compute,
          remat, batch 4 x 4096 in 2 microbatches, the last traced;
          3 before the whisper and vlm phases came),
          finite (the reference's masked decay gives a NaN gradient at
          chunk 256), every leaf changed, step 1 bitwise on a rerun.

  jamba   Jamba-1.5-Large-398B (configs/jamba_1_5_large_398b.py), the
          hybrid family, at full width: one period of 4 sub-layers
          (attention + dense FFN, Mamba + MoE, Mamba + dense FFN, Mamba
          + MoE: the reference's smoke wiring of the hybrid;
          22,978,081,664 bf16 parameters, 45.96 GB; the config's own
          period of 8 is 90.3 GB) seeded on the card, `greedy_decode`
          twice (batch 4, a 4096-token prompt, 32 tokens; B9 on the
          attention sub-layer, exactly 33 launches a call),
          byte-identical tokens and logits, one decode step and one
          prefill traced; at 2 sub-layers (attention + dense, Mamba +
          MoE) the served forward with B9 against its plain version,
          and two fine-tunes that leave the three expert leaves
          (3,221,225,472 elements each, past 2^31) to the base land on
          two replicas in opposite orders, which resolve histogram
          TIES and weight_average on the kernel routes (B1, B3-B5) to
          byte-identical trees whose expert leaves are the base's own
          tensors, each held leaf by leaf against the exact route; the
          TIES trees serve byte-identical tokens and logits.
          `[kernels]` holds B9 at Jamba's shapes (64 query heads over
          8 KV heads of 128; prefill and decode, bf16).

  whisper Whisper-tiny (configs/whisper_tiny.py), the enc-dec family, at
          full width and depth (4 encoder and 4 decoder layers,
          36,439,680 parameters): seeded in bf16, `greedy_decode` twice
          (batch 32 clips of 1500 frames from `make_batch`, a 4-token
          prompt, 224 tokens; B9 on every attention call: the encoder's
          non-causal self-attention over 1500 frames, each decoder
          layer's causal self-attention and its cross-attention over
          the encoder output: exactly 12 + 224 x 8 launches a call),
          byte-identical tokens and logits, one decode step and one
          prefill traced, the served forward with B9 against its plain
          version; the smoke model's loss and gradients card vs CPU;
          trained in fp32 at full depth (3 steps of 64 x 448 tokens
          with their frames in 2 microbatches, the last traced, resumed
          bitwise from a checkpoint); two fine-tunes of the trained base
          on task ids 1 and 2 land on two replicas in opposite orders,
          which resolve histogram TIES and weight_average on the kernel
          routes (B1, B3-B5) to byte-identical trees, each held leaf by
          leaf against the exact route; the TIES trees serve
          byte-identical tokens and logits.

  vlm     Llama-3.2-Vision-90B (configs/llama_3_2_vision_90b.py), the VLM
          family, at full width: 6 of its 20 periods (30 layers, 6 of
          them gated cross-attention over 1601 patch embeddings;
          27,770,986,508 bf16 parameters, 55.54 GB; its 100 layers are
          175.3 GB) with the gates at 0.5 and -0.7 (at their init, 0,
          tanh(0) hides the cross path), `greedy_decode` twice (batch 4,
          a 4064-token prompt, 1601 patches a row, 32 tokens; B9 on
          every self- and cross-attention call: 30 x 33 launches a
          call), byte-identical tokens and logits, one decode step and
          one prefill traced; at 1 period the served forward with B9
          against its plain version, and two fine-tunes of the cross
          sub-layer alone (its gates included) over a registered base
          on two replicas in opposite orders: TIES and weight_average on
          the kernel routes (B1, B3-B5) byte-identical, held against the
          exact route, the gate leaves bit for bit, every other leaf the
          base's own tensor; the TIES trees served byte-identical.
          `[kernels]` holds B9 at both families' shapes (non-causal over
          1500 frames and 1601 patches: Whisper's encoder, its cross
          prefill and decode, its decoder's self decode; the VLM's
          cross prefill and decode) and its gradient at Whisper's
          training microbatch (the encoder's self-attention and the
          decoder's cross-attention).

  deepseek  DeepSeek-V2-236B (configs/deepseek_v2_236b.py), multi-head
          latent attention over fine-grained experts, at full width: 8
          of its 60 layers (the dense layer 0 and 7 MLA + MoE layers;
          29,191,377,920 bf16 parameters, 58.38 GB) seeded on the card,
          `greedy_decode` twice (batch 4, a 4096-token prompt, a
          multiple of the 512-query chunk, 32 tokens; the latent
          attention's plain products, non-absorbed in prefill and
          absorbed over the latent cache in decode: no kernel launched;
          160 routed experts, top-6, and 2 shared, the gather
          dispatch), byte-identical tokens and logits, one decode step
          and one prefill traced; one layer's prefill attention alone
          against its bound and `scaled_dot_product_attention` (q and k
          of 192, v of 128) under each fused backend that accepts it;
          at 2 layers two fine-tunes that leave the three expert leaves
          to the base land on two replicas in opposite orders, which
          resolve histogram TIES and weight_average on the kernel
          routes (B1, B3-B5; kernel_dispatch_total grows on both) to
          byte-identical trees whose expert leaves are the base's own
          tensors, each held leaf by leaf against the exact route; the
          TIES trees serve byte-identical tokens and logits.

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

The whole-model slice (`[whole]`) runs at Phi-3-mini's full width, 1 of
its 32 layers, fp32 (five fp32 models at 32 layers would take 76.4 GB,
and 1 rather than 16 keeps the script inside its time limit; bf16 SVD
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
payloads, cut to 1 of their 32 layers (`first_layers`; 2 before the
whisper and vlm phases came, 4 before the qwen3-moe phase, all 32
before the gemma2 phase), through
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
width, 1 layer: a round, a branch killed, a straggler, an elastic
join, every alive branch byte-identical after each merge.
`[gemma2-train]` runs next: Gemma-2 27B at full width and 1 of its 23
periods (2 layers, a local and a global one; 2 periods before the
[qwen3-moe] phase came; fp32 parameters and moments, 37.0 GB of state,
bf16 compute, remat), 2 steps of batch 2 x 8192 in
microbatches of 1, every attention call on B9's forward and gradient
with the softcap and, on the local sub-layer, the 4096-key window; the
last step traced (3 steps and a run resumed from a checkpoint before
the vlm-train and deepseek-train phases came). `[kernels]` holds B9's
gradient at that microbatch (local and global, bf16 and fp32) beside
`flex_attention`'s backward. `[qwen3-moe-train]` runs last: the
Qwen3-MoE smoke model's loss, aux term and gradients on the card
against the CPU, then Qwen3-MoE-30B-A3B at full width and 1 of its 48
layers (1,245,452,288 fp32 parameters and moments, 19.9 GB of state;
4 layers before the whisper and vlm phases came; bf16 compute, remat) for 3 steps of batch 4 x 4096 in microbatches of
2 under torch's deterministic mode (the gather dispatch's backward, an
accumulating index-put, on torch's sorted path), the last traced with
the routing / gather kernels a group of their own, a run resumed from a
checkpoint written after step 2 with every leaf's bit fingerprint the
uninterrupted run's, and one Branch-Train-Merge round at 1 layer whose
merge is bitwise a `Replica`'s weight_average. `[vlm-train]` follows:
the VLM's smoke model (gates set) card against CPU, then
Llama-3.2-Vision-90B at full width and 1 of its 20 periods (4
self-attention and a gated cross-attention sub-layer, with the embedding
and the head: 6,379,626,498 parameters) under the dry run's `parambf16`
variant (bf16 parameters, gradients and moments, 51.0 GB of state), 2
steps of batch 2 x 4096 tokens with 1601 patches a row in microbatches
of 1, the gates at 0.5 / -0.7 and moving, B9 and its gradient on every
self-attention (causal) and cross-attention (non-causal over the
patches) call, the last step traced. `[deepseek-train]` runs last:
DeepSeek-V2's smoke model (`q_lora_rank` 24) card against CPU, then
DeepSeek-V2-236B at full width and 2 of its 60 layers (the dense layer
0 and an MLA layer of 160 routed experts, top-6, and 2 shared), 2 steps
of 2 x 4096 in microbatches of 1 under the deterministic mode, the last
traced with a routing / gather group, and one MLA mixer's forward and
backward timed alone beside the traced step. `[kernels]` holds B9 and
its gradient at the VLM's training microbatch (self causal over 4096
keys, cross non-causal over 1601).

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
# TIES leaf by leaf (`hold_leaves_vs_exact`): one leaf's share strays
# further than the tree's. An H100 read 3.4e-4 at worst at Mamba2-780M's
# full depth (embed) and 1.14e-3 at Qwen3-MoE's 2 layers (the router);
# each leaf may reach ten times the tree's limit, and a leaf the kernels
# got wrong is near 1
TIES_LEAF_MAX_DIFF_SHARE = 1e-2
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
# the whole-model slice: 1 of Phi-3-mini's 32 layers in fp32 (five
# models, 6.2 GB). Memory allows 16 (40.2 GB); 1 (8 before the [gemma2]
# phase came, 2 before [mamba2]) keeps the script inside its time limit
WHOLE_LAYERS = 1
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
# 88-127) at full width, 1 of 32 layers (2 before [mamba2] came)
BTM_LAYERS, BTM_BRANCHES, BTM_MERGE_EVERY = 1, 3, 2
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
# 1; 2 steps, the last traced. No resume since the [vlm-train] and
# [deepseek-train] phases came (its 27.75 GB checkpoint's save and
# restore took 42 s of the script; a resume stays held bitwise in
# [train-d2] and [qwen3-moe-train]); 3 steps before
G2_TRAIN_PERIODS, G2_TRAIN_STEPS = 1, 2
G2_TRAIN_BATCH, G2_TRAIN_SEQ, G2_TRAIN_ACCUM = 2, 8192, 2
# [durable] journals and syncs the int8 payloads of 1 of Phi-3-mini's 32
# layers (2 before the [whisper] and [vlm] phases, 4 before the
# [qwen3-moe] phase, all 32 before gemma2's, 16 in its first runs): it is
# host-bound, and the later phases need its time under the limit
DURABLE_LAYERS = 1
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
Q3_MERGE_LAYERS, Q3_K, Q3_PLAIN_LAYERS = 2, 4, 1
Q3_INT8_LAYERS, Q3_INT8_K = 11, 2
Q3_WINDOW = 1 << 20
EXPERT_LEAVES = tuple(f"['blocks']['sub0']['ffn']['experts']['{w}']"
                      for w in ("w_down", "w_gate", "w_up"))
# [mamba2]: Mamba2-780M (configs/mamba2_780m.py) at full width and depth,
# uncut: served at batch 4 of a M2_PROMPT-token prompt (a multiple of its
# 256-token SSD chunk; the other families' 4064 would raise) and 32
# tokens; a base and M2_K contributions merged through two replicas (5 x
# 1.56 GB); trained on batch M2_TRAIN_BATCH x M2_TRAIN_SEQ in
# M2_TRAIN_ACCUM microbatches (fp32 state, 12.5 GB). At M2_CHECK_LAYERS,
# fp32, batch M2_CHECK_BATCH: the chunked prefill of M2_DUAL_S tokens
# against a prefill of M2_DUAL_S - M2_DUAL_M tokens and M2_DUAL_M
# recurrent steps (state-space duality, across 256-token chunks), and
# the card's prefill of M2_CPU_S tokens against the CPU's on the same
# weights
MAMBA2 = "mamba2-780m"
M2_PROMPT, M2_K = 4096, 4
M2_CHECK_LAYERS, M2_CHECK_BATCH = 2, 2
M2_DUAL_S, M2_DUAL_M, M2_CPU_S = 768, 256, 512
M2_TRAIN_BATCH, M2_TRAIN_SEQ, M2_TRAIN_ACCUM, M2_TRAIN_STEPS = 4, 4096, 2, 2
# fp32 limits at M2_CHECK_LAYERS: the last logits' largest difference
# (logits up to 3.3), and each layer's SSM state and conv cache as a
# share of their largest magnitude. An H100 80GB HBM3 (700.00 W) read
# 6.3e-6, 3.9e-6 and 1.8e-6 for the duality (256 recurrent updates
# against chunked sums), 5.3e-6, 2.5e-6 and 1.4e-6 card vs CPU (sums in
# other orders); the limits are 5-8 times those
M2_DUAL_TOL = {"logits": 5e-5, "state": 2e-5, "conv": 1e-5}
M2_CPU_TOL = {"logits": 5e-5, "state": 2e-5, "conv": 1e-5}
# [qwen3-moe-train]: Qwen3-MoE-30B-A3B trained at full width (fp32
# parameters and AdamW moments, bf16 compute, each layer under remat) at
# Q3_TRAIN_LAYERS of its 48 layers (623.1e6 parameters a layer and
# 622.3e6 of embedding and head, 16 bytes each: 19.9 GB of state at 1
# layer, 49.8 GB at 4; 1 since the [whisper] and [vlm] phases came: the
# checkpoint's 37.4 GB at 4 layers took a minute to write and read),
# batch 4 x 4096 in 2 microbatches, 3 steps, the last traced; a
# checkpoint written after step 2 and restored, step 3 again.
# Q3_CHECK: the smoke model on the card against the CPU (loss,
# aux, every gradient; the CPU tests' limits against JAX). Q3_BTM_*: one
# Branch-Train-Merge round at full width and Q3_BTM_LAYERS layer (each
# branch holds its own parameters and moments: a base state and two
# branches of 1.245e9 parameters at 12 bytes, 44.8 GB, two 5.0 GB
# contributions, the merge and the step's gradients)
Q3_TRAIN_LAYERS = 1
Q3_TRAIN_BATCH, Q3_TRAIN_SEQ, Q3_TRAIN_ACCUM, Q3_TRAIN_STEPS = 4, 4096, 2, 3
Q3_BTM_LAYERS, Q3_BTM_BRANCHES, Q3_BTM_BATCH, Q3_BTM_SEQ = 1, 2, 4, 512
Q3_CHECK_LIMITS = {"loss": 1e-6, "aux": 1e-6, "grad": 2e-5}
# [jamba]: Jamba-1.5-Large-398B (configs/jamba_1_5_large_398b.py), the
# hybrid family, at full width. Served: one period of 4 sub-layers wired
# as the reference's smoke_config wires the hybrid (attention at 0, MoE
# at 1 and 3: attention + dense FFN, Mamba + MoE, Mamba + dense FFN,
# Mamba + MoE), 22,978,081,664 bf16 parameters (45.96 GB; the config's
# own period of 8 holds 45,137,317,248, 90.3 GB, past the card), batch
# 4, a 4096-token prompt (a multiple of the 256-token SSD chunk), 32
# tokens. At JB_MERGE_CUT (attention + dense, Mamba + MoE;
# 11,898,463,872 parameters, 23.8 GB) the served forward with B9
# against its plain version, and the merge: a bf16 base and two
# fine-tunes that touch every leaf but the three expert leaves
# (2,234,787,456 parameters, 4.47 GB each; an expert leaf holds
# 3,221,225,472 elements, past 2^31, and a base, two dense
# contributions and an output would be 4 x 23.8 GB)
JAMBA = "jamba-1.5-large-398b"
JB_SERVE_CUT = dict(n_layers=4, hybrid_period=4, hybrid_attn_index=0)
JB_MERGE_CUT = dict(n_layers=2, hybrid_period=2, hybrid_attn_index=0)
JB_PROMPT, JB_K = 4096, 2
# [whisper]: Whisper-tiny (configs/whisper_tiny.py), the enc-dec family,
# at full width and depth, uncut (4 encoder and 4 decoder layers,
# 36,439,680 parameters). Served in bf16: batch WH_BATCH clips of 1500
# frames (`make_batch`), a WH_PROMPT-token prompt and WH_GEN greedy
# tokens (228 positions, inside Whisper's 448-token context). Trained in
# fp32 at batch WH_TRAIN_BATCH x WH_TRAIN_SEQ (the decoder's context)
# with their frames in WH_TRAIN_ACCUM microbatches, WH_TRAIN_STEPS
# steps, the resume bitwise; then WH_K fine-tunes of the trained base,
# WH_TUNE_STEPS steps each on task ids 1 .. WH_K, merged through two
# replicas and served. WH_CHECK: the smoke model's loss and gradients on
# the card against the CPU (the CPU tests' limits against JAX)
WHISPER = "whisper-tiny"
WH_BATCH, WH_PROMPT, WH_GEN = 32, 4, 224
WH_TRAIN_BATCH, WH_TRAIN_SEQ, WH_TRAIN_ACCUM, WH_TRAIN_STEPS = 64, 448, 2, 3
WH_K, WH_TUNE_STEPS = 2, 2
WH_CHECK_LIMITS = {"loss": 1e-6, "grad": 2e-5}
# [vlm]: Llama-3.2-Vision-90B (configs/llama_3_2_vision_90b.py), the VLM
# family, at full width: periods of 4 self-attention + dense sub-layers
# and a gated cross-attention + dense one over 1601 patch embeddings.
# Served at VL_SERVE_PERIODS of its 20 periods (30 layers, 6 of them
# cross-attention; 27,770,986,508 bf16 parameters, 55.54 GB; the config's
# 100 layers are 175.3 GB, 7 periods 64.10 GB), batch 4, a 4064-token
# prompt, 1601 patches a row, 32 tokens. At VL_MERGE_PERIODS
# (6,379,626,498 parameters, 12.76 GB) B9 against its plain version and
# the merge: a bf16 base and VL_K fine-tunes of the cross sub-layer alone
# (855,654,402 parameters with its two gates; Llama 3.2 Vision trains its
# cross-attention layers over a frozen language model) that leave the
# rest to the base. The gates start at 0, and tanh(0) = 0 hides the
# cross path: every model here has them at VL_GATES (`set_gates`), and
# each fine-tune moves them
VLM = "llama-3.2-vision-90b"
VL_SERVE_PERIODS, VL_MERGE_PERIODS, VL_K = 6, 1, 2
# rows of the served batch that B9 against its plain version runs over
# (fp32 compute at a 4064-token prompt is the costly part)
VL_PLAIN_ROWS = 2
VL_GATES = {"gate_attn": 0.5, "gate_ffn": -0.7}
# [deepseek]: DeepSeek-V2-236B (configs/deepseek_v2_236b.py), multi-head
# latent attention over fine-grained experts, at full width (d_model 5120,
# 128 heads, kv_lora 512, q_lora 1536, 160 routed experts of 1536, top-6,
# and 2 shared; vocabulary 102,400). Served at DS_SERVE_LAYERS of its 60
# layers (the dense layer 0 and 7 MLA + MoE layers: 29,191,377,920 bf16
# parameters, 58.38 GB; 12 layers would be 90.16 GB), batch 4, a
# DS_PROMPT-token prompt (a multiple of the 512-query chunk: 4064 gives
# 7 chunks that do not tile it, which the reference asserts against), 32
# tokens. At DS_MERGE_LAYERS (layer 0 and one MLA + MoE layer:
# 5,358,679,040 parameters, 10.72 GB) a bf16 base and DS_K fine-tunes of
# every leaf but the routed experts' (1,583,805,440 parameters each;
# the three expert leaves, 3,774,873,600 elements, stay the base's),
# merged through two replicas and served
DEEPSEEK = "deepseek-v2-236b"
DS_SERVE_LAYERS, DS_MERGE_LAYERS, DS_K = 8, 2, 2
DS_PROMPT = 4096
# one layer's MLA prefill attention against SDPA's fused backends on the
# same seeded inputs: the largest difference over the largest output
# (outputs up to 4.3). An H100 80GB HBM3 (700.00 W) read 1.562e-2 / 4.312
# = 3.6e-3 for cuDNN's and the memory-efficient backend (one bf16 ulp in
# the outputs' top binade); the limit is twice that
DS_SDPA_TOL = 2.0 ** -7
# [vlm-train]: Llama-3.2-Vision-90B trained at full width at VT_PERIODS of
# its 20 periods (4 self-attention + dense sub-layers and a gated
# cross-attention + dense one, with the embedding and the head:
# 6,379,626,498 parameters) under the dry run's `parambf16` variant: bf16
# parameters and gradients beside the config's bf16 moments, 8 bytes a
# parameter, 51.0 GB of state (fp32 parameters would be 76.6 GB); bf16
# compute, remat; batch VT_BATCH x VT_SEQ in VT_ACCUM microbatches, each
# row with make_batch's 1601 patches, the gates at VL_GATES; VT_STEPS
# steps, the last traced; no resume (a 51 GB checkpoint would spend the
# phase on disk; resume is held bitwise in [train-d2] and
# [qwen3-moe-train], and bf16 checkpoints round-trip in the CPU tests)
VT_PERIODS = 1
VT_BATCH, VT_SEQ, VT_ACCUM, VT_STEPS = 2, 4096, 2, 2
# the learning rate of a bf16-parameter run, from the first step (warmup
# 1): the configs' schedule gives 3e-6 at step 0 (3e-4 after 100 warmup
# steps), under half a bf16 ulp of nearly every weight, of the norms at
# 1.0 and of the gates at 0.5 and -0.7 (2^-10 to 2^-8), so nothing would
# move; Adam's first step is +-lr an element (less lr x 0.1 x p of weight
# decay) where the gradient is well above Adam's eps, and 5e-3 moves each
# of them either way (a norm at 1.0 up by 4.5e-3, past the 3.9e-3
# midpoint to 1 + 2^-7)
BF16_TRAIN_LR = 5e-3
# [deepseek-train]: DeepSeek-V2-236B trained at full width at
# DS_TRAIN_LAYERS of its 60 layers (the dense layer 0, outside remat as
# the reference's, and one MLA layer with 160 routed experts, top-6, and
# 2 shared: 5,358,679,040 parameters) under DS_TRAIN_VARIANT `parambf16`:
# bf16 parameters and gradients beside the config's bf16 moments, 8 bytes
# a parameter, 42.9 GB (the config's fp32 parameters, 12 bytes a
# parameter, 64.3 GB, ran out of memory on an H100 80GB HBM3 at 83.81 GB
# in the first step: layer 0's attention saved outside remat and the
# recomputed layer's expert weights cast to bf16 beside the state), bf16
# compute, remat; batch DS_TRAIN_BATCH x DS_TRAIN_SEQ (8 query chunks of
# 512) in DS_TRAIN_ACCUM microbatches, DS_TRAIN_STEPS steps, the last
# traced, no resume (as [vlm-train]), learning rate BF16_TRAIN_LR
DS_TRAIN_LAYERS, DS_TRAIN_VARIANT = 2, "parambf16"
DS_TRAIN_BATCH, DS_TRAIN_SEQ, DS_TRAIN_ACCUM, DS_TRAIN_STEPS = \
    2, 4096, 2, 2
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
    phase_jamba_flash_kernel(rows, g)
    phase_encdec_vlm_flash_kernel(rows, g)
    phase_flash_backward(rows, cfg, g)
    phase_gemma2_flash_backward(rows, g)
    phase_whisper_flash_backward(rows, g)
    phase_vlm_flash_train(rows, g)
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
               floor: float = FLASH_BF16_FLOOR["phi3"],
               causal: bool = True) -> dict:
    """B9 at one shape (causal unless `causal` is False: every query sees
    every key, the enc-dec and VLM cross-attention and Whisper's
    encoder; with gemma2's `window` and `softcap` where given): held
    against its plain version (FLASH_F32_ATOL, or one bf16 ulp +
    `floor`), then timed, the kernel and the library call over 10
    CUDA-event-timed calls, the plain version over 3. The library call,
    on [B, H, S, D] copies: `scaled_dot_product_attention` over the
    visible keys, or with a softcap or window `flex_attention`
    (`flex_library`). Bound: the operations of the (query, key) pairs
    each row sees (4 D flops a pair) and the bytes of q, the output and
    the keys some row sees, at the peak rate of q's type."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        DECODE_ROWS, flash_attention, flash_attention_plain, visible_keys)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    kw = dict(q_offset=q_offset, window=window, softcap=softcap,
              scale=scale, causal=causal)

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
    kbeg, kmax = visible_keys(sq, sk, causal, q_offset, window)
    pairs = sq * sk if not causal else sum(
        min(sk, q_offset + i + 1)
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
        lib_causal = causal and sq > 1

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=lib_causal, scale=scale or None,
                enable_gqa=h != hk)

        out["library_ms"] = cuda_ms(library, 10)
        lib = f"(sdpa) {out['library_ms']:.3f} ms"
        del qt, kt, vt
    del want
    design = ("decode design" if sq <= DECODE_ROWS else
              "prefill on the tensor cores" if q.dtype == torch.bfloat16
              else "prefill, scalar fp32 instance")
    log(f"[kernels] flash_attention ({design}) q {list(q.shape)} k/v "
        f"{list(k.shape)} {str(q.dtype)[6:]}, "
        f"{'causal' if causal else 'non-causal'}, q_offset {q_offset}, "
        f"window {window}, softcap {softcap}: {rule}, max abs err "
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
                   scale: float = 0.0, causal: bool = True) -> dict:
    """B9's gradient at one shape (q_offset 0, causal unless `causal` is
    False; with gemma2's `window` and `softcap` where given): the LSE forward held bitwise
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
    kw = dict(scale=scale, causal=causal,
              **({"window": window} if window else {}),
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
    pairs = sq * sk if not causal else sum(
        min(sk, i + 1) - (max(0, i - window + 1) if window else 0)
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
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
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
        f"[{b}, {sk}, {hk}, {d}] {str(q.dtype)[6:]}, "
        f"{'causal' if causal else 'non-causal'}, window "
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
                "mamba2": (),
                "mamba2 merge": ("nary_accum", "block_amax", "block_hist",
                                 "ties_block"),
                "jamba": ("flash_attention",),
                "jamba merge": ("nary_accum", "block_amax", "block_hist",
                                "ties_block"),
                "whisper": ("flash_attention",),
                "whisper merge": ("nary_accum", "block_amax", "block_hist",
                                  "ties_block"),
                "vlm": ("flash_attention",),
                "vlm merge": ("nary_accum", "block_amax", "block_hist",
                              "ties_block"),
                "deepseek": (),
                "deepseek merge": ("nary_accum", "block_amax",
                                   "block_hist", "ties_block"),
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


def sparse_update(cfg, base, seed: int, keep=None) -> dict:
    """A fine-tune of the leaves whose keystr path `keep` admits (by
    default the attention projections, SPARSE_LEAVES: an adapter update)
    by `make_models`' recipe: base + 0.1 x a delta drawn as the schema
    initialises those leaves from `seed` (per path, so the same values
    as in a whole draw), in bf16 on the device."""
    from repro_torch import pytree
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    keep = keep or (lambda path: path in SPARSE_LEAVES)

    def kept(node, path=""):
        if not isinstance(node, dict):
            return node if keep(path) else None
        out = {k: kept(v, f"{path}['{k}']") for k, v in node.items()}
        return {k: v for k, v in out.items() if v is not None} or None

    delta = init_from_schema(kept(Model(cfg).schema()), seed=seed,
                             device=DEVICE, dtype=base["embed"].dtype)
    flat, treedef = pytree.flatten_with_path(delta)
    bleaves = {pytree.keystr(p): t
               for p, t in pytree.flatten_with_path(base)[0]}
    return treedef.unflatten([bleaves[pytree.keystr(p)] + d * 0.1
                              for p, d in flat])


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
    return {"wall_ms": wall, "kernels": n, "groups": groups,
            "by_kernel": kernels}


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
    set of experts; in the stack's last sub-layer, when it is a MoE one,
    only the compared last position's; in a decode step, only while the
    two runs have fed the row the same tokens: `first_route_flips`), and
    at that
    difference every token routed otherwise must have been a near tie
    (the first run's k-th and (k+1)-th probabilities within FLIP_GAP[cd]
    of the k-th)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    if other is None:
        def other(c):
            return Model(c, attention=flash_attention_plain)
    model = Model(cfg)
    params = init_from_schema(model.schema(), seed=SEED,
                              device=DEVICE, dtype=torch.bfloat16)
    set_gates(model, params)
    nb, prompt = batch["tokens"].shape
    # router calls a forward: one a MoE sub-layer
    n_moe = model.n_periods * sum(sl.ffn == "moe" for sl in model.layout)
    tail = bool(model.layout) and model.layout[-1].ffn == "moe"
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
        same = (kt == pt).to(torch.int32).cumprod(dim=1).sum(dim=1)
        upto, flips = first_route_flips(ra, rb, nb, n_moe, steps,
                                        tail=tail,
                                        fed=[int(n) for n in same])
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
            f"{'decoder ' if model.encdec else ''}layers, batch "
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


def first_route_flips(ra, rb, nb: int, n_moe: int, steps: int,
                      tail: bool = False, fed=None):
    """(steps to compare per row, [(row, step, largest relative gap,
    tokens routed otherwise)] at each row's first routing difference) of
    two recorded runs of `greedy_decode`: call c runs at step c // n_moe
    (0 the prefill), one router call per MoE sub-layer, n_moe of them a
    forward. A token is routed otherwise when its set of k experts
    differs (their order within the top k changes only the order the
    combine sums in). With `tail` the stack's last sub-layer is a MoE
    one: no mixer follows it, so a token it routes otherwise moves only
    that token's own output, and in its calls only the last position
    (the one whose logits are compared, and whose token is fed on)
    counts. `fed[r]`: how many of row r's first generated tokens the two
    runs share; a decode step's routing is compared only while they
    have fed the row the same tokens (past the first token that
    differs, the row's comparison has stopped). Without routers every
    row compares all steps + 1 logits."""
    upto = [steps + 1] * nb
    flips = []
    for c, ((ia, gap), (ib, _)) in enumerate(zip(ra, rb)):
        diff = (ia.sort(-1).values != ib.sort(-1).values).any(-1)  # [G, s]
        if tail and c % n_moe == n_moe - 1:
            diff, gap = diff[:, -1:], gap[:, -1:]
        for r in range(nb):
            if fed is not None and c // n_moe > fed[r]:
                continue
            if upto[r] == steps + 1 and bool(diff[r].any()):
                upto[r] = c // n_moe
                flips.append((r, c // n_moe,
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
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params
    from repro_torch.models.schema import init_from_schema
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
    merged = merge_and_serve(cfg2, Q3_K, "qwen3-moe", batch, {
        "flash_attention": cfg2.n_layers * (SERVE_GEN + 1)})
    cfgp = cfg.replace(n_layers=Q3_PLAIN_LAYERS)
    served_vs_plain(cfgp, batch, "qwen3-vs-plain")
    served_vs_plain(cfgp, batch, "qwen3-gather-vs-einsum",
                    other=lambda c: Model(c, moe_impl="einsum"),
                    what="gather vs einsum dispatch")
    int8 = qwen3_int8(cfg)
    launches = {k: path["launches"][k] + merged["launches"][k]
                + int8["launches"][k] for k in path["launches"]}
    return {"launches": launches,
            "ms": {**path["ms"], **merged["ms"], **int8["ms"]}}


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


def phase_jamba_flash_kernel(rows: dict, g) -> None:
    """B9 at Jamba-1.5-Large's serving shapes (64 query heads over 8 KV
    heads of 128: H / HK = 8, as Qwen3's, twice the heads), held against
    its plain version and timed beside
    `scaled_dot_product_attention(enable_gqa=True)`: the prefill's q
    [4, 4096, 64, 128], k, v [4, 4096, 8, 128], causal, bf16; a decode
    step's q [4, 1, 64, 128] over the 4128-slot cache at q_offset
    4095."""
    from repro_torch.configs import get_config
    cfg = get_config(JAMBA)
    dev = torch.device(DEVICE)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    cases = {}
    qkv = [randn(SERVE_BATCH, JB_PROMPT, n, d) for n in (h, hk, hk)]
    cases["jamba prefill bf16"] = flash_case(
        *qkv, 0, floor=FLASH_BF16_FLOOR["gemma2"])
    del qkv
    torch.cuda.empty_cache()
    q = randn(SERVE_BATCH, 1, h, d)
    kv = [randn(SERVE_BATCH, JB_PROMPT + SERVE_GEN, hk, d) for _ in range(2)]
    cases["jamba decode bf16"] = flash_case(q, *kv, JB_PROMPT - 1)
    del q, kv
    torch.cuda.empty_cache()
    rows["flash_attention"].update(cases)


def phase_encdec_vlm_flash_kernel(rows: dict, g) -> None:
    """B9 at Whisper-tiny's and Llama-3.2-Vision's serving shapes, held
    against its plain version and timed beside
    `scaled_dot_product_attention` (`enable_gqa` at H != HK), bf16,
    non-causal over a ragged Sk (1500 % 64 = 28, 1601 % 64 = 1) unless
    said: Whisper's encoder q, k, v [WH_BATCH, 1500, 6, 64]; its cross
    prefill, q [WH_BATCH, WH_PROMPT, 6, 64] over the 1500 frames (the
    decode design); a decode step over the cross cache, and over the
    self cache (causal, 228 slots at q_offset 227); the VLM's cross
    prefill q [4, 4064, 64, 128] over k, v [4, 1601, 8, 128], and a
    decode step over the patches."""
    from repro_torch.configs import get_config
    dev = torch.device(DEVICE)
    floor = FLASH_BF16_FLOOR["gemma2"]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    cases = {}
    wc = get_config(WHISPER)
    h, hk, d = wc.n_heads, wc.n_kv_heads, wc.resolved_head_dim
    frames = wc.encoder_seq
    kv = [randn(WH_BATCH, frames, hk, d) for _ in range(2)]
    cases["whisper encoder bf16"] = flash_case(
        randn(WH_BATCH, frames, h, d), *kv, 0, floor=floor, causal=False)
    cases["whisper cross prefill bf16"] = flash_case(
        randn(WH_BATCH, WH_PROMPT, h, d), *kv, 0, floor=floor,
        causal=False)
    cases["whisper cross decode bf16"] = flash_case(
        randn(WH_BATCH, 1, h, d), *kv, 0, floor=floor, causal=False)
    slots = WH_PROMPT + WH_GEN
    kv = [randn(WH_BATCH, slots, hk, d) for _ in range(2)]
    cases["whisper self decode bf16"] = flash_case(
        randn(WH_BATCH, 1, h, d), *kv, slots - 1, floor=floor)
    del kv
    vc = get_config(VLM)
    h, hk, d = vc.n_heads, vc.n_kv_heads, vc.resolved_head_dim
    kv = [randn(SERVE_BATCH, vc.num_patches, hk, d) for _ in range(2)]
    cases["vlm cross prefill bf16"] = flash_case(
        randn(SERVE_BATCH, SERVE_PROMPT, h, d), *kv, 0, floor=floor,
        causal=False)
    cases["vlm cross decode bf16"] = flash_case(
        randn(SERVE_BATCH, 1, h, d), *kv, 0, floor=floor, causal=False)
    del kv
    torch.cuda.empty_cache()
    rows["flash_attention"].update(cases)


def phase_whisper_flash_backward(rows: dict, g) -> None:
    """B9's gradient at [whisper]'s training microbatch (WH_TRAIN_BATCH /
    WH_TRAIN_ACCUM rows), bf16, non-causal: the encoder's self-attention
    (q, k, v, dO [32, 1500, 6, 64]) and the decoder's cross-attention
    (q, dO [32, 448, 6, 64] over k, v [32, 1500, 6, 64]), each held
    against the plain backward (FLASH_BWD_*) and timed beside
    `scaled_dot_product_attention`'s backward."""
    from repro_torch.configs import get_config
    cfg = get_config(WHISPER)
    dev = torch.device(DEVICE)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mb, frames = WH_TRAIN_BATCH // WH_TRAIN_ACCUM, cfg.encoder_seq

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    cases = {}
    for label, sq in (("encoder", frames), ("cross", WH_TRAIN_SEQ)):
        q, dout = randn(mb, sq, h, d), randn(mb, sq, h, d)
        k, v = randn(mb, frames, hk, d), randn(mb, frames, hk, d)
        cases[f"whisper {label} bf16"] = flash_bwd_case(q, k, v, dout,
                                                        causal=False)
        del q, k, v, dout
    torch.cuda.empty_cache()
    rows["flash_attention_backward"].update(cases)


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


def phase_mamba2() -> dict:
    """`[mamba2]`: Mamba2-780M on the card, every mixer the SSD of
    `models.mamba` (plain PyTorch ops: no kernel of its own). Full depth:
    its 780,148,992 parameters seeded in bf16 (`init_from_schema`), then
    `greedy_decode` twice (batch 4, a M2_PROMPT-token prompt from
    `make_batch`, 32 tokens), byte-identical tokens and logits; the
    prefill alone for the split; one decode step and one prefill traced.
    Then `mamba2_ssd_time`,
    `mamba2_checks` at M2_CHECK_LAYERS, `merge_and_serve` at full depth
    and `mamba2_train` at full depth."""
    import gc
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.models import mamba
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    engine.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(MAMBA2)
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
    d_inner, heads, conv_dim = mamba.mamba_dims(cfg)
    m = cfg.mamba
    log(f"[mamba2] {cfg.name}: {n} bf16 parameters ({n * 2 / 1e9:.2f} GB; "
        f"{cfg.n_layers} SSD mixers, d_model {cfg.d_model}, d_inner "
        f"{d_inner}, {heads} heads of {m.head_dim}, d_state {m.d_state}, "
        f"conv {m.d_conv} x {conv_dim}, chunk {m.chunk_size}; vocabulary "
        f"{cfg.vocab_size}, tied) seeded in {time.perf_counter() - t0:.1f} "
        f"s")
    batch = serve_batch(cfg, SERVE_BATCH, M2_PROMPT)
    out = {}

    def serve(label, p):
        def thunk():
            out[label] = greedy_decode(model, p, batch, SERVE_GEN,
                                       return_logits=True)
        return thunk

    calls = [("greedy_decode 1", serve("1", params)),
             ("greedy_decode 2", serve("2", params))]
    torch.cuda.reset_peak_memory_stats()
    path = run_path("mamba2", calls, expect={label: {} for label, _ in
                                             calls})
    serve_peak = torch.cuda.max_memory_allocated()
    (tok1, lg1), (tok2, lg2) = out.pop("1"), out.pop("2")
    check_served("mamba2", tok1, lg1[-1], cfg, SERVE_BATCH, SERVE_GEN)
    if not (torch.equal(tok1, tok2) and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(lg1, lg2))):
        raise AssertionError("[mamba2] two greedy_decode calls differ")
    total = path["ms"]["greedy_decode 2"] / 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch,
                                   max_len=M2_PROMPT + SERVE_GEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    decode_ms = (total - t_prefill) * 1e3 / SERVE_GEN
    cache_gb = sum(t.numel() * t.element_size()
                   for t in pytree.leaves(caches)) / 1e9
    log(f"[mamba2] {cfg.n_layers} layers, batch {SERVE_BATCH}, prompt "
        f"{M2_PROMPT}, {SERVE_GEN} tokens: no kernel launched (the SSD is "
        f"plain PyTorch ops); tokens and all {SERVE_GEN + 1} logits "
        f"byte-identical across the two calls; greedy_decode "
        f"{path['ms']['greedy_decode 1'] / 1e3:.3f} s (first call), "
        f"{total:.3f} s (second) = prefill {t_prefill:.3f} s (timed alone) "
        f"+ {decode_ms:.2f} ms per decode step; "
        f"{SERVE_BATCH * SERVE_GEN / total:.1f} generated tokens/s "
        f"({SERVE_BATCH * SERVE_GEN / (total - t_prefill):.1f} after the "
        f"prefill); cache {cache_gb:.3f} GB (SSM states fp32 + conv "
        f"caches, whatever the length); peak {serve_peak / 1e9:.2f} GB over "
        f"the two calls; tokens[0] {tok1[0].tolist()}")
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    trace_device("decode step", lambda: model.decode_step(
        params, caches, tok, M2_PROMPT), tag="mamba2")
    del caches, logits, lg1, lg2
    traced = trace_device("prefill", lambda: model.prefill(
        params, batch, max_len=M2_PROMPT + SERVE_GEN), tag="mamba2")
    del params, calls      # the thunks hold the weights too
    torch.cuda.empty_cache()
    mamba2_ssd_time(cfg, sum(traced.get("groups", {}).values()))
    mamba2_checks(cfg)
    merged = merge_and_serve(cfg, M2_K, "mamba2", batch, {})
    train = mamba2_train(cfg)
    launches = {k: path["launches"][k] + merged["launches"][k]
                + train["launches"][k] for k in path["launches"]}
    return {"launches": launches, "ms": {**path["ms"], **merged["ms"]}}


def ssd_inputs(cfg, b: int, s: int, dtype, grad: bool = False) -> list:
    """Seeded inputs of `ssd_chunked` at one layer's shapes: xh, B and C
    in `dtype`, dt (softplus of a normal draw, as the block makes it), A's
    log (0, the init) and D fp32."""
    from repro_torch.models import mamba
    m = cfg.mamba
    _, h, _ = mamba.mamba_dims(cfg)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)

    def draw(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=DEVICE).to(dt)

    out = [draw(b, s, h, m.head_dim),
           mamba._softplus(draw(b, s, h, dt=torch.float32)),
           torch.zeros(h, device=DEVICE),
           draw(b, s, m.n_groups, m.d_state),
           draw(b, s, m.n_groups, m.d_state),
           torch.ones(h, device=DEVICE)]
    return [t.requires_grad_(grad) for t in out]


def ssd_bound(cfg, b: int, s: int, dtype, backward: bool) -> tuple:
    """(bound ms, by, reference flops, port flops) of `ssd_chunked`'s
    forward (and backward: twice the products' flops again) at [b, s]:
    the reference's four fp32 einsums (C.B per head, its product with x,
    the chunk states, the inter-chunk term), or the port's (C.B once a
    group); bytes: each input read once, y and the final state written
    once."""
    from repro_torch.models import mamba
    m = cfg.mamba
    _, h, _ = mamba.mamba_dims(cfg)
    cs = min(m.chunk_size, s)
    nc = s // cs
    p, n, g = m.head_dim, m.d_state, m.n_groups
    per_chunk = 2 * cs * cs * h * p + 4 * cs * h * p * n
    ref = 2 * b * nc * (cs * cs * h * n) + b * nc * per_chunk
    port = 2 * b * nc * (cs * cs * g * n) + b * nc * per_chunk
    mult = 3 if backward else 1
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (b * s * h * p * size * 2 + b * s * h * 4
              + 2 * b * s * g * n * size + b * h * p * n * 4)
    t, by, _, _ = bound_ms(nbytes * mult, port * mult)
    return t, by, ref * mult, port * mult


def mamba2_ssd_time(cfg, prefill_busy_ms: float) -> None:
    """`ssd_chunked` alone by CUDA events: the served prefill's layer
    (batch SERVE_BATCH x M2_PROMPT, bf16 inputs, forward under
    `inference_mode`) and the trained microbatch's (M2_TRAIN_BATCH /
    M2_TRAIN_ACCUM x M2_TRAIN_SEQ, forward and backward), beside its
    bound (`ssd_bound`) and the reference's flop count at 67 TFLOP/s.
    The served layer's time, n_layers times over, is set beside the
    traced prefill's device busy time (`prefill_busy_ms`)."""
    from repro_torch.models import mamba
    for label, b, s, backward in (
            ("served prefill", SERVE_BATCH, M2_PROMPT, False),
            ("trained microbatch, forward + backward",
             M2_TRAIN_BATCH // M2_TRAIN_ACCUM, M2_TRAIN_SEQ, True)):
        xs = ssd_inputs(cfg, b, s, torch.bfloat16, grad=backward)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()

        if backward:
            def fn():
                y, h = mamba.ssd_chunked(*xs, cfg.mamba)
                torch.autograd.backward((y, h), (torch.ones_like(y),
                                                 torch.ones_like(h)))
        else:
            def fn():
                with torch.inference_mode():
                    mamba.ssd_chunked(*xs, cfg.mamba)
        ms = cuda_ms(fn, 5)
        peak = torch.cuda.max_memory_allocated() - held
        t, by, ref, port = ssd_bound(cfg, b, s, torch.bfloat16, backward)
        log(f"[mamba2] ssd_chunked alone, {label} [{b}, {s}] a layer: "
            f"{ms:.3f} ms (median of 5, CUDA events); bound {t:.3f} ms "
            f"({by}: the port's products {port:.3e} fp32 flops at 67 "
            f"TFLOP/s, {t / ms:.1%} of it); the reference's einsums "
            f"{ref:.3e} flops, {ref / FP32_OPS_PER_S * 1e3:.3f} ms; "
            f"{peak / 1e9:.2f} GB of transients")
        if not backward and prefill_busy_ms:
            log(f"[mamba2] ssd_chunked alone x {cfg.n_layers} layers = "
                f"{ms * cfg.n_layers:.2f} ms, "
                f"{ms * cfg.n_layers / prefill_busy_ms:.1%} of the traced "
                f"prefill's device busy time {prefill_busy_ms:.2f} ms")
        del xs
    torch.cuda.empty_cache()


def mamba2_checks(cfg) -> None:
    """At M2_CHECK_LAYERS, fp32, on `init_from_schema` weights: the
    chunked prefill of M2_DUAL_S tokens against a prefill of M2_DUAL_S -
    M2_DUAL_M and M2_DUAL_M recurrent decode steps (the last logits and
    every layer's SSM state and conv cache, M2_DUAL_TOL), then the
    card's prefill of M2_CPU_S tokens against the CPU's on the same
    weights (logits and both caches, M2_CPU_TOL)."""
    from repro_torch import pytree
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    cfg2 = cfg.replace(n_layers=M2_CHECK_LAYERS, compute_dtype="float32")
    model = Model(cfg2)
    params = init_from_schema(model.schema(), seed=SEED, device=DEVICE)
    toks = serve_batch(cfg2, M2_CHECK_BATCH, M2_DUAL_S)["tokens"]

    def rel(a, b) -> float:
        return float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))

    def compare(tag, got, want, tol):
        (gl, gc), (wl, wc) = got, want
        read = {"logits": float((gl.cpu() - wl.cpu()).abs().max()),
                "state": max(rel(w[0][i].cpu(), g[0][i].cpu())
                             for g, w in zip(gc["blocks"].values(),
                                             wc["blocks"].values())
                             for i in range(M2_CHECK_LAYERS)),
                "conv": max(rel(w[1][i].cpu(), g[1][i].cpu())
                            for g, w in zip(gc["blocks"].values(),
                                            wc["blocks"].values())
                            for i in range(M2_CHECK_LAYERS))}
        ok = all(read[k] <= tol[k] for k in read)
        log(f"[mamba2] {tag}: last logits {read['logits']:.3e} apart (of "
            f"{float(wl.abs().max()):.3f}), SSM states {read['state']:.3e} "
            f"and conv caches {read['conv']:.3e} of their largest "
            f"magnitude; limits {tol}: {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"[mamba2] {tag}: {read} beyond {tol}")

    t0 = time.perf_counter()
    full = model.prefill(params, {"tokens": toks})
    start = M2_DUAL_S - M2_DUAL_M
    logits, caches = model.prefill(params, {"tokens": toks[:, :start]})
    for pos in range(start, M2_DUAL_S):
        logits, caches = model.decode_step(params, caches,
                                           toks[:, pos:pos + 1], pos)
    compare(f"chunked prefill of {M2_DUAL_S} "
            f"({M2_DUAL_S // cfg.mamba.chunk_size} chunks) "
            f"vs prefill of {start} + {M2_DUAL_M} recurrent steps, "
            f"{M2_CHECK_LAYERS} layers fp32, batch {M2_CHECK_BATCH}, "
            f"{time.perf_counter() - t0:.1f} s", (logits, caches), full,
            M2_DUAL_TOL)
    del full, caches
    t0 = time.perf_counter()
    card = model.prefill(params, {"tokens": toks[:, :M2_CPU_S]})
    host = model.prefill(pytree.tree_map(lambda t: t.cpu(), params),
                         {"tokens": toks[:, :M2_CPU_S].cpu()})
    compare(f"card vs CPU, prefill of {M2_CPU_S}, same weights, "
            f"{time.perf_counter() - t0:.1f} s", card, host, M2_CPU_TOL)
    del params
    torch.cuda.empty_cache()


def hold_leaves_vs_exact(tag: str, label: str, exact, kern,
                         ties: bool) -> None:
    """A kernel route's tree against the exact route's, leaf by leaf:
    elements beyond one bf16 ulp (LIN_ATOL + LIN_RTOL |exact|). None may
    be for the linear family. For TIES (the exact path trims in bf16
    arithmetic, the kernels in fp32) the whole tree's share is held to
    TIES_MAX_DIFF_SHARE and each leaf's to TIES_LEAF_MAX_DIFF_SHARE,
    rounded up to a whole element, so a leaf the kernels got wrong fails
    however small it is. Logs the totals and the worst leaf; raises on a
    leaf or a tree past its limit."""
    from repro_torch import pytree
    pairs, _ = pytree.flatten_with_path(exact)
    total = bad = 0
    worst = (0.0, "", 0, 0)
    failed = []
    for (path, e), k in zip(pairs, pytree.leaves(kern)):
        if e is k:       # one tensor in both trees (a leaf inherited)
            total += e.numel()
            continue
        e32, k32 = e.to(torch.float32), k.to(torch.float32)
        d = (e32 - k32).abs()
        n = int((d > LIN_ATOL + LIN_RTOL * e32.abs()).sum())
        limit = math.ceil(TIES_LEAF_MAX_DIFF_SHARE * d.numel()) \
            if ties else 0
        name = pytree.keystr(path)
        if n > limit:
            failed.append((name, n, d.numel()))
        if n / d.numel() >= worst[0]:
            worst = (n / d.numel(), name, n, d.numel())
        bad += n
        total += d.numel()
    if ties and bad / total > TIES_MAX_DIFF_SHARE:
        failed.append(("the tree", bad, total))
    rule = (f"the tree <= {TIES_MAX_DIFF_SHARE}, each leaf <= "
            f"ceil({TIES_LEAF_MAX_DIFF_SHARE} x its elements)" if ties
            else "none in any leaf")
    log(f"[{tag}] {label}, kernel route vs exact route (replica A): "
        f"{bad}/{total} = {bad / total:.2e} beyond one bf16 ulp; worst "
        f"leaf {worst[1]} {worst[2]}/{worst[3]}; {len(pairs)} leaves, rule "
        f"{rule}: {'FAIL ' + str(failed) if failed else 'ok'}")
    if failed:
        raise AssertionError(f"[{tag}] {label}: the kernel route is outside "
                             f"the exact route's tolerance in {failed}")


def merge_and_serve(cfg, k: int, tag: str, batch: dict,
                    launches: dict, models=None,
                    gen: int = SERVE_GEN) -> dict:
    """A base and k contributions (base + 0.1 x a seeded delta,
    `make_models`, bf16; or `models`, (base, contributions), which it
    empties) at `cfg`'s depth go to two replicas in opposite
    orders (B given A's eids, as a sync delivers them); each resolves
    histogram TIES and weight_average on the kernel routes
    (`engine.merge(..., kernels=True)` over its canonical order, with the
    registered base's leaf digests; path f"{tag} merge") to
    byte-identical trees, each held leaf by leaf
    against replica A's exact route (`hold_leaves_vs_exact`), and the
    TIES trees serve byte-identical tokens and logits through
    `greedy_decode` of `gen` tokens (path `tag`, each call launching
    exactly `launches`). Returns {"launches", "ms"}."""
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.core import engine
    from repro_torch.core.resolve import canonical_order, seed_from_root
    from repro_torch.models.model import Model
    from repro_torch.strategies import get_strategy
    from repro_torch.train.serve import greedy_decode
    t0 = time.perf_counter()
    if models is None:
        base, contribs = make_models(cfg, DEVICE, k=k)
    else:
        base, contribs = models[0], list(models[1])
        models[1].clear()
    rep_a = Replica(f"{tag}-a", device=DEVICE)
    eids = [rep_a.contribute(c) for c in contribs]
    ref_a = rep_a.register_base(base)
    rep_b = Replica(f"{tag}-b", device=DEVICE)
    for c, eid in zip(contribs[::-1], eids[::-1]):
        rep_b.contribute(c, eid)
    ref_b = rep_b.register_base(base)
    if rep_a.merkle_root() != rep_b.merkle_root() or ref_a != ref_b:
        raise AssertionError(f"[{tag}] the two replicas disagree on Layer 1")
    del contribs
    where = f"merged, {cfg.n_layers} layers"
    log(f"[{tag}] {where}: {k} contributions + base "
        f"({sum(t.numel() for t in pytree.leaves(base))} bf16 parameters a "
        f"model) on two replicas in {time.perf_counter() - t0:.1f} s")
    merged = {}

    def kernel_merge(label, rep, ref, name, cfgd, uses_base):
        def thunk():
            order = canonical_order(rep.state)
            spec = MergeSpec(name, cfgd, base_ref=ref if uses_base else None)
            merged[label] = engine.merge(
                [rep.state.store[e] for e in order], spec=spec,
                contrib_ids=order, base=base if uses_base else None,
                seed=seed_from_root(rep.merkle_root()), kernels=True,
                use_cache=False, cache=rep.cache,
                base_digests=rep.base_digests(ref) if uses_base else None)
            check_output(f"{tag} {label}", merged[label], base)
        return thunk

    merges = [(f"{name} {rl}", kernel_merge(f"{name} {rl}", rep, ref, name,
                                            cfgd, ub))
              for name, cfgd, ub in (STRATEGIES[2], STRATEGIES[0])
              for rl, rep, ref in (("A", rep_a, ref_a), ("B", rep_b, ref_b))]
    merge_path = run_path(f"{tag} merge", merges)
    for name in ("ties", "weight_average"):
        differ = same_bytes(merged[f"{name} A"], merged[f"{name} B"])
        if differ:
            raise AssertionError(f"[{tag}] {name}: the replicas' trees "
                                 f"differ in {differ} leaves")
    for name, cfgd, uses_base in (STRATEGIES[2], STRATEGIES[0]):
        exact = rep_a.resolve(MergeSpec(name, cfgd, base_ref=ref_a
                                        if uses_base else None),
                              use_cache=False)
        hold_leaves_vs_exact(tag, f"{where}, {name}", exact,
                             merged[f"{name} A"], ties=name == "ties")
        del exact
    plan = engine.plan_for([rep_a.state.store[e] for e in eids],
                           contrib_ids=eids,
                           spec=MergeSpec("weight_average"))
    groups = engine._dispatch_groups(
        get_strategy("weight_average"), list(plan.tasks),
        max(t.stacked_nbytes for t in plan.tasks))
    log(f"[{tag}] {where}: replicas A and B (opposite orders) resolve "
        "histogram TIES and weight_average on the kernel routes to "
        f"byte-identical trees; groups {[len(g) for g in groups]} (leaves "
        "alone take the exact path)")
    # the thunks hold the replicas (their contributions) and the base
    del rep_a, rep_b, base, merges, plan, merged["weight_average A"], \
        merged["weight_average B"]
    model = Model(cfg)
    out = {}

    def serve(rl):
        def thunk():
            out[rl] = greedy_decode(model, merged[f"ties {rl}"], batch,
                                    gen, return_logits=True)
        return thunk

    calls = [(f"greedy_decode merged {rl}", serve(rl)) for rl in ("A", "B")]
    served = run_path(tag, calls, expect={label: launches for label, _ in
                                          calls})
    (ta, la), (tb, lb) = out.pop("A"), out.pop("B")
    check_served(f"{tag} merged", ta, la[-1], cfg, ta.shape[0], gen)
    if not (torch.equal(ta, tb) and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(la, lb))):
        raise AssertionError(f"[{tag}] the replicas' merged trees served "
                             "different tokens or logits")
    log(f"[{tag}] merged TIES trees serve byte-identical tokens and logits "
        f"(launches {launches or 'none'} each); tokens[0] {ta[0].tolist()}")
    del merged, out, la, lb, calls
    torch.cuda.empty_cache()
    return {"launches": {n: merge_path["launches"][n]
                         + served["launches"][n]
                         for n in merge_path["launches"]},
            "ms": {**merge_path["ms"], **served["ms"]}}


def mamba2_train(cfg) -> dict:
    """Mamba2-780M trained at full width and depth: fp32 parameters and
    AdamW moments, bf16 compute, remat per layer, from `init_from_schema`;
    M2_TRAIN_STEPS steps of `make_train_step` at batch M2_TRAIN_BATCH x
    M2_TRAIN_SEQ in M2_TRAIN_ACCUM microbatches on `SyntheticTask`
    batches, the last traced. Loss and grad norm finite at every step
    (the reference's masked decay gives a NaN gradient at chunk 256),
    every parameter leaf changed, and step 1 run again from a copy of the
    starting state gives the same bits (loss, grad norm and every leaf's
    `bits_fingerprint`)."""
    import gc
    from repro_torch import kernels, pytree
    from repro_torch.data.synthetic import SyntheticTask
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.step import init_train_state, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg.replace(grad_accum=M2_TRAIN_ACCUM)
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, params=init_from_schema(
        model.schema(), seed=SEED, device=DEVICE), device=DEVICE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(state["params"]))
    log(f"[mamba2-train] {cfg.name} {cfg.n_layers} layers, {n:,} parameters "
        f"{cfg.param_dtype}, moments {cfg.opt_state_dtype}, compute "
        f"{cfg.compute_dtype}, remat {cfg.remat}: state in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    first = clone_tree(state)
    before = leaf_samples(state["params"])
    step_fn = make_train_step(model, total_steps=M2_TRAIN_STEPS,
                              grad_accum=M2_TRAIN_ACCUM)
    task = SyntheticTask(cfg.vocab_size, M2_TRAIN_SEQ, task_id=0)

    def batch(i):
        return {"tokens": torch.as_tensor(task.batch(i, M2_TRAIN_BATCH),
                                          device=DEVICE)}

    kernels.reset_launch_counts()
    want = None
    for i in range(M2_TRAIN_STEPS):
        b = batch(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mets = {}

        def step(b=b, mets=mets):               # the state in place
            mets.update(step_fn(state, b)[1])
            torch.cuda.synchronize()

        last = i == M2_TRAIN_STEPS - 1
        t0 = time.perf_counter()
        if last:
            trace_device(f"train step {i + 1}", step, tag="mamba2-train",
                         host=False)
        else:
            step()
        dt = time.perf_counter() - t0
        loss = float(mets["loss"])
        gnorm = float(mets["grad_norm"])
        log(f"[mamba2-train] step {i + 1}: loss {loss:.4f}, grad norm "
            f"{gnorm:.4f}, {dt:.2f} s{' (traced)' if last else ''}, "
            f"{M2_TRAIN_BATCH * M2_TRAIN_SEQ / dt:.0f} tokens/s, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"mamba2 train step {i + 1}: loss {loss}, "
                                 f"grad norm {gnorm}")
        if i == 0:
            want = ([bits_fingerprint(t) for t in pytree.leaves(state)],
                    bits(mets["loss"]), bits(mets["grad_norm"]))
    counts = kernels.launch_counts()
    after = leaf_samples(state["params"])
    shares = [float((a != b).float().mean()) for a, b in zip(before, after)]
    if min(shares) == 0.0:
        raise AssertionError(f"a parameter leaf did not change: {shares}")
    if int(state["step"]) != M2_TRAIN_STEPS:
        raise AssertionError(f"step counter {int(state['step'])}")
    del state, before, after
    gc.collect()
    torch.cuda.empty_cache()
    # step 1 again from the copy of the starting state
    _, mets = step_fn(first, batch(0))
    got = ([bits_fingerprint(t) for t in pytree.leaves(first)],
           bits(mets["loss"]), bits(mets["grad_norm"]))
    same = sum(x == y for x, y in zip(got[0], want[0]))
    log(f"[mamba2-train] every parameter leaf changed (shares of sampled "
        f"elements changed {min(shares):.4f}-{max(shares):.4f}); {sum(counts.values())} "
        f"kernel launches; step 1 run again from a copy of the starting "
        f"state: {same} of {len(want[0])} leaves (params, m, v, step) with "
        f"the first run's bit fingerprint, loss and grad norm "
        f"{'bitwise equal' if torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]) else 'DIFFERENT'}")
    if same != len(want[0]) or not (torch.equal(got[1], want[1])
                                    and torch.equal(got[2], want[2])):
        raise AssertionError("mamba2: step 1 run twice from the same state "
                             "differs")
    del first
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts}


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
    # DURABLE_LAYERS = 1 (the engine's packing, largest first under a cap
    # of the largest leaf: int8 payloads priced at a byte an element,
    # decompressed ones at bf16's two; groups of 5 and 5 leaves, the
    # embedding and the head alone; at 2 layers groups of 5 and 3, 4
    # alone; at 4 layers groups of 5 and 2, 5 alone)
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
    and moments, bf16 compute, remat, through `train_resume` at batch
    G2_TRAIN_BATCH x G2_TRAIN_SEQ in G2_TRAIN_ACCUM microbatches (B9's
    gradient with the window and softcap raises nowhere and never gives
    way to its plain version on CUDA tensors)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(GEMMA2).replace(n_layers=2 * G2_TRAIN_PERIODS,
                                     grad_accum=G2_TRAIN_ACCUM)
    windows = [sl.window for sl in Model(cfg).layout]
    return train_resume(
        "gemma2-train", cfg, G2_TRAIN_STEPS, G2_TRAIN_BATCH, G2_TRAIN_SEQ,
        G2_TRAIN_ACCUM, f"{G2_TRAIN_PERIODS} of 23 periods (sub-layers "
        f"with windows {windows}; depth cut so that 16 bytes a parameter "
        f"and the logits stage of a {G2_TRAIN_SEQ}-token microbatch fit "
        "80 GB)", resume=False)


def train_resume(tag: str, cfg, steps: int, batch_size: int, seq: int,
                 accum: int, cut: str, routing: bool = False,
                 keep_params: bool = False, resume: bool = True) -> dict:
    """`cfg` trained on the card at full width (its parameter, moment
    and compute dtypes and remat) from `init_from_schema` drawn in the
    parameter dtype (the VLM's gates at VL_GATES, `set_gates`): `steps`
    steps of `make_train_step` at batch `batch_size` x `seq` in `accum`
    microbatches on `make_batch` batches (`SyntheticTask` 0's tokens, and
    the enc-dec family's frames or the VLM's patches). Per step: loss,
    grad norm, seconds, tokens per second, peak device memory; the last
    step traced (with `routing`, the MoE routing / gather kernels a group
    of their own). B9's forward and backward launch exactly as the
    attention sub-layers, microbatches and remat ask; every parameter
    leaf changes, but a bf16 leaf whose update `rounded_back` shows to
    round back to it everywhere. With `resume`: a checkpoint written
    after step `steps` - 1, the finished state fingerprinted
    (`bits_fingerprint`), the checkpoint restored and the last step run
    again: every leaf's fingerprint the uninterrupted run's. Returns
    {"launches", "traced"}, and with `keep_params` "params", the trained
    parameters (bitwise the uninterrupted run's)."""
    import gc
    import shutil
    import tempfile
    from repro_torch import kernels, pytree
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import ShapeSpec
    from repro_torch.core import engine
    from repro_torch.data.synthetic import make_batch
    from repro_torch.dtypes import BY_NAME
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        train_state_shapes)
    engine.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    held0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = init_train_state(model, params=init_from_schema(
        model.schema(), seed=SEED, device=DEVICE,
        dtype=BY_NAME[cfg.param_dtype]), device=DEVICE)
    set_gates(model, state["params"])
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(state["params"]))
    log(f"[{tag}] {cfg.name} at full width, {cut}, {n:,} parameters "
        f"{cfg.param_dtype}, moments {cfg.opt_state_dtype}, compute "
        f"{cfg.compute_dtype}, remat {cfg.remat}: state in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
        f"({held0 / 1e9:.2f} GB before it)")
    before = leaf_samples(state["params"])
    step_fn = make_train_step(model, total_steps=steps, grad_accum=accum)
    shape = ShapeSpec("train", seq, batch_size, "train")

    def batch(i):
        return {k: torch.as_tensor(v, device=DEVICE)
                for k, v in make_batch(cfg, shape, step=i).items()}

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_")
    traced = {}
    try:
        kernels.reset_launch_counts()
        ckpt_path, t_save = None, 0.0
        for i in range(steps):
            b = batch(i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mets = {}

            def step(b=b, mets=mets):           # the state in place
                mets.update(step_fn(state, b)[1])
                torch.cuda.synchronize()

            last = i == steps - 1
            t0 = time.perf_counter()
            if last:
                traced = trace_device(f"train step {i + 1}", step, tag=tag,
                                      host=False, routing=routing)
            else:
                step()
            dt = time.perf_counter() - t0
            loss = float(mets["loss"])
            gnorm = float(mets["grad_norm"])
            aux = f", aux {float(mets['aux']):.4f}" if cfg.moe else ""
            log(f"[{tag}] step {i + 1}: loss {loss:.4f}{aux}, grad norm "
                f"{gnorm:.4f}, {dt:.2f} s{' (traced)' if last else ''}, "
                f"{batch_size * seq / dt:.0f} tokens/s, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"{tag} step {i + 1}: loss {loss}, "
                                     f"grad norm {gnorm}")
            if resume and i == steps - 2:
                t0 = time.perf_counter()
                ckpt_path = save_checkpoint(
                    tmp, state, i + 1, metadata={"data_step": i + 1})
                t_save = time.perf_counter() - t0
        counts = kernels.launch_counts()
        after = leaf_samples(state["params"])
        shares = [float((a != b).float().mean())
                  for a, b in zip(before, after)]
        rounded = rounded_back(state, cfg, steps, shares)
        if min(shares) == 0.0 and len(rounded) < shares.count(0.0):
            raise AssertionError(f"a parameter leaf did not change: "
                                 f"{shares}")
        if int(state["step"]) != steps:
            raise AssertionError(f"step counter {int(state['step'])}")
        inner, outer = attention_calls(model)
        micro = steps * accum
        want = {"flash_attention": micro * (
                    inner * (2 if cfg.remat != "none" else 1) + outer),
                "flash_attention_backward": micro * (inner + outer)}
        got = {k: counts[k] for k in want}
        moved = [x for x in shares if x > 0.0]
        log(f"[{tag}] launches {got} (expected {want}: {inner} attention "
            f"calls under remat and {outer} outside it x {accum} "
            f"microbatches x {steps} steps, the forward again in each "
            f"remat); {len(moved)} of {len(shares)} parameter leaves "
            f"changed (shares of sampled elements changed "
            f"{min(moved):.4f}-{max(moved):.4f})"
            + "".join(f"; {name} did not: {why}"
                      for name, why in rounded.items()))
        if got != want:
            raise AssertionError(f"{tag} launches {got} != {want}")
        del before, after
        if resume:
            # resume: the finished state's fingerprints, the checkpoint
            # back on the card (two states do not fit), the last step
            t0 = time.perf_counter()
            want = [bits_fingerprint(t) for t in pytree.leaves(state)]
            t_print = time.perf_counter() - t0
            del state
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            state, meta = restore_checkpoint(
                ckpt_path, train_state_shapes(model), device=DEVICE)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            for i in range(int(meta["data_step"]), steps):
                state, _ = step_fn(state, batch(i))
            got = [bits_fingerprint(t) for t in pytree.leaves(state)]
            same = sum(x == y for x, y in zip(got, want))
            size = sum(os.path.getsize(os.path.join(ckpt_path, f))
                       for f in os.listdir(ckpt_path))
            log(f"[{tag}] resume: {steps} steps straight vs {steps - 1} + "
                f"save ({size / 1e9:.2f} GB, {t_save:.1f} s) + restore "
                f"({t_restore:.1f} s) + 1: {same} of {len(want)} leaves "
                "(params, m, v, step) with the uninterrupted run's bit "
                "fingerprint (bits_fingerprint, not an element-wise "
                f"comparison; {t_print:.1f} s for the state)")
            if same != len(want):
                raise AssertionError(f"{tag}: resume differs from the "
                                     "uninterrupted run")
        kept = state["params"] if keep_params else None
        del state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"launches": counts, "traced": traced}
    if keep_params:
        out["params"] = kept
    return out


def rounded_back(state: dict, cfg, steps: int, shares: list) -> dict:
    """{leaf name: why} for the bf16 parameter leaves of which no sampled
    element moved (`shares` 0) although the update reached them: their
    first moment is nonzero at some sampled element (a gradient
    arrived) and the last AdamW step, recomputed from the final
    moments at the last step's learning rate (m^ / (sqrt(v^) + eps) +
    weight decay x p, times lr), rounds back to the unchanged bf16 value
    at every sampled element. A step under half a bf16 ulp is lost to
    the parameter dtype, as in the reference's `parambf16`; fp32
    parameters keep it. Other unchanged leaves are not listed."""
    from repro_torch import pytree
    from repro_torch.optim import adamw
    if cfg.param_dtype == "float32" or 0.0 not in shares:
        return {}
    flat, _ = pytree.flatten_with_path(state["params"])
    ms = leaf_samples(state["m"])
    vs = leaf_samples(state["v"])
    ps = leaf_samples(state["params"])
    lr = float(adamw.lr_schedule(steps - 1, cfg, steps))
    c1, c2 = 1.0 - adamw.B1 ** steps, 1.0 - adamw.B2 ** steps
    out = {}
    for i, share in enumerate(shares):
        if share:
            continue
        p, m, v = (x[i].float() for x in (ps, ms, vs))
        step = lr * ((m / c1) / ((v / c2).sqrt() + adamw.EPS)
                     + adamw.WEIGHT_DECAY * p)
        back = torch.equal((p - step).to(ps[i].dtype), ps[i])
        if back and bool((m != 0).any()):
            out[pytree.keystr(flat[i][0])] = (
                f"its last step at most {float(step.abs().max()):.2e} "
                f"rounds back to every sampled element (first moment up "
                f"to {float(m.abs().max()):.2e}; Adam's eps "
                f"{adamw.EPS:g})")
    return out


def attention_calls(model) -> tuple:
    """(under remat, outside it): B9 launches of one training forward.
    A period stack's attention and cross-attention sub-layers run under
    remat; the enc-dec family's decoder layers (two calls each) too, its
    encoder layers (one each) outside it, as the reference's."""
    if model.encdec:
        return 2 * model.cfg.n_layers, model.cfg.n_encoder_layers
    return model.n_periods * sum(sl.mixer in ("attn", "cross")
                                 for sl in model.layout), 0


def serve_calls(model) -> tuple:
    """(prefill, decode step): B9 launches of a served forward: every
    attention and cross-attention sub-layer once (the enc-dec family:
    the encoder's layers and each decoder layer's two in prefill, the
    decoder's two a step)."""
    inner, outer = attention_calls(model)
    return inner + outer, inner


def serve_twice(tag: str, model, params, batch: dict, prompt: int,
                launches: dict, note: str, cache_note: str,
                routing: bool = False) -> dict:
    """The serving half of the `[jamba]`, `[vlm]` and `[deepseek]` phases:
    `greedy_decode` twice (batch SERVE_BATCH, a `prompt`-token prompt,
    SERVE_GEN tokens; path `tag`, each call launching exactly
    `launches`), byte-identical tokens and logits; the prefill alone for
    the split of a call into prefill and decode steps; one decode step
    and one prefill traced (`routing`: the MoE routing / gather kernels a
    group of their own). `note` describes the served shape in the log
    line, `cache_note` the cache. Returns run_path's {"launches",
    "ms"}."""
    from repro_torch import pytree
    from repro_torch.train.serve import greedy_decode
    cfg = model.cfg
    out = {}

    def serve(label):
        def thunk():
            out[label] = greedy_decode(model, params, batch, SERVE_GEN,
                                       return_logits=True)
        return thunk

    calls = [("greedy_decode 1", serve("1")), ("greedy_decode 2", serve("2"))]
    torch.cuda.reset_peak_memory_stats()
    path = run_path(tag, calls, expect={label: launches for label, _ in
                                        calls})
    serve_peak = torch.cuda.max_memory_allocated()
    (tok1, lg1), (tok2, lg2) = out.pop("1"), out.pop("2")
    check_served(tag, tok1, lg1[-1], cfg, SERVE_BATCH, SERVE_GEN)
    if not (torch.equal(tok1, tok2) and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(lg1, lg2))):
        raise AssertionError(f"[{tag}] two greedy_decode calls differ")
    total = path["ms"]["greedy_decode 2"] / 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch, max_len=prompt + SERVE_GEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    decode_ms = (total - t_prefill) * 1e3 / SERVE_GEN
    cache_gb = sum(t.numel() * t.element_size()
                   for t in pytree.leaves(caches)) / 1e9
    log(f"[{tag}] {note}, {SERVE_GEN} tokens: launches "
        f"{launches or 'none'} a call; tokens and all "
        f"{SERVE_GEN + 1} logits byte-identical across the two calls; "
        f"greedy_decode {path['ms']['greedy_decode 1'] / 1e3:.3f} s (first "
        f"call), {total:.3f} s (second) = prefill {t_prefill:.3f} s (timed "
        f"alone) + {decode_ms:.2f} ms per decode step; "
        f"{SERVE_BATCH * SERVE_GEN / total:.1f} generated tokens/s; cache "
        f"{cache_gb:.3f} GB ({cache_note}); peak {serve_peak / 1e9:.2f} GB "
        f"over the two calls; tokens[0] {tok1[0].tolist()}")
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    trace_device("decode step", lambda: model.decode_step(
        params, caches, tok, prompt), tag=tag, routing=routing)
    del caches, logits, lg1, lg2
    trace_device("prefill", lambda: model.prefill(
        params, batch, max_len=prompt + SERVE_GEN), tag=tag,
        routing=routing)
    return path


def phase_jamba() -> dict:
    """`[jamba]`: Jamba-1.5-Large-398B, the hybrid family, on the card at
    full width. Served at JB_SERVE_CUT (one period of 4 sub-layers:
    attention + dense FFN, Mamba + MoE, Mamba + dense FFN, Mamba + MoE)
    seeded in bf16 (`init_from_schema`, 45.96 GB): `greedy_decode`
    twice (batch 4, a JB_PROMPT-token prompt, 32 tokens; B9 on the
    attention sub-layer, 33 launches a call; the SSD on the Mamba
    sub-layers; the gather dispatch on the MoE FFNs), byte-identical
    tokens and logits; the prefill alone for the split; one decode step
    and one prefill traced (routing / gather kernels a group of their
    own). At JB_MERGE_CUT the served forward with B9 against its plain
    version (`served_vs_plain`), then `sparse_merge`."""
    import gc
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.models import mamba
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params
    from repro_torch.models.schema import init_from_schema
    engine.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(JAMBA)
    cfg = full.replace(**JB_SERVE_CUT)
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
    d_inner, heads, conv_dim = mamba.mamba_dims(cfg)
    experts = params["blocks"]["sub1"]["ffn"]["experts"]["w_gate"]
    log(f"[jamba] {cfg.name}: {n} bf16 parameters ({n * 2 / 1e9:.2f} GB) "
        f"at full width, one period of "
        f"{[f'{sl.mixer}+{sl.ffn}' for sl in model.layout]} (the config's "
        f"{full.n_layers} layers in periods of {full.hybrid_period} hold "
        f"{count_params(full)[0]}); attention {cfg.n_heads} query / "
        f"{cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}, RoPE "
        f"theta {cfg.rope_theta:g} (the reference's default); Mamba "
        f"d_inner {d_inner}, {heads} heads of {cfg.mamba.head_dim}, "
        f"d_state {cfg.mamba.d_state}, conv {conv_dim}; "
        f"{cfg.moe.num_experts} experts of {cfg.moe.d_ff_expert}, top-"
        f"{cfg.moe.top_k}, a stacked expert leaf {list(experts.shape)} "
        f"({experts.numel()} elements); seeded in "
        f"{time.perf_counter() - t0:.1f} s")
    del experts
    batch = serve_batch(cfg, SERVE_BATCH, JB_PROMPT)
    attn = model.n_periods * sum(sl.mixer == "attn" for sl in model.layout)
    path = serve_twice(
        "jamba", model, params, batch, JB_PROMPT,
        {"flash_attention": attn * (SERVE_GEN + 1)},
        f"{cfg.n_layers} sub-layers, batch {SERVE_BATCH}, prompt "
        f"{JB_PROMPT} (expert capacity {_q3_capacity(cfg, JB_PROMPT)} slots "
        f"a prefill group, {_q3_capacity(cfg, 1)} a decode step)",
        "KV, SSM states, conv caches", routing=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = full.replace(**JB_MERGE_CUT)
    served_vs_plain(cfg2, batch, "jamba-vs-plain")
    merged = sparse_merge(cfg2, batch, "jamba", JB_K,
                          keep=lambda path: "['experts']" not in path,
                          left="expert leaves")
    launches = {k: path["launches"][k] + merged["launches"][k]
                for k in path["launches"]}
    return {"launches": launches, "ms": {**path["ms"], **merged["ms"]}}


def sparse_merge(cfg, batch: dict, tag: str, k: int, keep, left: str,
                 prepare=None, tweak=None, bitwise=None) -> dict:
    """The merge of the paper's sparse contributions at `cfg`'s cut: a
    bf16 base (`prepare(model, base)` adjusts it) and k fine-tunes of
    the leaves whose path `keep` admits (`sparse_update`; `tweak(j,
    tune)` adjusts fine-tune j) land on two replicas in opposite orders
    (`contribute(..., leaves=...)`, B given A's eids); each resolves
    histogram TIES and weight_average on the kernel routes
    (`engine.merge(..., kernels=True, coverages=...)` over its canonical
    order, with the registered base's leaf digests; B1 and B3-B5 on the
    covered leaves' groups) to byte-identical trees whose other leaves
    (`left` names them) are the base's own tensors (inherited, not
    copied); each tree held leaf by leaf against replica A's exact
    `Replica.resolve` (`hold_leaves_vs_exact`), and the leaves whose path
    `bitwise` admits bit for bit; the TIES trees served
    byte-identical."""
    import gc
    from repro_torch import pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.core import engine
    from repro_torch.core.hashing import leaf_paths_of
    from repro_torch.core.resolve import canonical_order, seed_from_root
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    t0 = time.perf_counter()
    model = Model(cfg)
    base = init_from_schema(model.schema(), seed=SEED, device=DEVICE,
                            dtype=torch.bfloat16)
    if prepare is not None:
        prepare(model, base)
    tunes = [sparse_update(cfg, base, SEED + 1 + j, keep=keep)
             for j in range(k)]
    if tweak is not None:
        for j, tune in enumerate(tunes):
            tweak(j, tune)
    cov = leaf_paths_of(tunes[0])
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    rep_a = Replica(f"{tag}-a", device=DEVICE)
    t0 = time.perf_counter()
    eids = [rep_a.contribute(t, leaves=cov) for t in tunes]
    t_contrib = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_a = rep_a.register_base(base)
    t_base = time.perf_counter() - t0
    rep_b = Replica(f"{tag}-b", device=DEVICE)
    for t, eid in zip(tunes[::-1], eids[::-1]):
        rep_b.contribute(t, eid, leaves=cov)
    ref_b = rep_b.register_base(base)
    if rep_a.merkle_root() != rep_b.merkle_root() or ref_a != ref_b:
        raise AssertionError(f"[{tag}] the two replicas disagree on Layer 1")
    paths = [pytree.keystr(p) for p, _ in pytree.flatten_with_path(base)[0]]
    inherited = [i for i, p in enumerate(paths) if p not in set(cov)]
    n_base = sum(t.numel() for t in pytree.leaves(base))
    n_tune = sum(t.numel() for t in pytree.leaves(tunes[0]))
    where = (f"merged at {cfg.n_layers} "
             f"{'sub-layers' if cfg.family == 'hybrid' else 'layers'}")
    log(f"[{tag}] {where}: a base of {n_base} bf16 parameters and {k} "
        f"fine-tunes of {n_tune} ({len(cov)} of {len(paths)} leaves; the "
        f"{len(inherited)} {left} left to the base) made in "
        f"{t_make:.1f} s, contributed to A in {t_contrib:.1f} s, the base "
        f"registered in {t_base:.1f} s (its leaf digests kept for the "
        "planner) on each of two replicas")
    del tunes
    merged = {}

    def kernel_merge(label, rep, ref, name, cfgd):
        def thunk():
            order = canonical_order(rep.state)
            covs = rep.state.coverage()
            merged[label] = engine.merge(
                [rep.state.store[e] for e in order],
                spec=MergeSpec(name, cfgd), contrib_ids=order, base=base,
                seed=seed_from_root(rep.merkle_root()), kernels=True,
                use_cache=False, cache=rep.cache,
                coverages=[covs.get(e) for e in order],
                base_digests=rep.base_digests(ref))
        return thunk

    merges = [(f"{name} {rl}", kernel_merge(f"{name} {rl}", rep, ref, name,
                                            cfgd))
              for name, cfgd, _ in (STRATEGIES[2], STRATEGIES[0])
              for rl, rep, ref in (("A", rep_a, ref_a), ("B", rep_b, ref_b))]
    disps = [Dispatches(rep.cache.obs) for rep in (rep_a, rep_b)]
    before = [d.snapshot() for d in disps]
    merge_path = run_path(f"{tag} merge", merges)
    grown = [d.grown(b) for d, b in zip(disps, before)]
    if not all({"nary_accum", "ties_hist"} <= set(g) for g in grown):
        raise AssertionError(f"[{tag}] kernel_dispatch_total{{nary_accum, "
                             f"ties_hist}} did not grow on both replicas: "
                             f"{grown}")
    log(f"[{tag}] kernel_dispatch_total grew on replica A {grown[0]}, on "
        f"B {grown[1]}")
    base_leaves = pytree.leaves(base)
    for label, tree in merged.items():
        check_output(f"{tag} {label}", tree, base)
        leaves = pytree.leaves(tree)
        if not all(leaves[i] is base_leaves[i] for i in inherited):
            raise AssertionError(f"[{tag}] {label}: one of the {left} is "
                                 "not the base's own tensor")
    for name in ("ties", "weight_average"):
        differ = same_bytes(merged[f"{name} A"], merged[f"{name} B"])
        if differ:
            raise AssertionError(f"[{tag}] {name}: the replicas' trees "
                                 f"differ in {differ} leaves")
    for name, cfgd, _ in (STRATEGIES[2], STRATEGIES[0]):
        t0 = time.perf_counter()
        exact = rep_a.resolve(MergeSpec(name, cfgd, base_ref=ref_a),
                              use_cache=False)
        t_exact = time.perf_counter() - t0
        if not all(pytree.leaves(exact)[i] is base_leaves[i]
                   for i in inherited):
            raise AssertionError(f"[{tag}] exact {name}: one of the {left} "
                                 "is not the base's own tensor")
        hold_leaves_vs_exact(tag, f"{where}, {name} (exact resolve "
                             f"{t_exact:.1f} s)", exact,
                             merged[f"{name} A"], ties=name == "ties")
        if bitwise is not None:
            held = [(p, e, kt) for p, e, kt in zip(
                paths, pytree.leaves(exact),
                pytree.leaves(merged[f"{name} A"])) if bitwise(p)]
            differ = [p for p, e, kt in held
                      if not torch.equal(bits(e), bits(kt))]
            log(f"[{tag}] {where}, {name}: {len(held)} leaves held bit for "
                f"bit against the exact route "
                + ", ".join(f"{p} {kt.float().tolist()}"
                            for p, _, kt in held)
                + f": {'FAIL ' + str(differ) if differ or not held else 'ok'}")
            if differ or not held:
                raise AssertionError(f"[{tag}] {name}: the kernel route "
                                     f"differs from the exact route in "
                                     f"{differ}")
        del exact
    log(f"[{tag}] {where}: replicas A and B (opposite orders) resolve "
        "histogram TIES and weight_average on the kernel routes to "
        f"byte-identical trees; the {len(inherited)} {left} "
        f"({sum(base_leaves[i].numel() for i in inherited)} elements) are "
        "the base's tensors in every tree, the resolve copies none")
    del rep_a, rep_b, merges, merged["weight_average A"], \
        merged["weight_average B"]
    gc.collect()
    torch.cuda.empty_cache()
    out = {}

    def serve(rl):
        def thunk():
            out[rl] = greedy_decode(model, merged[f"ties {rl}"], batch,
                                    SERVE_GEN, return_logits=True)
        return thunk

    first, per_step = serve_calls(model)
    n_b9 = first + SERVE_GEN * per_step
    launches = {"flash_attention": n_b9} if n_b9 else {}
    calls = [(f"greedy_decode merged {rl}", serve(rl)) for rl in ("A", "B")]
    served = run_path(tag, calls, expect={label: launches for label, _ in
                                          calls})
    (ta, la), (tb, lb) = out.pop("A"), out.pop("B")
    check_served(f"{tag} merged", ta, la[-1], cfg, SERVE_BATCH, SERVE_GEN)
    if not (torch.equal(ta, tb) and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(la, lb))):
        raise AssertionError(f"[{tag}] the replicas' merged trees served "
                             "different tokens or logits")
    log(f"[{tag}] merged TIES trees serve byte-identical tokens and logits "
        f"(launches {launches or 'none'} each); tokens[0] {ta[0].tolist()}")
    del merged, out, la, lb, calls, base, base_leaves
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {n: merge_path["launches"][n]
                         + served["launches"][n]
                         for n in merge_path["launches"]},
            "ms": {**merge_path["ms"], **served["ms"]}}


def set_gates(model, params) -> None:
    """Every cross-attention sub-layer's gates (the VLM's) at VL_GATES:
    at their init, 0, tanh(0) = 0 multiplies the cross path's output
    away. A no-op for the other families."""
    for j, sl in enumerate(model.layout):
        if sl.mixer == "cross":
            for name, value in VL_GATES.items():
                params["blocks"][f"sub{j}"][name].fill_(value)


def phase_whisper() -> dict:
    """`[whisper]`: Whisper-tiny, the enc-dec family, on the card at full
    width and depth. Served: its 36,439,680 parameters seeded in bf16
    (`init_from_schema`), `greedy_decode` twice (batch WH_BATCH clips of
    1500 frames, a WH_PROMPT-token prompt, WH_GEN tokens; B9 on every
    attention call: the encoder's non-causal self-attention, each decoder
    layer's causal self-attention and its cross-attention over the 1500
    frames), byte-identical tokens and logits; the prefill alone for the
    split; one decode step and one prefill traced; the served forward with
    B9 against its plain version (`served_vs_plain`). Then
    `whisper_train_check` (the smoke model, card against CPU),
    `train_resume` at full depth in fp32 (WH_TRAIN_STEPS steps of
    WH_TRAIN_BATCH x WH_TRAIN_SEQ tokens with their frames), WH_K
    fine-tunes of the trained base (`whisper_finetunes`), and
    `merge_and_serve` over them."""
    import gc
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.serve import greedy_decode
    engine.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(WHISPER)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = init_from_schema(model.schema(), seed=SEED, device=DEVICE,
                              dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(params))
    if n != count_params(cfg)[0]:
        raise AssertionError(f"{n} parameters, count_params says "
                             f"{count_params(cfg)[0]}")
    log(f"[whisper] {cfg.name}: {n} bf16 parameters ({n * 2 / 1e6:.1f} MB; "
        f"{cfg.n_encoder_layers} encoder layers over {cfg.encoder_seq} "
        f"frames, {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.resolved_head_dim}, {cfg.mlp_variant} "
        f"MLP of {cfg.d_ff}, vocabulary {cfg.vocab_size}, tied, sinusoidal "
        f"positions, no RoPE) seeded in {time.perf_counter() - t0:.1f} s")
    batch = serve_batch(cfg, WH_BATCH, WH_PROMPT)
    first, per_step = serve_calls(model)
    per_call = first + WH_GEN * per_step
    out = {}

    def serve(label):
        def thunk():
            out[label] = greedy_decode(model, params, batch, WH_GEN,
                                       return_logits=True)
        return thunk

    calls = [("greedy_decode 1", serve("1")), ("greedy_decode 2", serve("2"))]
    torch.cuda.reset_peak_memory_stats()
    path = run_path("whisper", calls, expect={
        label: {"flash_attention": per_call} for label, _ in calls})
    serve_peak = torch.cuda.max_memory_allocated()
    (tok1, lg1), (tok2, lg2) = out.pop("1"), out.pop("2")
    check_served("whisper", tok1, lg1[-1], cfg, WH_BATCH, WH_GEN)
    if not (torch.equal(tok1, tok2) and all(
            torch.equal(bits(a), bits(b)) for a, b in zip(lg1, lg2))):
        raise AssertionError("[whisper] two greedy_decode calls differ")
    total = path["ms"]["greedy_decode 2"] / 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch,
                                   max_len=WH_PROMPT + WH_GEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    decode_ms = (total - t_prefill) * 1e3 / WH_GEN
    cache_gb = sum(t.numel() * t.element_size()
                   for t in pytree.leaves(caches)) / 1e9
    log(f"[whisper] batch {WH_BATCH} x {cfg.encoder_seq} frames, prompt "
        f"{WH_PROMPT}, {WH_GEN} tokens: {per_call} B9 launches a call "
        f"({first} in prefill, {per_step} a step); tokens and all "
        f"{WH_GEN + 1} logits byte-identical across the two calls; "
        f"greedy_decode {path['ms']['greedy_decode 1'] / 1e3:.3f} s (first "
        f"call), {total:.3f} s (second) = prefill {t_prefill:.4f} s (timed "
        f"alone) + {decode_ms:.2f} ms per decode step; "
        f"{WH_BATCH * WH_GEN / total:.1f} generated tokens/s; cache "
        f"{cache_gb:.3f} GB (self and cross); peak {serve_peak / 1e9:.2f} "
        f"GB over the two calls; tokens[0][:16] {tok1[0, :16].tolist()}")
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    trace_device("decode step", lambda: model.decode_step(
        params, caches, tok, WH_PROMPT), tag="whisper")
    del caches, logits, lg1, lg2
    trace_device("prefill", lambda: model.prefill(
        params, batch, max_len=WH_PROMPT + WH_GEN), tag="whisper")
    del params, calls
    gc.collect()
    torch.cuda.empty_cache()
    served_vs_plain(cfg, batch, "whisper-vs-plain")
    whisper_train_check()
    tcfg = cfg.replace(grad_accum=WH_TRAIN_ACCUM)
    train = train_resume(
        "whisper-train", tcfg, WH_TRAIN_STEPS, WH_TRAIN_BATCH, WH_TRAIN_SEQ,
        WH_TRAIN_ACCUM, f"full depth ({WH_TRAIN_SEQ} tokens a row, its "
        f"context, and {cfg.encoder_seq} frames)", keep_params=True)
    tunes, tuned = whisper_finetunes(tcfg, train["params"])
    base = pytree.tree_map(lambda t: t.to(torch.bfloat16), train["params"])
    del train["params"]
    merged = merge_and_serve(cfg, WH_K, "whisper", batch,
                             {"flash_attention": per_call},
                             models=(base, tunes), gen=WH_GEN)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: path["launches"][k] + merged["launches"][k]
                + train["launches"][k] + tuned[k] for k in path["launches"]}
    return {"launches": launches, "ms": {**path["ms"], **merged["ms"]}}


def whisper_train_check() -> None:
    """Whisper-tiny's smoke model, fp32 compute, remat: `train_check`
    over 2 rows of 64 tokens with their frames (the encoder's gradient
    through the cross-attention included) at WH_CHECK_LIMITS (the CPU
    tests' limits against JAX)."""
    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    cfg = smoke_config(WHISPER).replace(compute_dtype="float32",
                                        remat="full")
    params = init_from_schema(Model(cfg).schema(), seed=SEED, device="cpu")
    train_check("whisper-train", f"smoke model ({cfg.n_encoder_layers} "
                f"encoder and {cfg.n_layers} decoder layers over "
                f"{cfg.encoder_seq} frames)", cfg, params,
                make_batch(cfg, ShapeSpec("check", 64, 2, "train")),
                WH_CHECK_LIMITS)


def train_check(tag: str, label: str, cfg, params, batch: dict,
                limits: dict) -> None:
    """`Model.loss` of `cfg` (a smoke config) and its gradients on the
    card, under the train step's deterministic mode, against the same on
    the CPU (the kernels' plain versions there), from the CPU `params`
    on `batch`: the loss and its cross-entropy within limits["loss"]
    relative, an MoE config's aux term within limits["aux"], each
    leaf's gradient within limits["grad"] of its largest magnitude."""
    from repro_torch import pytree
    from repro_torch.models.model import Model
    from repro_torch.train.step import _deterministic
    model = Model(cfg)
    got = []
    for device in (DEVICE, "cpu"):
        p = pytree.tree_map(
            lambda t: t.to(device, copy=True).requires_grad_(), params)
        with _deterministic(torch.device(device)):
            loss, mets = model.loss(p, batch)
            loss.backward()
        got.append(([float(loss.detach()), float(mets["ce"].detach()),
                     float(mets["aux"].detach())],
                    [t.grad.cpu() for t in pytree.leaves(p)]))
    (lc, gc), (lh, gh) = got
    rel = [abs(a - b) / abs(b) for a, b in zip(lc[:2], lh[:2])]
    aux = abs(lc[2] - lh[2])
    grad = max(float((a - b).abs().max()) / max(float(b.abs().max()),
                                                1e-30)
               for a, b in zip(gc, gh))
    ok = max(rel) <= limits["loss"] and grad <= limits["grad"] and \
        (not cfg.moe or aux <= limits["aux"])
    moe = (f", aux {lc[2]:.6f} / {lh[2]:.6f} ({aux:.2e})" if cfg.moe
           else "")
    log(f"[{tag}] {label}, card vs CPU: loss {lc[0]:.6f} / {lh[0]:.6f} "
        f"(relative {rel[0]:.2e}), ce {rel[1]:.2e}{moe}, gradients "
        f"{grad:.2e} of a leaf's largest magnitude at worst over "
        f"{len(gc)} leaves (limits {limits}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} train check: card vs CPU outside "
                             "the limits")


def whisper_finetunes(cfg, base) -> tuple:
    """WH_K fine-tunes of the trained fp32 `base`: each a copy of it with
    zero moments, trained WH_TUNE_STEPS steps on task id j + 1 (its own
    token stream, `make_batch`'s frames) at batch WH_TRAIN_BATCH x
    WH_TRAIN_SEQ. Returns (the bf16 trees, the steps' launch counts)."""
    from repro_torch import kernels, pytree
    from repro_torch.configs import ShapeSpec
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.model import Model
    from repro_torch.train.step import init_train_state, make_train_step
    model = Model(cfg)
    shape = ShapeSpec("tune", WH_TRAIN_SEQ, WH_TRAIN_BATCH, "train")
    step_fn = make_train_step(model, total_steps=WH_TUNE_STEPS,
                              grad_accum=WH_TRAIN_ACCUM)
    tunes, losses = [], []
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    for j in range(WH_K):
        state = init_train_state(model, params=clone_tree(base),
                                 device=DEVICE)
        for i in range(WH_TUNE_STEPS):
            _, mets = step_fn(state, {
                k: torch.as_tensor(v, device=DEVICE) for k, v in
                make_batch(cfg, shape, step=i, task_id=j + 1).items()})
            losses.append(float(mets["loss"]))
        tunes.append(pytree.tree_map(lambda t: t.to(torch.bfloat16),
                                     state["params"]))
        del state
    counts = kernels.launch_counts()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"whisper fine-tune losses {losses}")
    log(f"[whisper-train] {WH_K} fine-tunes of the trained base, "
        f"{WH_TUNE_STEPS} steps each on task ids 1 .. {WH_K}: losses "
        f"{[round(x, 4) for x in losses]}, "
        f"{time.perf_counter() - t0:.1f} s; launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    return tunes, counts


def phase_vlm() -> dict:
    """`[vlm]`: Llama-3.2-Vision-90B, the VLM family, on the card at full
    width. Served at VL_SERVE_PERIODS periods seeded in bf16
    (`init_from_schema`, the gates at VL_GATES): `greedy_decode` twice
    (batch 4, a SERVE_PROMPT-token prompt, 1601 patches a row from
    `make_batch`, 32 tokens; B9 on every self-attention sub-layer and,
    non-causal over the patches, every cross-attention one: 30 launches a
    forward), byte-identical tokens and logits; the prefill alone for the
    split; one decode step and one prefill traced. At VL_MERGE_PERIODS
    the served forward with B9 against its plain version
    (`served_vs_plain`), then `sparse_merge` of VL_K fine-tunes of the
    cross sub-layer alone, its gate leaves held bit for bit against the
    exact route."""
    import gc
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params
    from repro_torch.models.schema import init_from_schema
    engine.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(VLM)
    period = full.cross_attn_interval
    cfg = full.replace(n_layers=VL_SERVE_PERIODS * period)
    model = Model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_from_schema(model.schema(), seed=SEED, device=DEVICE,
                              dtype=torch.bfloat16)
    set_gates(model, params)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in pytree.leaves(params))
    if n != count_params(cfg)[0]:
        raise AssertionError(f"{n} parameters, count_params says "
                             f"{count_params(cfg)[0]}")
    log(f"[vlm] {cfg.name}: {n} bf16 parameters ({n * 2 / 1e9:.2f} GB) at "
        f"full width, {model.n_periods} of the config's "
        f"{full.n_layers // period} periods of "
        f"{[f'{sl.mixer}+{sl.ffn}' for sl in model.layout]} (the config's "
        f"{full.n_layers} layers hold {count_params(full)[0]}, "
        f"{count_params(full)[0] * 2 / 1e9:.1f} GB); {cfg.n_heads} query / "
        f"{cfg.n_kv_heads} KV heads of {cfg.resolved_head_dim}, RoPE theta "
        f"{cfg.rope_theta:g} on the self-attention; {cfg.num_patches} "
        f"patches; gates {VL_GATES}; seeded in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = serve_batch(cfg, SERVE_BATCH, SERVE_PROMPT)
    first, per_step = serve_calls(model)
    path = serve_twice(
        "vlm", model, params, batch, SERVE_PROMPT,
        {"flash_attention": first + SERVE_GEN * per_step},
        f"{cfg.n_layers} layers, batch {SERVE_BATCH}, prompt "
        f"{SERVE_PROMPT}, {cfg.num_patches} patches a row",
        "self KV and the patches' cross KV")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg1 = full.replace(n_layers=VL_MERGE_PERIODS * period)
    served_vs_plain(cfg1, {k: v[:VL_PLAIN_ROWS] for k, v in batch.items()},
                    "vlm-vs-plain")
    cross = f"['blocks']['sub{period - 1}']"

    def tweak(j, tune):
        sub = tune["blocks"][f"sub{period - 1}"]
        sub["gate_attn"].add_(0.1 * (j + 1))
        sub["gate_ffn"].sub_(0.05 * (j + 1))

    merged = sparse_merge(cfg1, batch, "vlm", VL_K,
                          keep=lambda path: path.startswith(cross),
                          left="leaves outside the cross sub-layer",
                          prepare=set_gates, tweak=tweak,
                          bitwise=lambda path: "['gate_" in path)
    launches = {k: path["launches"][k] + merged["launches"][k]
                for k in path["launches"]}
    return {"launches": launches, "ms": {**path["ms"], **merged["ms"]}}


def phase_deepseek() -> dict:
    """`[deepseek]`: DeepSeek-V2-236B, MLA over fine-grained experts, on
    the card at full width. Served at DS_SERVE_LAYERS seeded in bf16
    (`init_from_schema`, 58.38 GB): `greedy_decode` twice (batch 4, a
    DS_PROMPT-token prompt, 32 tokens; the latent attention's plain
    products in prefill (non-absorbed, 512-query chunks) and decode
    (absorbed, over the latent cache), no kernel launched; the gather
    dispatch on the MoE layers), byte-identical tokens and logits; the
    prefill alone for the split; one decode step and one prefill traced
    (routing / gather kernels a group of their own); one layer's prefill
    attention alone against its bound and SDPA (`deepseek_attention`).
    At DS_MERGE_LAYERS `sparse_merge` of DS_K fine-tunes that leave the
    routed experts to the base."""
    import gc
    from repro_torch import pytree
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.models.model import Model
    from repro_torch.models.params import count_params
    from repro_torch.models.schema import init_from_schema
    engine.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(DEEPSEEK)
    cfg = full.replace(n_layers=DS_SERVE_LAYERS)
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
    m, moe = cfg.mla, cfg.moe
    log(f"[deepseek] {cfg.name}: {n} bf16 parameters ({n * 2 / 1e9:.2f} "
        f"GB) at full width, the dense layer 0 and {model.n_periods} of "
        f"the config's {full.n_layers - 1} MLA + MoE layers (the config's "
        f"{full.n_layers} layers hold {count_params(full)[0]}, "
        f"{count_params(full)[1]} active); d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, kv_lora {m.kv_lora_rank}, q_lora "
        f"{m.q_lora_rank}, nope / rope / v {m.d_head_nope} / "
        f"{m.d_head_rope} / {m.d_head_v}; {moe.num_experts} experts of "
        f"{moe.d_ff_expert}, top-{moe.top_k}, {moe.num_shared_experts} "
        f"shared; layer 0's FFN {cfg.d_ff}; vocabulary {cfg.vocab_size}; "
        f"seeded in {time.perf_counter() - t0:.1f} s")
    batch = serve_batch(cfg, SERVE_BATCH, DS_PROMPT)
    path = serve_twice(
        "deepseek", model, params, batch, DS_PROMPT, {},
        f"{cfg.n_layers} layers, batch {SERVE_BATCH}, prompt {DS_PROMPT} "
        f"({DS_PROMPT // cfg.attn_q_chunk} query chunks of "
        f"{cfg.attn_q_chunk}; expert capacity {_q3_capacity(cfg, DS_PROMPT)} "
        f"slots a prefill group, {_q3_capacity(cfg, 1)} a decode step)",
        "the MLA latents and rope keys", routing=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    deepseek_attention(cfg)
    cfg2 = full.replace(n_layers=DS_MERGE_LAYERS)
    merged = sparse_merge(cfg2, batch, "deepseek", DS_K,
                          keep=lambda path: "['experts']" not in path,
                          left="expert leaves")
    launches = {k: path["launches"][k] + merged["launches"][k]
                for k in path["launches"]}
    return {"launches": launches, "ms": {**path["ms"], **merged["ms"]}}


def deepseek_attention(cfg) -> None:
    """One layer's MLA prefill attention alone (`mla.chunked_attention`,
    the non-absorbed path's products and softmax) at the served shape,
    batch SERVE_BATCH x DS_PROMPT, 128 heads, seeded bf16 inputs (q_nope
    and k_nope 128, q_rope 64 and one rope key for all heads, v 128),
    by CUDA events (median of 5), beside its bound (the visible pairs'
    (192 + 128) x 2 flops at the bf16 peak, or each input and the
    output's bytes once, whichever is larger) and
    `scaled_dot_product_attention` with q and k of 192 and v of 128 under
    each fused backend that accepts it. Each one's output is held
    against the port's: no element beyond DS_SDPA_TOL of the largest
    output (the port rounds the normalized probabilities to bf16, the
    fused kernels their unnormalized exponentials); the share of
    elements beyond one bf16 ulp of their own magnitude is logged."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.models import mla
    m = cfg.mla
    b, s, h = SERVE_BATCH, DS_PROMPT, cfg.n_heads
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)

    def draw(*shape):
        return torch.randn(shape, generator=g, device=DEVICE,
                           dtype=torch.bfloat16)

    qn, qr = draw(b, s, h, m.d_head_nope), draw(b, s, h, m.d_head_rope)
    kn, kr = draw(b, s, h, m.d_head_nope), draw(b, s, m.d_head_rope)
    v = draw(b, s, h, m.d_head_v)
    scale = (m.d_head_nope + m.d_head_rope) ** -0.5

    def port():
        with torch.inference_mode():
            return mla.chunked_attention(qn, qr, kn, kr, v, scale=scale,
                                         q_chunk=cfg.attn_q_chunk)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ms = cuda_ms(port, 5)
    peak = torch.cuda.max_memory_allocated() - held
    out = port()
    pairs = s * (s + 1) // 2
    flops = 2.0 * pairs * b * h * (m.d_head_nope + m.d_head_rope + m.d_head_v)
    nbytes = sum(t.numel() * t.element_size() for t in (qn, qr, kn, kr, v,
                                                        out))
    t_ops = flops / BF16_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound, by = (t_ops, "operations") if t_ops >= t_bytes else \
        (t_bytes, "bytes")
    log(f"[deepseek] MLA prefill attention alone, one layer [{b}, {s}, {h} "
        f"heads], q/k {m.d_head_nope}+{m.d_head_rope}, v {m.d_head_v}, "
        f"chunks of {cfg.attn_q_chunk}: {ms:.3f} ms (median of 5, CUDA "
        f"events; fp32 logits from fp32 copies of the bf16 operands); "
        f"bound {bound:.3f} ms ({by}: {pairs} visible pairs a row-head x "
        f"{b * h} row-heads x {2 * (m.d_head_nope + m.d_head_rope + m.d_head_v)}"
        f" = {flops:.4e} flops at the bf16 peak; bytes {t_bytes:.3f} ms), "
        f"{bound / ms:.1%} of it; {peak / 1e9:.2f} GB of transients")
    q = torch.cat([qn, qr], -1).transpose(1, 2)
    k = torch.cat([kn, kr[:, :, None].expand(b, s, h, m.d_head_rope)],
                  -1).transpose(1, 2)
    vt = v.transpose(1, 2)
    o32 = out.float()
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        def sdpa():
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(
                    q, k, vt, is_causal=True, scale=scale)
        try:
            ref = sdpa().transpose(1, 2).float()
        except RuntimeError as e:
            log(f"[deepseek] scaled_dot_product_attention, {backend.name}: "
                f"does not accept q/k of {m.d_head_nope + m.d_head_rope} "
                f"with v of {m.d_head_v} ({str(e).splitlines()[0][:120]})")
            continue
        lib = cuda_ms(sdpa, 5)
        d = (ref - o32).abs()
        beyond = int((d > 1e-6 + 2.0 ** -8 * ref.abs()).sum())
        top = float(ref.abs().max())
        ok = float(d.max()) <= DS_SDPA_TOL * top
        log(f"[deepseek] scaled_dot_product_attention, {backend.name}: "
            f"{lib:.3f} ms (median of 5), {lib / ms:.3f} of the port's "
            f"time; its output against the port's: largest difference "
            f"{float(d.max()):.3e} (outputs up to {top:.3f}; rule <= "
            f"{DS_SDPA_TOL} x that: {'ok' if ok else 'FAIL'}), {beyond} of "
            f"{d.numel()} beyond one bf16 ulp of their own magnitude")
        if not ok:
            raise AssertionError(f"[deepseek] SDPA ({backend.name}) and the "
                                 "port's MLA attention disagree")
        del ref, d
    del q, k, vt, qn, qr, kn, kr, v, out, o32
    torch.cuda.empty_cache()


def phase_qwen3_moe_train() -> dict:
    """[qwen3-moe-train]: Qwen3-MoE-30B-A3B trained on the card. First
    `q3_train_check` (the smoke model, card against CPU); then
    `train_resume` at full width and Q3_TRAIN_LAYERS of its 48 layers
    (routed experts, the gather dispatch, the routers' aux term in the
    loss; the train step's deterministic mode gives the gather's
    backward, an accumulating index-put, torch's sorted path, so the
    resume is bitwise), the traced step's routing / gather kernels a
    group of their own; then `q3_btm`."""
    from repro_torch.configs import get_config
    q3_train_check()
    cfg = get_config(QWEN3).replace(n_layers=Q3_TRAIN_LAYERS,
                                    grad_accum=Q3_TRAIN_ACCUM)
    out = train_resume(
        "qwen3-moe-train", cfg, Q3_TRAIN_STEPS, Q3_TRAIN_BATCH,
        Q3_TRAIN_SEQ, Q3_TRAIN_ACCUM, f"{Q3_TRAIN_LAYERS} of 48 layers "
        f"(16 bytes a parameter; {cfg.moe.num_experts} experts, top-"
        f"{cfg.moe.top_k}, capacity factor {cfg.moe.capacity_factor})",
        routing=True)
    log_routing("qwen3-moe-train", out["traced"])
    btm = q3_btm(cfg)
    return {"launches": {k: out["launches"][k] + btm["launches"][k]
                         for k in out["launches"]}}


def log_routing(tag: str, t: dict) -> None:
    """The traced train step's routing / gather group (ROUTING_WORDS):
    its share of the busy time, the deterministic index-put backward's
    and the gathers' ('index' in the name) share, the costliest four."""
    if not t:
        return
    busy = sum(t["groups"].values())
    routing = sorted(((k, v) for k, v in t["by_kernel"].items()
                      if any(w in k.lower() for w in ROUTING_WORDS)),
                     key=lambda kv: -kv[1])
    index = sum(v for k, v in routing if "index" in k.lower())
    log(f"[{tag}] the traced step's routing / gather kernels "
        f"{t['groups']['routing']:.2f} ms, "
        f"{t['groups']['routing'] / busy:.3f} of the busy {busy:.2f} ms "
        f"(the deterministic index-put backward's and the gathers' "
        f"kernels, names with 'index' {index:.2f} ms, {index / busy:.3f}); "
        "costliest: " + ", ".join(f"{k} {v:.2f} ms" for k, v in routing[:4]))


def q3_train_check() -> None:
    """Qwen3-MoE's smoke model with drops (capacity factor 0.5), the
    router at 50x its init, fp32 compute, remat: `train_check` over 2
    rows of 64 tokens at Q3_CHECK_LIMITS (the CPU tests' limits against
    JAX)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    cfg = smoke_config(QWEN3).replace(compute_dtype="float32", remat="full")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    params = init_from_schema(Model(cfg).schema(), seed=SEED, device="cpu")
    params["blocks"]["sub0"]["ffn"]["router"].mul_(50.0)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (2, 64))
    train_check("qwen3-moe-train", f"smoke model ({cfg.n_layers} layers, "
                "capacity factor 0.5)", cfg, params, {"tokens": toks},
                Q3_CHECK_LIMITS)


def q3_btm(cfg) -> dict:
    """One Branch-Train-Merge round of Qwen3-MoE at full width and
    Q3_BTM_LAYERS layer: Q3_BTM_BRANCHES branches from one seeded base
    (each its own parameters and moments), a train step each at batch
    Q3_BTM_BATCH x Q3_BTM_SEQ, contributions gossiped, every branch
    resolving weight_average: the branches byte-identical, gossip
    converged, and the merged model bitwise what the port's `Replica`
    resolves over the same contributions under their eids."""
    import gc
    from repro_torch import kernels, pytree
    from repro_torch.api import MergeSpec, Replica
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.btm import BranchTrainMerge
    gc.collect()
    torch.cuda.empty_cache()
    bc = cfg.replace(n_layers=Q3_BTM_LAYERS)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    btm = BranchTrainMerge(
        bc, n_branches=Q3_BTM_BRANCHES, strategy="weight_average",
        merge_every=1, batch_size=Q3_BTM_BATCH, seq_len=Q3_BTM_SEQ,
        device=DEVICE, params=init_from_schema(Model(bc).schema(),
                                               seed=SEED, device=DEVICE))
    t_setup = time.perf_counter() - t0
    contributed = []
    for node in btm.net.nodes:
        def spy(c, *a, _fn=node.contribute, **k):
            eid = _fn(c, *a, **k)
            contributed.append((c, eid))
            return eid
        node.contribute = spy
    t0 = time.perf_counter()
    rec = btm.train_round()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    first = pytree.leaves(btm.branches[0].state["params"])
    same = all(all(torch.equal(bits(x), bits(y)) for x, y in
                   zip(first, pytree.leaves(b.state["params"])))
               for b in btm.branches[1:])
    conv = btm.net.converged()
    rep = Replica("qwen3-btm-check", device=DEVICE)
    for c, eid in contributed:
        rep.contribute(c, eid)
    merged = rep.resolve(MergeSpec("weight_average"))
    equal = all(torch.equal(bits(x), bits(y.to(x.dtype)))
                for x, y in zip(first, pytree.leaves(merged)))
    n = sum(t.numel() for t in first)
    log(f"[qwen3-moe-train] btm: {Q3_BTM_BRANCHES} branches at "
        f"{Q3_BTM_LAYERS} layer ({n:,} fp32 parameters a branch, set up "
        f"in {t_setup:.1f} s), one round of a step each (batch "
        f"{Q3_BTM_BATCH} x {Q3_BTM_SEQ}) and a merge in {dt:.1f} s, peak "
        f"{peak / 1e9:.2f} GB; losses "
        + ", ".join(f"{i}: {v:.4f}" for i, v in sorted(rec["losses"].items()))
        + f"; branches byte-identical: {same}; gossip converged: {conv}; "
        f"the merge bitwise a Replica's weight_average over the "
        f"{len(contributed)} contributions: {equal}")
    if not (same and conv and equal and len(contributed) == Q3_BTM_BRANCHES):
        raise AssertionError("qwen3-moe btm round: branches, gossip or the "
                             "Replica's resolve disagree")
    counts = kernels.launch_counts()
    del btm, rep, merged, first, contributed
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts}


def phase_vlm_flash_train(rows: dict, g) -> None:
    """B9 and its gradient at [vlm-train]'s microbatch (VT_BATCH /
    VT_ACCUM rows of VT_SEQ tokens), bf16, 64 query heads over 8 KV heads
    of 128: the self-attention, causal, q, k, v [1, 4096, ...], and the
    cross-attention, non-causal over the 1601 patches (1601 % 64 = 1),
    the forward held against its plain version by `flash_case`'s rule
    and the gradient by FLASH_BWD_*, each timed beside
    `scaled_dot_product_attention`'s forward or backward
    (`enable_gqa`)."""
    from repro_torch.configs import get_config
    cfg = get_config(VLM)
    dev = torch.device(DEVICE)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mb = VT_BATCH // VT_ACCUM
    floor = FLASH_BF16_FLOOR["gemma2"]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    fwd, bwd = {}, {}
    for label, sk, causal in (("self", VT_SEQ, True),
                              ("cross", cfg.num_patches, False)):
        q, dout = randn(mb, VT_SEQ, h, d), randn(mb, VT_SEQ, h, d)
        k, v = randn(mb, sk, hk, d), randn(mb, sk, hk, d)
        fwd[f"vlm train {label} bf16"] = flash_case(q, k, v, 0, floor=floor,
                                                    causal=causal)
        bwd[f"vlm train {label} bf16"] = flash_bwd_case(q, k, v, dout,
                                                        causal=causal)
        del q, k, v, dout
    torch.cuda.empty_cache()
    rows["flash_attention"].update(fwd)
    rows["flash_attention_backward"].update(bwd)


def phase_vlm_train() -> dict:
    """[vlm-train]: Llama-3.2-Vision-90B trained on the card. First the
    smoke model (gates at VL_GATES, fp32 compute, remat) card against
    CPU (`train_check` at TRAIN_LOSS_RTOL / TRAIN_GRAD_TOL); then
    `train_resume` at full width and VT_PERIODS of its 20 periods under
    `parambf16` (bf16 parameters, gradients and moments; learning rate
    BF16_TRAIN_LR), the gates at VL_GATES, without the resume: B9 and
    its gradient on every self-attention sub-layer (causal over the
    tokens) and on the cross-attention one (non-causal over the
    patches); the gates' values after the steps."""
    from repro_torch.configs import ShapeSpec, get_config, smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch.dryrun import apply_variant
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    smoke = smoke_config(VLM).replace(compute_dtype="float32", remat="full")
    params = init_from_schema(Model(smoke).schema(), seed=SEED,
                              device="cpu")
    set_gates(Model(smoke), params)
    train_check("vlm-train", f"smoke model ({smoke.n_layers} layers in "
                f"periods of {smoke.cross_attn_interval}, "
                f"{smoke.num_patches} patches, gates {VL_GATES})", smoke,
                params, make_batch(smoke, ShapeSpec("check", 64, 2,
                                                    "train")),
                {"loss": TRAIN_LOSS_RTOL, "grad": TRAIN_GRAD_TOL})
    full = get_config(VLM)
    period = full.cross_attn_interval
    cfg = apply_variant(full, "parambf16").replace(
        n_layers=VT_PERIODS * period, grad_accum=VT_ACCUM,
        learning_rate=BF16_TRAIN_LR, warmup_steps=1)
    out = train_resume(
        "vlm-train", cfg, VT_STEPS, VT_BATCH, VT_SEQ, VT_ACCUM,
        f"{VT_PERIODS} of 20 periods ({period - 1} self-attention + "
        f"dense sub-layers and a gated cross-attention + dense one over "
        f"{cfg.num_patches} patches a row; 8 bytes a parameter under "
        f"parambf16; learning rate {BF16_TRAIN_LR} from step 1)",
        keep_params=True, resume=False)
    cross = out.pop("params")["blocks"][f"sub{period - 1}"]
    gates = {k: cross[k].float().tolist() for k in VL_GATES}
    log(f"[vlm-train] the gates after {VT_STEPS} steps: {gates} (set to "
        f"{VL_GATES}, bf16)")
    for k, v in VL_GATES.items():
        start = torch.tensor(v).to(torch.bfloat16)
        if bool((cross[k] == start.to(cross[k].device)).any()):
            raise AssertionError(f"[vlm-train] {k} did not move")
    del cross
    torch.cuda.empty_cache()
    return {"launches": out["launches"]}


def phase_deepseek_train() -> dict:
    """[deepseek-train]: DeepSeek-V2-236B trained on the card. First the
    smoke model (`q_lora_rank` 24, the router at 50x its init and the
    latent-attention projections at 10x so that neither routing nor
    attention is flat; fp32 compute, remat) card against CPU
    (`train_check` at TRAIN_LOSS_RTOL / TRAIN_GRAD_TOL, aux within
    Q3_CHECK_LIMITS["aux"]); then `train_resume` at full width and
    DS_TRAIN_LAYERS of its 60 layers with DS_TRAIN_VARIANT's dtypes,
    without the resume, the traced step's routing / gather group
    (`log_routing`) and MLA's share of it (`mla_train_share`)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.dryrun import apply_variant
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    smoke = smoke_config(DEEPSEEK).replace(compute_dtype="float32",
                                           remat="full")
    smoke = smoke.replace(mla=dataclasses.replace(smoke.mla,
                                                  q_lora_rank=24))
    params = init_from_schema(Model(smoke).schema(), seed=SEED,
                              device="cpu")
    params["blocks"]["sub0"]["ffn"]["router"].mul_(50.0)
    for attn in (params["first"]["attn"], params["blocks"]["sub0"]["attn"]):
        for w in ("w_q", "w_dq", "w_dkv", "w_uk"):
            attn[w].mul_(10.0)
    toks = np.random.default_rng(SEED).integers(0, smoke.vocab_size,
                                                (2, 64))
    train_check("deepseek-train", f"smoke model ({smoke.n_layers} layers, "
                f"q_lora {smoke.mla.q_lora_rank}, 2 query chunks of "
                f"{smoke.attn_q_chunk})", smoke, params, {"tokens": toks},
                {"loss": TRAIN_LOSS_RTOL, "aux": Q3_CHECK_LIMITS["aux"],
                 "grad": TRAIN_GRAD_TOL})
    full = get_config(DEEPSEEK)
    cfg = apply_variant(full, DS_TRAIN_VARIANT).replace(
        n_layers=DS_TRAIN_LAYERS, grad_accum=DS_TRAIN_ACCUM)
    if cfg.param_dtype != "float32":
        cfg = cfg.replace(learning_rate=BF16_TRAIN_LR, warmup_steps=1)
    size = {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    out = train_resume(
        "deepseek-train", cfg, DS_TRAIN_STEPS, DS_TRAIN_BATCH, DS_TRAIN_SEQ,
        DS_TRAIN_ACCUM, f"{DS_TRAIN_LAYERS} of 60 layers (the dense layer "
        f"0 and {DS_TRAIN_LAYERS - 1} MLA + MoE; {2 * size + 4} bytes a "
        f"parameter; {DS_TRAIN_SEQ // cfg.attn_q_chunk} query chunks of "
        f"{cfg.attn_q_chunk})", routing=True, resume=False)
    log_routing("deepseek-train", out["traced"])
    mla_train_share(cfg, out["traced"])
    return {"launches": out["launches"]}


def mla_train_share(cfg, traced: dict) -> None:
    """One MLA mixer (`mla.mla_attention`: the latent and query
    projections, the chunked attention, the output projection) at
    [deepseek-train]'s microbatch, its parameters seeded in the config's
    parameter dtype and cast inside as the step does, timed alone by
    CUDA events under the train step's deterministic mode: the forward
    without a graph and the forward + backward. A microbatch runs the
    dense layer 0's mixer forward + backward (outside remat) and each
    stack layer's forward, then forward + backward (remat); those times
    over the traced step's microbatches, beside its busy time."""
    from repro_torch import pytree
    from repro_torch.dtypes import BY_NAME
    from repro_torch.models import mla
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.step import _deterministic
    if not traced:
        return
    mb = DS_TRAIN_BATCH // DS_TRAIN_ACCUM
    p = init_from_schema(mla.mla_def(cfg), seed=SEED, device=DEVICE,
                         dtype=BY_NAME[cfg.param_dtype])
    g = torch.Generator(device=DEVICE)
    g.manual_seed(SEED)
    x, dout = (torch.randn((mb, DS_TRAIN_SEQ, cfg.d_model), generator=g,
                           device=DEVICE, dtype=torch.bfloat16)
               for _ in range(2))
    leaves = [x.requires_grad_()] + [t.requires_grad_()
                                     for t in pytree.leaves(p)]

    def fwd():
        with torch.no_grad():
            return mla.mla_attention(p, x, cfg, q_chunk=cfg.attn_q_chunk)

    def fwd_bwd():
        out = mla.mla_attention(p, x, cfg, q_chunk=cfg.attn_q_chunk)
        return torch.autograd.grad(out, leaves, dout)

    with _deterministic(torch.device(DEVICE)):
        f_ms, fb_ms = cuda_ms(fwd, 3), cuda_ms(fwd_bwd, 3)
    stack = DS_TRAIN_LAYERS - 1
    total = DS_TRAIN_ACCUM * (DS_TRAIN_LAYERS * fb_ms + stack * f_ms)
    busy = sum(traced["groups"].values())
    log(f"[deepseek-train] one MLA mixer alone at [{mb}, {DS_TRAIN_SEQ}] "
        f"({cfg.param_dtype} parameters, bf16 compute; CUDA events, median "
        f"of 3): forward {f_ms:.2f} ms, forward + backward {fb_ms:.2f} ms; "
        f"x ({DS_TRAIN_LAYERS} forward + backward + {stack} remat "
        f"forward) x {DS_TRAIN_ACCUM} microbatches = {total:.1f} ms, "
        f"{total / busy:.3f} of the traced step's busy {busy:.1f} ms "
        "(timed apart, not read from the trace)")
    del p, x, dout, leaves
    torch.cuda.empty_cache()


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
    mamba2 = timed(phase_mamba2)
    jamba = timed(phase_jamba)
    whisper = timed(phase_whisper)
    vlm = timed(phase_vlm)
    deepseek = timed(phase_deepseek)
    timed(phase_whole, cfg)
    timed(phase_audits)
    timed(phase_gossip_tables)
    timed(phase_sync_fleet)
    train = timed(phase_train, cfg)
    pending = timed(phase_train_depth2, cfg)
    btm = timed(phase_btm, cfg)
    timed(phase_merge_cli, pending)
    g2train = timed(phase_gemma2_train)
    q3train = timed(phase_qwen3_moe_train)
    vltrain = timed(phase_vlm_train)
    dstrain = timed(phase_deepseek_train)
    for name, row in rows.items():
        row["launches"] = sum(p["launches"][name] for p in
                              (main, serve, gemma2, qwen3, mamba2, jamba,
                               whisper, vlm, deepseek, train, btm, g2train,
                               q3train, vltrain, dstrain))
    log(f"[done] {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
