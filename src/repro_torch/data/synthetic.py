"""Deterministic synthetic data pipeline (`repro.data.synthetic`, copied:
numpy only, so its batches equal the reference's bit for bit).

Each `SyntheticTask` is a learnable affine-Markov token stream: a branch
fine-tuned on task i measurably improves on task i, so CRDT-merged models
have a real multi-task signal to show in the examples. Batches are fully
deterministic in (task_id, step) — restart-safe (the data cursor is just
the step counter stored in the checkpoint) and host-shardable (each host
draws only its slice).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec


class SyntheticTask:
    def __init__(self, vocab_size: int, seq_len: int, task_id: int = 0,
                 noise: float = 0.05, vocab_cap: int = 4096):
        self.vocab = min(vocab_size, vocab_cap)
        self.full_vocab = vocab_size
        self.seq = seq_len
        self.task_id = task_id
        rng = np.random.default_rng(1234 + task_id)
        self.a = int(rng.integers(3, 17)) * 2 + 1      # odd multiplier
        self.b = int(rng.integers(0, self.vocab))
        self.noise = noise

    def batch(self, step: int, batch_size: int,
              host_id: int = 0, num_hosts: int = 1) -> np.ndarray:
        assert batch_size % num_hosts == 0
        per = batch_size // num_hosts
        rng = np.random.default_rng(
            (self.task_id * 1_000_003 + step) * 65537 + host_id)
        x = np.empty((per, self.seq), np.int32)
        x[:, 0] = rng.integers(0, self.vocab, per)
        noise_mask = rng.random((per, self.seq)) < self.noise
        noise_tok = rng.integers(0, self.vocab, (per, self.seq))
        for t in range(1, self.seq):
            nxt = (self.a * x[:, t - 1] + self.b) % self.vocab
            x[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return x


def batch_shapes(cfg: ModelConfig, shape: ShapeSpec,
                 dtype_tokens="int32") -> Dict[str, tuple]:
    """Abstract input shapes for a workload cell (dry-run input_specs)."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": ((b, s), dtype_tokens)}
    if cfg.family == "encdec":
        out["frames"] = ((b, cfg.encoder_seq, cfg.d_model),
                         cfg.compute_dtype)
    if cfg.family == "vlm":
        out["patches"] = ((b, cfg.num_patches, cfg.d_model),
                          cfg.compute_dtype)
    return out


def make_batch(cfg: ModelConfig, shape: ShapeSpec, step: int = 0,
               task_id: int = 0) -> Dict[str, np.ndarray]:
    """Concrete (host-side) batch for integration tests / examples."""
    task = SyntheticTask(cfg.vocab_size, shape.seq_len, task_id)
    out = {"tokens": task.batch(step, shape.global_batch)}
    rng = np.random.default_rng(step + 999)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (shape.global_batch, cfg.encoder_seq, cfg.d_model)
        ).astype(np.float32) * 0.02
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (shape.global_batch, cfg.num_patches, cfg.d_model)
        ).astype(np.float32) * 0.02
    return out
