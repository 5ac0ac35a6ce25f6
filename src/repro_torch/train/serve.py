"""Serving-step factories: prefill and single-token decode
(`repro.train.serve`), and the host-driven greedy loop on top of them."""
from __future__ import annotations

import torch

from repro_torch.models.model import Model


def make_prefill(model: Model):
    """Prefill without `max_len`, as the reference's: the KV cache holds
    the prompt alone, so a decode step on it raises `ValueError`. A
    caller that decodes calls `model.prefill(params, batch, max_len=...)`
    with room for the tokens to come, as `greedy_decode` does."""
    def prefill(params, batch):
        return model.prefill(params, batch)
    return prefill


def make_decode_step(model: Model):
    def decode_step(params, caches, token, pos):
        return model.decode_step(params, caches, token, pos)
    return decode_step


def greedy_decode(model: Model, params, batch, steps: int, *,
                  return_logits: bool = False):
    """Prefill the prompt batch, then `steps` greedy decode steps. Returns
    the generated tokens [B, steps] int32 and, with `return_logits`, the
    logits [B, V] of the prefill and of every decode step too (steps + 1
    of them). The argmax takes the first index among equal maxima, as
    `jnp.argmax` does."""
    pos = batch["tokens"].shape[1]
    decode = make_decode_step(model)
    logits, caches = model.prefill(params, batch, max_len=pos + steps)
    out, every = [], [logits]
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(steps):
        out.append(tok)
        logits, caches = decode(params, caches, tok, pos + i)
        every.append(logits)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    tokens = torch.cat(out, dim=1)
    return (tokens, every) if return_logits else tokens
