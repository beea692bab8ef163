"""Deterministic synthetic batches (port of ``repro/train/data.py``).

Every batch is a pure function of (seed, step): a ``torch.Generator`` on
the batch's device seeded from (seed, salt, step), with the reference's
salts, shapes, value ranges and label rate, so a restart replays the exact
stream with no pipeline state to checkpoint. The numbers are not
``jax.random``'s. ``graph_minibatch_seeds`` waits for the GNN (ROADMAP
A3).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import resolve_device

__all__ = ["lm_batch", "criteo_batch", "bst_batch", "mind_batch"]


def _gen(seed: int, step: int, salt: int, dev) -> torch.Generator:
    """One generator per (seed, salt, step); distinct triples get
    distinct 63-bit seeds (each field in its own bits)."""
    key = ((int(seed) & 0xFFFFFFFF) << 31) ^ ((int(salt) & 0xFF) << 23) \
        ^ (int(step) & 0x7FFFFF)
    return torch.Generator(device=dev).manual_seed(key & ((1 << 63) - 1))


def _labels(gen, batch: int, dev) -> torch.Tensor:
    return (torch.rand(batch, generator=gen, device=dev) < 0.3).to(
        torch.int32)


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device=None) -> Dict[str, torch.Tensor]:
    """``tokens`` and ``labels`` (B, seq) int32: one draw of seq + 1 ids
    below ``vocab`` a row, the labels shifted by one."""
    dev = resolve_device(device)
    g = _gen(seed, step, 1, dev)
    tokens = torch.randint(0, vocab, (batch, seq + 1), generator=g,
                           device=dev, dtype=torch.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def criteo_batch(seed: int, step: int, batch: int, n_dense: int,
                 vocab_sizes, device=None) -> Dict[str, torch.Tensor]:
    """``dense (B, n_dense)`` normal f32, ``sparse (B, F)`` field-local
    ids below each table's size, ``label (B,)`` int32 at rate 0.3."""
    dev = resolve_device(device)
    g = _gen(seed, step, 2, dev)
    dense = torch.randn((batch, n_dense), generator=g, device=dev)
    maxes = torch.as_tensor(list(vocab_sizes), dtype=torch.int64, device=dev)
    sparse = (torch.randint(0, 1 << 30, (batch, len(vocab_sizes)),
                            generator=g, device=dev) % maxes[None, :])
    return {"dense": dense, "sparse": sparse.to(torch.int32),
            "label": _labels(g, batch, dev)}


def bst_batch(seed: int, step: int, batch: int, seq_len: int, n_items: int,
              device=None) -> Dict[str, torch.Tensor]:
    """``seq (B, S)`` and ``target (B,)`` item ids, ``label (B,)``."""
    dev = resolve_device(device)
    g = _gen(seed, step, 3, dev)
    seq = torch.randint(0, n_items, (batch, seq_len), generator=g,
                        device=dev, dtype=torch.int32)
    target = torch.randint(0, n_items, (batch,), generator=g, device=dev,
                           dtype=torch.int32)
    return {"seq": seq, "target": target, "label": _labels(g, batch, dev)}


def mind_batch(seed: int, step: int, batch: int, seq_len: int, n_items: int,
               device=None) -> Dict[str, torch.Tensor]:
    """``seq (B, S)`` and ``target (B,)`` item ids."""
    dev = resolve_device(device)
    g = _gen(seed, step, 4, dev)
    return {"seq": torch.randint(0, n_items, (batch, seq_len), generator=g,
                                 device=dev, dtype=torch.int32),
            "target": torch.randint(0, n_items, (batch,), generator=g,
                                    device=dev, dtype=torch.int32)}
