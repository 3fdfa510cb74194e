"""Deterministic synthetic token pipeline, host-sharded
(``repro.data.pipeline``, copied: numpy only, the same numbers from the
same ``(seed, step, shard)``).

Every batch is a pure function of (seed, step, shard) — the property that
makes straggler mitigation and elastic restart trivial: ANY host can
regenerate ANY shard's batch for ANY step without coordination (the same
idea as deterministic data sharding in production loaders).  Sequences are
Zipf-ish token draws with a repeated-motif structure so the LM loss actually
decreases during smoke training.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    frames: int = 0          # whisper stub: encoder frames per example
    frame_dim: int = 0
    patches: int = 0         # pixtral stub: patch embeddings per example
    patch_dim: int = 0


def _rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def make_batch(cfg: DataConfig, step: int, shard: int, n_shards: int
               ) -> Dict[str, np.ndarray]:
    """One host shard's batch: tokens/labels (+ stub modality inputs)."""
    assert cfg.global_batch % n_shards == 0
    b = cfg.global_batch // n_shards
    rng = _rng(cfg, step, shard)
    v = max(cfg.vocab_size - 2, 2)
    # zipf-ish marginals with planted motifs (learnable structure)
    base = (rng.zipf(1.3, size=(b, cfg.seq_len)) % v).astype(np.int32)
    motif = (rng.zipf(1.3, size=(b, cfg.motif_len)) % v).astype(np.int32)
    reps = cfg.seq_len // (2 * cfg.motif_len)
    for t in range(reps):
        pos = 2 * t * cfg.motif_len
        base[:, pos:pos + cfg.motif_len] = motif
    tokens = base
    labels = np.concatenate(
        [tokens[:, 1:], np.full((b, 1), -100, np.int32)], axis=1)

    out = {"tokens": tokens, "labels": labels}
    if cfg.frames:
        out["frames"] = rng.standard_normal(
            (b, cfg.frames, cfg.frame_dim)).astype(np.float32)
    if cfg.patches:
        out["patches"] = rng.standard_normal(
            (b, cfg.patches, cfg.patch_dim)).astype(np.float32)
        # patch positions carry no LM loss and no token ids
        pad_tok = np.full((b, cfg.patches), -1, np.int32)
        pad_lab = np.full((b, cfg.patches), -100, np.int32)
        out["tokens"] = np.concatenate([pad_tok, tokens], axis=1)
        out["labels"] = np.concatenate([pad_lab, labels], axis=1)
    return out


def batch_iterator(cfg: DataConfig, shard: int, n_shards: int,
                   start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, step, shard, n_shards)
        step += 1
