"""Data pipeline: deterministic synthetic streams + SA-dedup hook — the
port of ``repro.data.pipeline`` (numpy, as the reference's).

The token stream is a pure function of (seed, step) — iterator state IS the
step counter, which makes data-restart after preemption exact (the
checkpoint stores the step; no iterator pickling), and both packages
draw the same batches.  The dedup hook filters documents through the
suffix-array duplicate-span index before batching — the paper's
technique sitting in the training input path.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.core import dedup as _dedup
from repro_torch.core.tablet import build_tablet_store
from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    dedup_min_len: int = 0          # >0 enables SA dedup of the doc pool
    dedup_threshold: float = 0.5


def synthetic_batch(cfg: ModelConfig, data: DataConfig, step: int) -> dict:
    """Batch for ``step`` — pure function of (seed, step), numpy arrays."""
    rng = np.random.default_rng((data.seed, step))
    B, S = data.global_batch, data.seq_len
    batch = {}
    if cfg.frontend == "audio_stub":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)
                                     ).astype(np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S)
                                       ).astype(np.int32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)
                                       ).astype(np.int32)
        if cfg.frontend == "vlm_stub":
            batch["patches"] = rng.normal(
                size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def dna_corpus(n: int, seed: int = 0, dup_fraction: float = 0.0
               ) -> np.ndarray:
    """Synthetic DNA with optional planted duplicates (dedup benchmarks)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.uint8)
    if dup_fraction > 0:
        span = int(n * dup_fraction / 2)
        base[n - span:] = base[:span]            # plant an exact duplicate
    return base


def make_batch_iter(cfg: ModelConfig, data: DataConfig,
                    start_step: int = 0) -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, synthetic_batch(cfg, data, step)
        step += 1


def dedup_token_pool(tokens: np.ndarray, doc_ids: np.ndarray,
                     min_len: int, threshold: float = 0.5,
                     device: DeviceLike = None) -> np.ndarray:
    """Filter a document pool through the suffix-array index built on
    ``device`` (``cuda`` when None): returns the keep mask over docs.
    This is the paper's scan engine applied to LM data."""
    store = build_tablet_store(np.asarray(tokens).astype(np.int32),
                               is_dna=False, max_query_len=min_len,
                               device=device)
    return _dedup.filter_duplicate_docs(store, doc_ids, min_len, threshold)
