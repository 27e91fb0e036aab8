"""Build telemetry — the ``BuildStats`` schema of
``repro.core.build_pipeline``, the port's own copy.

Only the in-memory builder (``core.suffix_array.build_suffix_array``) is
ported; the staged out-of-core pipeline of the reference is not.  Its
record keeps the reference's keys, computed as the reference computes
them for its own in-memory build (:func:`in_memory_build_stats`), so
``SuffixTable.stats()["build"]`` and a persisted table's ``build`` record
read the same in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# 3 int32 sort operands, double-buffered through the device sort (the
# reference's figure behind chunk_rows and peak_device_bytes).
BYTES_PER_ROW = 24


@dataclasses.dataclass
class BuildStats:
    """Construction telemetry — ``SuffixTable.stats()["build"]``."""

    mode: str = "staged"            # "staged" | "in_memory"
    n_bases: int = 0
    rounds: int = 0                 # sort/merge rounds
    n_chunks: int = 0               # device chunks per round
    chunk_rows: int = 0
    peak_device_bytes: int = 0      # the sort's working set, as modelled
    spill_bytes: int = 0
    elapsed_s: float = 0.0
    bases_per_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BuildStats":
        """Keys the schema lacks are dropped, missing ones default (a
        record written before a key existed still loads)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def in_memory_build_stats(n: int, elapsed_s: float) -> BuildStats:
    """The reference's record of a one-sort build over ``n`` bases:
    ``1 + ceil(log2 n)`` rounds, one chunk of ``n`` rows, ``24 n`` modelled
    device bytes (not measured), nothing spilled."""
    rounds = 1 + max(1, int(np.ceil(np.log2(max(2, n)))))
    return BuildStats(
        mode="in_memory", n_bases=n, rounds=rounds, n_chunks=1,
        chunk_rows=n, peak_device_bytes=n * BYTES_PER_ROW, spill_bytes=0,
        elapsed_s=elapsed_s,
        bases_per_s=(n / elapsed_s) if elapsed_s > 0 else 0.0)
