"""Single-device memtable suffix index — the port of
``repro.api.memtable``.

Appended codes are indexed in a small store built over ``tail +
appended``, where ``tail`` is the overlap window: the last
``max_query_len - 1`` symbols of the logical text before this memtable.
With ``n_base`` the logical length when the memtable started, it owns
exactly the occurrences with ``n_base < g + plen <= n_base + size``.
The store is rebuilt lazily after each append, on the table's device,
over text padded to a power-of-two length (symbol 0).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api.runs import padded_segment_store, positions_in_bounds
from repro_torch.core.tablet import TabletStore


class Memtable:
    """Recent appends to a ``SuffixTable``, queryable."""

    def __init__(self, base_codes: np.ndarray, *, is_dna: bool,
                 max_query_len: int, device: torch.device,
                 n_base: Optional[int] = None):
        """``base_codes`` is the logical text preceding this memtable —
        or, when ``n_base`` is given, just its tail (at least the overlap
        window) with ``n_base`` the true logical length."""
        base_codes = np.asarray(base_codes)
        self.n_base = (int(base_codes.shape[0]) if n_base is None
                       else int(n_base))
        if base_codes.shape[0] > self.n_base:
            raise ValueError(f"tail of {base_codes.shape[0]} symbols for a "
                             f"logical prefix of only {self.n_base}")
        self.is_dna = bool(is_dna)
        self.max_query_len = int(max_query_len)
        self.device = device
        self.overlap = int(min(max(self.max_query_len - 1, 0), self.n_base))
        if base_codes.shape[0] < self.overlap:
            raise ValueError(f"need the last {self.overlap} symbols of the "
                             f"logical prefix, got {base_codes.shape[0]}")
        self._tail = np.ascontiguousarray(
            base_codes[base_codes.shape[0] - self.overlap:])
        self._dtype = base_codes.dtype if base_codes.size else (
            np.uint8 if is_dna else np.int32)
        self._chunks: list[np.ndarray] = []
        self.size = 0
        self._store: Optional[TabletStore] = None
        self._sa_host: Optional[np.ndarray] = None

    @staticmethod
    def validate_codes(codes, *, is_dna: bool) -> np.ndarray:
        """Shape/range-check an append batch and return it as an array."""
        codes = np.asarray(codes)
        if codes.ndim != 1:
            raise ValueError(f"append expects a 1-D code array, "
                             f"got shape {codes.shape}")
        if codes.size == 0:
            return codes
        if int(codes.min()) < 0:
            raise ValueError("appended codes must be non-negative "
                             f"(got min {int(codes.min())})")
        if is_dna and int(codes.max()) > 3:
            raise ValueError("DNA table: appended codes must be in {0..3} "
                             "(use codec.encode_dna for strings)")
        return codes

    def append(self, codes, *, _prevalidated: bool = False) -> int:
        """Add codes; returns the new memtable size."""
        if not _prevalidated:
            codes = self.validate_codes(codes, is_dna=self.is_dna)
        if codes.size == 0:
            return self.size
        self._chunks.append(codes.astype(self._dtype))
        self.size += int(codes.size)
        self._store = None
        self._sa_host = None
        return self.size

    @property
    def appended(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0,), self._dtype)
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks)]
        return self._chunks[0]

    def _ensure_store(self) -> TabletStore:
        if self._store is None:
            text = np.concatenate([self._tail, self.appended])
            self._store = padded_segment_store(
                text, is_dna=self.is_dna, max_query_len=self.max_query_len,
                device=self.device)
            self._sa_host = self._store.sa.cpu().numpy()
        return self._store

    def match_positions(self, patt, plen) -> list[np.ndarray]:
        """Global start positions, ascending, of the occurrences only the
        memtable owns."""
        B = int(plen.shape[0])
        if self.size == 0 or B == 0:
            return [np.zeros((0,), np.int64)] * B
        store = self._ensure_store()
        return positions_in_bounds(store, self._sa_host, patt, plen,
                                   offset=self.n_base - self.overlap,
                                   lo=self.n_base, hi=self.n_base + self.size)
