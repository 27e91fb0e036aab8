"""Corpus dedup & contamination search — the port of ``repro.core.dedup``,
the LM-pipeline face of the suffix-array table.

Exact-duplicate span detection (suffix-array dedup a la Lee et al.) and
eval-set contamination queries over the sorted suffix store.  Every
function accepts either a bare :class:`TabletStore` or a
:class:`repro_torch.api.SuffixTable`.  LCP-based span detection runs over
the table's BASE index (``compact()`` first to cover appends);
``contamination_check`` on a table goes through the merged read path, so
appended-but-uncompacted text is searched too.  Work stays on the
store's device; DNA windows are searched as packed words (on the card
the ``bounded_search`` kernel, and ``tier_scan`` for a table's delta
tiers), with the answers of the reference's code-by-code compare.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core import query as Q
from repro_torch.core.suffix_array import adjacent_lcp
from repro_torch.core.tablet import TabletStore


def _base_store(store) -> TabletStore:
    """Unwrap a SuffixTable to its base TabletStore; pass stores through."""
    if isinstance(store, TabletStore):
        return store
    return store.store


def duplicate_span_mask(store, min_len: int) -> torch.Tensor:
    """Boolean mask over text positions (on the store's device): True
    where a substring of length >= min_len starting there occurs at least
    twice in the corpus.

    Adjacent rows of the suffix array with LCP >= min_len are exactly the
    pairs of duplicated spans; both members get marked."""
    store = _base_store(store)
    sa = store.sa
    dup = adjacent_lcp(store.text_codes, sa, min_len) >= min_len
    n = store.n_pad
    mask_sorted = torch.zeros(n, dtype=torch.bool, device=sa.device)
    mask_sorted[:-1] = dup
    mask_sorted[1:] |= dup
    # scatter back to text positions; drop pad rows
    mask_text = torch.zeros(n, dtype=torch.bool, device=sa.device)
    mask_text[sa.to(torch.int64)] = mask_sorted
    return mask_text[:store.n_real]


def duplicate_fraction(store, min_len: int) -> torch.Tensor:
    """Fraction of corpus positions inside >=min_len duplicated spans
    (0-d float32)."""
    m = duplicate_span_mask(store, min_len)
    return torch.mean(m.to(torch.float32))


def doc_dup_scores(store, doc_ids: np.ndarray,
                   min_len: int) -> np.ndarray:
    """Per-document duplicated-position fraction.  ``doc_ids`` maps each
    text position to its document (int, length n_real)."""
    mask = duplicate_span_mask(store, min_len).cpu().numpy()
    doc_ids = np.asarray(doc_ids)
    num_docs = int(doc_ids.max()) + 1 if doc_ids.size else 0
    tot = np.bincount(doc_ids, minlength=num_docs).astype(np.float64)
    dup = np.bincount(doc_ids, weights=mask.astype(np.float64),
                      minlength=num_docs)
    return dup / np.maximum(tot, 1)


def filter_duplicate_docs(store, doc_ids: np.ndarray,
                          min_len: int, threshold: float = 0.5) -> np.ndarray:
    """Returns the boolean keep-mask over documents (True = keep)."""
    return doc_dup_scores(store, doc_ids, min_len) < threshold


def contamination_check(store, eval_token_windows) -> np.ndarray:
    """True per eval window if it appears verbatim in the training corpus.
    ``eval_token_windows``: (B, L) int token n-grams.  Given a
    SuffixTable, the merged read path also searches un-compacted appends.
    Windows of DNA codes against a DNA store go as packed words."""
    w = np.asarray(eval_token_windows).astype(np.int32)
    B, L = w.shape
    is_dna = _base_store(store).is_dna
    if is_dna and w.size and w.min() >= 0 and w.max() < 4:
        patt = codec.pack_2bit_batch(w)[:, :codec.packed_length(L)]
    else:
        patt = w
    dev = _base_store(store).device
    patt = codec.as_tensor(patt, dev)
    plen = torch.full((B,), L, dtype=torch.int32, device=dev)
    if isinstance(store, TabletStore):
        res = Q.query(store, patt, plen)
    else:
        res = store.scan_encoded(patt, plen)
    return res.found.cpu().numpy()
