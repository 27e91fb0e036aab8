"""The plain reference against brute force on small texts, and its
control against the reference."""
import numpy as np
import pytest
import torch

from suffixbench.reference.suffix_array import (SuffixReference,
                                                build_suffix_array)


def brute(text: np.ndarray, pat: np.ndarray):
    """(count, smallest position) of ``pat`` in ``text`` by a compare at
    every position."""
    L = len(pat)
    hits = [i for i in range(len(text) - L + 1)
            if np.array_equal(text[i:i + L], pat)]
    return len(hits), (hits[0] if hits else -1)


def texts():
    rng = np.random.default_rng(5)
    yield rng.integers(0, 4, 700).astype(np.uint8)
    yield np.zeros(300, np.uint8)                       # one base repeated
    yield np.tile(np.array([0, 1, 2], np.uint8), 90)    # a period of 3
    yield rng.integers(0, 2, 500).astype(np.uint8)      # two bases only


def patterns(text: np.ndarray, rng, n: int = 120, hi: int = 12):
    """Random patterns, and substrings of the text (those at its end
    too), lengths 1..hi."""
    out = []
    for k in range(n):
        L = int(rng.integers(1, hi + 1))
        if k % 2:
            s = int(rng.integers(0, len(text) - L + 1))
            if k % 6 == 1:
                s = len(text) - L
            out.append(text[s:s + L])
        else:
            out.append(rng.integers(0, 4, L).astype(np.uint8))
    codes = np.zeros((n, hi), np.uint8)
    for i, p in enumerate(out):
        codes[i, :len(p)] = p
    return out, codes, np.array([len(p) for p in out])


@pytest.mark.parametrize("k", range(4))
def test_suffix_array_is_the_sorted_suffixes(k):
    text = list(texts())[k]
    sa = build_suffix_array(torch.as_tensor(text)).numpy()
    want = sorted(range(len(text)), key=lambda i: text[i:].tobytes())
    assert sa.tolist() == want


@pytest.mark.parametrize("k", range(4))
def test_answers_equal_brute_force(k):
    text = list(texts())[k]
    rng = np.random.default_rng(k)
    pats, codes, plen = patterns(text, rng)
    ref = SuffixReference(torch.as_tensor(text), max_len=12)
    count, first = ref.answer(torch.as_tensor(codes), torch.as_tensor(plen))
    want = [brute(text, p) for p in pats]
    assert count.tolist() == [c for c, _ in want]
    assert first.tolist() == [f for _, f in want]


def test_range_min_over_many_blocks(monkeypatch):
    from suffixbench.reference import suffix_array as S
    monkeypatch.setattr(S, "RMQ_BLOCK", 8)
    rng = np.random.default_rng(1)
    text = rng.integers(0, 4, 1000).astype(np.uint8)
    ref = SuffixReference(torch.as_tensor(text), max_len=8)
    sa = ref.sa.numpy()
    lo = rng.integers(0, 1000, 400)
    hi = np.minimum(1000, lo + rng.integers(1, 700, 400))
    got = ref.range_min(torch.as_tensor(lo), torch.as_tensor(hi)).numpy()
    assert got.tolist() == [int(sa[a:b].min()) for a, b in zip(lo, hi)]


def test_the_control_breaks_first_pos():
    """The control reports the first matching row's position in suffix
    order: its counts hold, its first positions do not."""
    rng = np.random.default_rng(2)
    text = rng.integers(0, 4, 2000).astype(np.uint8)
    _pats, codes, plen = patterns(text, rng, n=200, hi=4)
    ref = SuffixReference(torch.as_tensor(text), max_len=4)
    c, f = ref.answer(torch.as_tensor(codes), torch.as_tensor(plen))
    cc, cf = ref.answer_rank_first(torch.as_tensor(codes),
                                   torch.as_tensor(plen))
    assert (cc == c).all()
    assert (cf != f).sum() > 50
