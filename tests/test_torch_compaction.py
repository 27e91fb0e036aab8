"""Major compaction in the port: ``repro_torch.api.compaction.
merge_delta_sa`` against ``repro.api.compaction.merge_delta_sa`` bit for
bit, and ``SuffixTable.compact`` / ``max_runs`` on live and frozen
tables against the reference's table and a brute-force scan
(``device="cpu"``: the plain insertion search; the CUDA merge is held
against it in ``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import SuffixTable as JTable  # noqa: E402
from repro.api.compaction import merge_delta_sa as j_merge  # noqa: E402
from repro.core.suffix_array import build_suffix_array as j_build  # noqa: E402
from repro_torch.api import SuffixTable  # noqa: E402
from repro_torch.api.compaction import interleave, merge_delta_sa  # noqa: E402
from repro_torch.core import codec as C, query as Q  # noqa: E402

CPU = "cpu"


def _merge_case(case):
    """(combined, n0, is_dna, L) for one merge case."""
    rng = np.random.default_rng(11)
    if case == "random_dna":
        return (np.concatenate([C.random_dna(1500, seed=1),
                                C.random_dna(230, seed=2)]), 1500, True, 32)
    if case == "repetitive":       # every window of the A-run ties at L
        return (np.concatenate([np.zeros(350, np.uint8),
                                C.encode_dna("ACGTACGTAAAC")]), 300, True,
                16)
    if case == "token":
        return (rng.integers(0, 500, 1620).astype(np.int32), 1500, False, 32)
    if case == "base_within_one_window":
        return C.random_dna(50, seed=3), 20, True, 32
    if case == "small_delta":      # a memtable-sized delta of 1 symbol
        return C.random_dna(900, seed=4), 899, True, 64
    if case == "no_delta":
        return C.random_dna(700, seed=5), 700, True, 32
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random_dna", "repetitive", "token",
                                  "base_within_one_window", "small_delta",
                                  "no_delta"])
def test_merge_delta_sa_matches_reference(case):
    combined, n0, is_dna, L = _merge_case(case)
    base = combined[:n0]
    base_sa = np.asarray(j_build(base.astype(np.int32)))
    want = np.asarray(j_merge(combined, n0, base_sa, is_dna=is_dna,
                              max_query_len=L))
    got = merge_delta_sa(combined, n0, base_sa, is_dna=is_dna,
                         max_query_len=L, device=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case in ("random_dna", "token", "base_within_one_window",
                "small_delta", "no_delta"):   # no full-L ties: a rebuild
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_build(combined.astype(np.int32))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interleave_is_np_insert(seed):
    """Equal and unsorted insertion points, as numpy orders them."""
    rng = np.random.default_rng(seed)
    clean = rng.permutation(40).astype(np.int32)
    ins = rng.integers(0, 41, size=25)
    if seed == 1:
        ins = np.sort(ins)
    vals = (100 + rng.permutation(25)).astype(np.int64)
    got = interleave(torch.from_numpy(clean), torch.from_numpy(ins),
                     torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(),
                                  np.insert(clean, ins, vals.astype(np.int32)))


def _brute(text, pattern):
    p = C.encode_dna(pattern)
    k = len(p)
    return [i for i in range(len(text) - k + 1)
            if (text[i:i + k] == p).all()]


def _assert_tables_agree(jt, pt, text, pats, top_k=6):
    a, b = jt.scan(pats, top_k=top_k), pt.scan(pats, top_k=top_k)
    for f in ("count", "first_pos", "positions"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    for i, p in enumerate(pats):
        want = _brute(text, p)
        assert int(b.count[i]) == len(want), p
        got = [int(x) for x in b.positions[i] if x >= 0]
        assert got == want[:top_k], p


@pytest.mark.parametrize("frozen", [False, True])
def test_compact_matches_reference(frozen):
    base = C.random_dna(1400, seed=20)
    kw = dict(is_dna=True, memtable_limit=200, max_query_len=24)
    jt = JTable.from_codes(base, **kw)
    pt = SuffixTable.from_codes(base, device=CPU, **kw)
    if frozen:
        jt.freeze(sample_rate=8)
        pt.freeze(sample_rate=8)
    text = base
    for i in range(3):
        chunk = C.random_dna(150, seed=21 + i)
        jt.append(chunk)
        pt.append(chunk)
        text = np.concatenate([text, chunk])
    assert len(pt.runs) == 1 and pt.memtable.size == 150
    pats = Q.random_patterns(30, 1, 8, seed=22) + [
        C.decode_dna(text[b - 3:b + 4]) for b in (1400, 1700, 1845)]
    _assert_tables_agree(jt, pt, text, pats)
    assert pt.compact() == jt.compact() == 1
    assert (pt.is_frozen, jt.is_frozen) == (frozen, frozen)
    assert not pt.runs and pt.memtable.size == 0 and pt.n_base == len(text)
    if frozen:
        assert pt.fm.sample_rate == 8
        assert pt.fm.n == jt.fm.n == len(text)
        np.testing.assert_array_equal(np.asarray(pt.fm.bwt),
                                      np.asarray(jt.fm.bwt))
    else:
        np.testing.assert_array_equal(
            pt.store.sa.numpy(), np.asarray(jt.store.sa))
    _assert_tables_agree(jt, pt, text, pats)
    assert pt.compact() == 1                  # nothing left to fold


def test_compact_memtable_only_merges():
    base = C.random_dna(1000, seed=30)
    app = C.random_dna(90, seed=31)
    jt = JTable.from_codes(base, is_dna=True, max_query_len=32)
    pt = SuffixTable.from_codes(base, device=CPU, max_query_len=32)
    jt.append(app)
    pt.append(app)
    assert pt.compact() == jt.compact() == 1
    np.testing.assert_array_equal(pt.store.sa.numpy(),
                                  np.asarray(jt.store.sa))


def test_max_runs_folds_runs_through_compact():
    base = C.random_dna(900, seed=40)
    kw = dict(is_dna=True, memtable_limit=120, max_runs=2, max_query_len=16)
    jt = JTable.from_codes(base, **kw)
    pt = SuffixTable.from_codes(base, device=CPU, **kw)
    text = base
    versions = []
    for i in range(6):
        chunk = C.random_dna(70, seed=41 + i)
        jt.append(chunk)
        pt.append(chunk)
        text = np.concatenate([text, chunk])
        assert (len(pt.runs), pt.memtable.size, pt.version) == \
            (len(jt.runs), jt.memtable.size, jt.version)
        versions.append(pt.version)
    assert versions[-1] >= 1 and len(pt.runs) < 2
    _assert_tables_agree(jt, pt, text,
                         Q.random_patterns(25, 1, 6, seed=47) + ["ACGTA"])
