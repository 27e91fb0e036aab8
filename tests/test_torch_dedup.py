"""Corpus dedup, contamination and the LM data pipeline: the port
(``repro_torch.core.dedup``, ``core.suffix_array.adjacent_lcp``,
``repro_torch.data``, ``device="cpu"``) against ``repro`` on the same
numpy inputs.  Masks, LCPs, keep-masks, contamination flags and batches
must be equal; ``duplicate_fraction`` (a float32 mean, summed in another
order) within rtol 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import SuffixTable as JTable  # noqa: E402
from repro.configs import get_config as jget, list_archs  # noqa: E402
from repro.core import dedup as JD  # noqa: E402
from repro.core import suffix_array as JSA  # noqa: E402
from repro.core import tablet as JT  # noqa: E402
from repro.data import pipeline as JP  # noqa: E402
from repro_torch.api import SuffixTable  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import codec as C, dedup as D  # noqa: E402
from repro_torch.core import suffix_array as SA  # noqa: E402
from repro_torch.core import tablet as TT  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402

CPU = "cpu"


def _stores(codes, is_dna, min_rows=0, max_query_len=64):
    """The same corpus as a reference store and a port store (CPU)."""
    js = JT.build_tablet_store(codes, is_dna=is_dna, min_rows=min_rows,
                               max_query_len=max_query_len)
    ps = TT.build_tablet_store(codes, is_dna=is_dna, min_rows=min_rows,
                               max_query_len=max_query_len, device=CPU)
    assert np.array_equal(np.asarray(js.sa), ps.sa.numpy())
    return js, ps


def _dup_corpus(kind, seed=2):
    """A corpus with planted copies: DNA (the reference test's) or tokens
    (a 3-doc pool, doc 2 copying doc 0's head)."""
    if kind == "dna":
        base = C.random_dna(512, seed=seed)
        return np.concatenate([base, C.random_dna(300, seed=9),
                               base[:200]]), True
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5000, 300).astype(np.int32)
    return np.concatenate([a, rng.integers(0, 5000, 250).astype(np.int32),
                           a[:180]]), False


@pytest.mark.parametrize("kind", ["dna", "tokens"])
@pytest.mark.parametrize("cap", [1, 2, 7, 16, 33, 64])
def test_adjacent_lcp_matches_reference(kind, cap):
    codes, is_dna = _dup_corpus(kind)
    js, ps = _stores(codes, is_dna, min_rows=len(codes) + 37)
    want = np.asarray(JSA.adjacent_lcp(js.text_codes, js.sa, cap))
    one = SA.adjacent_lcp(ps.text_codes, ps.sa, cap)
    assert one.dtype == torch.int32
    np.testing.assert_array_equal(one.numpy(), want)
    for rows in (1, 5, 25, 256):     # byte caps of that many rows a chunk
        np.testing.assert_array_equal(
            SA.adjacent_lcp(ps.text_codes, ps.sa, cap,
                            max_bytes=SA.LCP_CELL_BYTES * cap * rows
                            ).numpy(), want)


@pytest.mark.parametrize("kind", ["dna", "tokens"])
@pytest.mark.parametrize("min_rows", [0, 1200])   # 1200: pad rows
@pytest.mark.parametrize("min_len", [8, 32])
def test_duplicate_span_mask_and_fraction_match_reference(kind, min_rows,
                                                          min_len):
    codes, is_dna = _dup_corpus(kind)
    js, ps = _stores(codes, is_dna, min_rows=min_rows)
    want = np.asarray(JD.duplicate_span_mask(js, min_len))
    got = D.duplicate_span_mask(ps, min_len)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(float(D.duplicate_fraction(ps, min_len)),
                               float(JD.duplicate_fraction(js, min_len)),
                               rtol=1e-6)


def test_reference_dedup_cases_hold_in_the_port():
    """``tests/test_dedup.py``'s cases, through the port and equal to the
    reference's answers."""
    codes, _ = _dup_corpus("dna")
    js, ps = _stores(codes, True)
    mask = D.duplicate_span_mask(ps, 32).numpy()
    assert mask[:150].all() and mask[812:912].all()
    assert mask[560:740].mean() < 0.2
    doc_ids = np.concatenate([np.zeros(512, int), np.ones(300, int),
                              np.full(200, 2)])
    keep = D.filter_duplicate_docs(ps, doc_ids, 32, threshold=0.5)
    assert keep[1] and not keep[2]
    np.testing.assert_array_equal(
        keep, JD.filter_duplicate_docs(js, doc_ids, 32, threshold=0.5))
    np.testing.assert_array_equal(D.doc_dup_scores(ps, doc_ids, 32),
                                  JD.doc_dup_scores(js, doc_ids, 32))
    corpus = P.dna_corpus(4000, seed=1, dup_fraction=0.5)
    js, ps = _stores(corpus, True)
    frac = float(D.duplicate_fraction(ps, 64))
    assert frac > 0.4
    np.testing.assert_allclose(frac, float(JD.duplicate_fraction(js, 64)),
                               rtol=1e-6)


def _windows(codes, rng, n_in, n_out, L, hi):
    """(B, L) windows: n_in cut from the corpus, n_out drawn fresh."""
    starts = rng.integers(0, len(codes) - L, n_in)
    cut = np.stack([codes[s:s + L] for s in starts]).astype(np.int32)
    fresh = rng.integers(0, hi, (n_out, L)).astype(np.int32)
    return np.concatenate([cut, fresh])


@pytest.mark.parametrize("kind", ["dna", "tokens"])
@pytest.mark.parametrize("L", [1, 8, 16, 17, 40])
def test_contamination_check_on_a_store_matches_reference(kind, L):
    rng = np.random.default_rng(L)
    codes, is_dna = _dup_corpus(kind)
    js, ps = _stores(codes, is_dna, min_rows=len(codes) + 100)
    w = _windows(codes, rng, 12, 12, L, 4 if is_dna else 5000)
    # a window running into the text's end, and one past it
    w = np.concatenate([w, codes[None, -L:].astype(np.int32),
                        np.concatenate([codes[-(L - 1):],
                                        codes[:1]])[None].astype(np.int32)
                        if L > 1 else codes[None, :1].astype(np.int32)])
    want = np.asarray(JD.contamination_check(js, w))
    got = D.contamination_check(ps, w)
    np.testing.assert_array_equal(got, want)
    assert got[:12].all()


@pytest.mark.parametrize("kind", ["dna", "tokens"])
def test_contamination_check_on_a_table_sees_appends(kind):
    """A table with a run and a memtable: the merged read finds windows
    inside the appends and straddling base and appends, as the
    reference's does."""
    rng = np.random.default_rng(7)
    codes, is_dna = _dup_corpus(kind)
    kw = dict(is_dna=is_dna, max_query_len=32, memtable_limit=120)
    jt = JTable.from_codes(codes, **kw)
    pt = SuffixTable.from_codes(codes, device=CPU, **kw)
    hi = 4 if is_dna else 5000
    apps = [rng.integers(0, hi, n).astype(codes.dtype) for n in (150, 60)]
    for a in apps:
        jt.append(a)
        pt.append(a)
    text = np.concatenate([codes] + apps)
    L = 20
    w = _windows(text, rng, 16, 8, L, hi)
    w = np.concatenate([w, apps[1][None, :L].astype(np.int32),
                        text[None, len(codes) - 5:len(codes) + 15]
                        .astype(np.int32)])
    want = np.asarray(JD.contamination_check(jt, w))
    got = D.contamination_check(pt, w)
    np.testing.assert_array_equal(got, want)
    assert got[:16].all() and got[-2:].all()


def test_dedup_token_pool_matches_reference():
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 512, 100).astype(np.int32) for _ in range(5)]
    docs.append(docs[0].copy())
    docs.append(np.concatenate([docs[2][:60], rng.integers(0, 512, 40)])
                .astype(np.int32))
    tokens = np.concatenate(docs)
    doc_ids = np.repeat(np.arange(len(docs)), 100)
    for min_len, thr in ((32, 0.5), (16, 0.3), (64, 0.5)):
        want = JP.dedup_token_pool(tokens, doc_ids, min_len, thr)
        got = P.dedup_token_pool(tokens, doc_ids, min_len, thr, device=CPU)
        np.testing.assert_array_equal(got, want)
        if min_len == 32:      # the planted pair is flagged on both sides
            assert not got[0] and not got[5] and got[1]


@pytest.mark.parametrize("arch", list_archs())
def test_synthetic_batches_match_reference(arch):
    jc, pc = jget(arch).reduced(), get_config(arch).reduced()
    for data in (JP.DataConfig(seed=3, global_batch=4, seq_len=16),
                 JP.DataConfig(seed=0, global_batch=2, seq_len=8)):
        pdata = P.DataConfig(**{f: getattr(data, f) for f in
                                ("seed", "global_batch", "seq_len",
                                 "dedup_min_len", "dedup_threshold")})
        for step in (0, 1, 17):
            a = JP.synthetic_batch(jc, data, step)
            b = P.synthetic_batch(pc, pdata, step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
        ja, pa = JP.make_batch_iter(jc, data, 5), P.make_batch_iter(
            pc, pdata, 5)
        for _ in range(3):
            (sa, a), (sb, b) = next(ja), next(pa)
            assert sa == sb
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n,seed,frac", [(1000, 0, 0.0), (4000, 1, 0.5),
                                         (777, 5, 0.1)])
def test_dna_corpus_matches_reference(n, seed, frac):
    np.testing.assert_array_equal(P.dna_corpus(n, seed, frac),
                                  JP.dna_corpus(n, seed, frac))
