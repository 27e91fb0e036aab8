"""The base's k-mer table (``repro_torch.api.kmers``): each 1..8-base
string's smallest base position against a brute-force scan, its lookup
from packed batches, and tables that answer short patterns' ``first_pos``
from it, live and frozen, through appends, compaction and a reopen,
against the JAX package's ``SuffixTable`` and the benchmark's plain
reference; the counters of the patterns it answers, and token tables,
which have none and keep the slice minimum."""
import os

import numpy as np
import pytest
import torch

from repro.api import SuffixTable as JTable
from repro_torch.api import SuffixTable, kmers
from repro_torch.core import codec as C, query as Q

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MQ = 16


def brute_kmin(codes: np.ndarray) -> np.ndarray:
    """The table by one scan of every suffix's first 1..8 bases."""
    out = np.full(kmers.SIZE, -1, np.int64)
    n = len(codes)
    for p in range(n - 1, -1, -1):          # last write is the smallest p
        x = 0
        for length in range(1, min(kmers.K, n - p) + 1):
            x = 4 * x + int(codes[p + length - 1])
            out[(4 ** length - 4) // 3 + x] = p
    return out


def _entry(s: str) -> int:
    x = 0
    for ch in s:
        x = 4 * x + "ACGT".index(ch)
    return (4 ** len(s) - 4) // 3 + x


@pytest.mark.parametrize("n", [0, 1, 5, 7, 8, 9, 15, 300, 3001])
def test_kmin_matches_brute_force(n):
    codes = C.random_dna(n, seed=40 + n)
    got = kmers.build(codes, CPU)
    assert got.dtype == torch.int32 and got.shape == (kmers.SIZE,)
    np.testing.assert_array_equal(got.numpy(), brute_kmin(codes))


def test_kmin_across_device_passes(monkeypatch):
    """Windows taken a few at a time, the last pass short, give the
    table of one pass."""
    codes = C.random_dna(2003, seed=9)
    monkeypatch.setattr(kmers, "CHUNK", 97)
    np.testing.assert_array_equal(kmers.build(codes, CPU).numpy(),
                                  brute_kmin(codes))


def test_kmin_tail_and_absent_strings():
    """Strings that occur only among the last 7 positions (which start
    no 8-mer) get those positions; strings that do not occur get -1."""
    text = "A" * 12 + "CGT"                  # n = 15: 8-mers start at 0..7
    got = kmers.build(C.encode_dna(text), CPU).numpy()
    for s, want in [("A", 0), ("A" * 8, 0), ("A" * 9, -1), ("ACGT", 11),
                    ("AACGT", 10), ("CGT", 12), ("GT", 13), ("T", 14),
                    ("AAAAACGT", 7), ("C", 12), ("GG", -1), ("TA", -1),
                    ("CGTA", -1)]:
        if len(s) <= kmers.K:
            assert got[_entry(s)] == want, s
    # a text shorter than one 8-mer: every entry from the tail
    got = kmers.build(C.encode_dna("GATTACA"), CPU).numpy()
    for s, want in [("GATTACA", 0), ("A", 1), ("TTA", 2), ("ACA", 4),
                    ("CA", 5), ("G", 0), ("AG", -1), ("GATTACAA", -1)]:
        assert got[_entry(s)] == want, s


def test_lookup_reads_packed_batches():
    codes = C.random_dna(500, seed=2)
    text = C.decode_dna(codes)
    table = kmers.build(codes, CPU)
    pats = ["", "A", "TG", text[37:40], text[100:108], text[100:109],
            "GGGGGGGG", text[3:19], text[3:20], "CCCCCCC"]
    _, words, lens = Q.encode_patterns(pats, 32, device=CPU)
    got = kmers.lookup(table, words, lens).numpy()
    want = [text.find(p) if 1 <= len(p) <= kmers.K else -1 for p in pats]
    np.testing.assert_array_equal(got, want)


def _reference(text_codes: np.ndarray):
    from suffixbench import spec
    mod = spec.load_module(
        os.path.join(ROOT, "suffixbench", "reference", "suffix_array.py"),
        "suffixbench_reference_for_kmers")
    return mod.SuffixReference(torch.from_numpy(text_codes), MQ)


def _patterns(text: str, seed: int) -> list[str]:
    """1-12 bases: half cut from the text (found), half drawn."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(240):
        length = 1 + i % 12
        if i % 2:
            p = int(rng.integers(0, len(text) - length))
            out.append(text[p:p + length])
        else:
            out.append("".join("ACGT"[b] for b in rng.integers(0, 4, length)))
    return out


def _check(jt, pt, text_codes, pats):
    """``scan_batch`` count, found and first_pos of the port against the
    JAX table's and the plain reference's over the whole logical text."""
    codes, words, lens = Q.encode_patterns(pats, MQ, device=CPU)
    import jax.numpy as jnp
    a = jt.scan_batch(jnp.asarray(words.view(torch.int32).numpy()
                                  .view(np.uint32)),
                      jnp.asarray(lens.numpy()))
    b = pt.scan_batch(words, lens)
    for f in ("count", "found", "first_pos"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    want_count, want_first = _reference(text_codes).answer(codes, lens)
    np.testing.assert_array_equal(b.count, want_count)
    np.testing.assert_array_equal(b.first_pos, want_first)


@pytest.mark.parametrize("frozen", [False, True])
def test_short_patterns_match_reference_through_writes(frozen, tmp_path):
    """Live and frozen DNA tables, patterns of 1-12 bases: after
    appends into the memtable and a sealed run, after ``compact`` (whose
    new base's table is built anew: a string first met in the appended
    text is answered from it) and after a save and ``open``."""
    base = C.random_dna(1500, seed=21 + frozen)
    kw = dict(is_dna=True, max_query_len=MQ)
    jt = JTable.create("dna", base, root=str(tmp_path / "jax"), **kw)
    pt = SuffixTable.create("dna", base, root=str(tmp_path / "torch"),
                            device=CPU, **kw)
    if frozen:
        jt.freeze(sample_rate=8)
        pt.freeze(sample_rate=8)
    text = base
    pats = _patterns(C.decode_dna(base), seed=3)
    _check(jt, pt, text, pats)
    # a string absent from the base, then appended: a new base's table
    # must hold it after the compaction
    absent = next(s for s in ("".join("ACGT"[(x >> 2 * i) & 3]
                                      for i in range(7))
                              for x in range(4 ** 7))
                  if s not in C.decode_dna(base))
    for chunk in (C.random_dna(200, seed=5), C.encode_dna(absent * 3)):
        jt.append(chunk)
        pt.append(chunk)
        text = np.concatenate([text, chunk])
        _check(jt, pt, text, pats + [absent])
    jt.minor_compact()
    pt.minor_compact()
    more = C.random_dna(90, seed=6)
    jt.append(more)
    pt.append(more)
    text = np.concatenate([text, more])
    _check(jt, pt, text, pats + [absent])
    jt.compact()
    pt.compact()
    assert pt.is_frozen == frozen and pt.n_base == len(text)
    np.testing.assert_array_equal(pt._kmin.numpy(),
                                  kmers.build(text, CPU).numpy())
    before = pt.tracer.snapshot()["kmer_patterns"]["sum_ms"]
    _check(jt, pt, text, [absent])
    assert pt.tracer.snapshot()["kmer_patterns"]["sum_ms"] == before + 1
    _check(jt, pt, text, _patterns(C.decode_dna(text), seed=4))
    pt.close()
    jt.close()
    jt = JTable.open("dna", root=str(tmp_path / "jax"))
    pt = SuffixTable.open("dna", root=str(tmp_path / "torch"), device=CPU)
    assert pt.is_frozen == frozen
    np.testing.assert_array_equal(pt._kmin.numpy(),
                                  kmers.build(text, CPU).numpy())
    _check(jt, pt, text, pats + [absent])
    pt.close()
    jt.close()


@pytest.mark.parametrize("frozen", [False, True])
def test_counters_count_the_short_matching_patterns(frozen):
    """``kmer_patterns`` counts exactly the base matches of 1-8 bases,
    ``slice_patterns`` the longer ones and ``slice_rows`` their rows;
    a batch with no base match counts nothing."""
    codes = C.random_dna(4000, seed=8)
    text = C.decode_dna(codes)
    pt = SuffixTable.from_codes(codes, is_dna=True, max_query_len=MQ,
                                device=CPU)
    if frozen:
        pt.freeze(sample_rate=8)
    pats = _patterns(text, seed=11) + ["ACGT" * 4]
    _, words, lens = Q.encode_patterns(pats, MQ, device=CPU)
    out = pt.scan_batch(words, lens)
    counts = np.array([sum(text.startswith(p, i) for i in range(len(text)))
                       for p in pats])
    np.testing.assert_array_equal(out.count, counts)
    short = np.array([len(p) <= kmers.K for p in pats])
    snap = pt.tracer.snapshot()
    assert snap["kmer_patterns"]["sum_ms"] == ((counts > 0) & short).sum()
    assert snap["slice_patterns"]["sum_ms"] == ((counts > 0) & ~short).sum()
    assert snap["slice_rows"]["sum_ms"] == counts[~short].sum()
    assert snap["kmer_patterns"]["total"] == 1
    child = "lf_walk" if frozen else "range_min"
    assert snap[child]["total"] == 1
    nothing = next(p for p in ("GATTACA" * 2, "ACGT" * 4, "TTGCA" * 3)
                   if p not in text)
    _, words, lens = Q.encode_patterns([nothing], MQ, device=CPU)
    assert pt.scan_batch(words, lens).count[0] == 0
    after = pt.tracer.snapshot()
    for name in ("kmer_patterns", "slice_patterns", "slice_rows", child):
        assert after[name] == snap[name], name


def test_token_table_keeps_the_slice_minimum():
    """A token table builds no k-mer table: every base match, short ones
    too, goes to the slice minimum, with the JAX table's answers."""
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, 4, 900).astype(np.int32)
    jt = JTable.from_codes(tokens, is_dna=False, max_query_len=8)
    pt = SuffixTable.from_codes(tokens, is_dna=False, max_query_len=8,
                                device=CPU)
    assert pt._kmin is None and not pt.is_dna
    plen = rng.integers(1, 6, size=60).astype(np.int32)
    patt = np.zeros((60, 8), np.int32)
    for i in range(60):
        s = int(rng.integers(0, 890))
        patt[i, :plen[i]] = tokens[s:s + plen[i]]
    import jax.numpy as jnp
    a = jt.scan_batch(jnp.asarray(patt), jnp.asarray(plen))
    b = pt.scan_batch(torch.from_numpy(patt), torch.from_numpy(plen))
    for f in ("count", "found", "first_pos"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    snap = pt.tracer.snapshot()
    assert snap["kmer_patterns"]["sum_ms"] == 0
    assert snap["slice_patterns"]["sum_ms"] == (b.count > 0).sum() == 60
    assert snap["range_min"]["total"] == 1
