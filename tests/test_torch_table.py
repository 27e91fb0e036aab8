"""The slice as a whole: a JAX ``SuffixTable`` and a port ``SuffixTable``
(``device="cpu"``) over the same text and the same random append / seal
schedule agree on count, found, first_pos and locate(top_k)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import SuffixTable as JTable  # noqa: E402
from repro_torch.api import SuffixTable  # noqa: E402
from repro_torch.core import codec as C, query as Q  # noqa: E402

CPU = "cpu"


def _assert_scans_agree(jt, pt, pats, top_k):
    a, b = jt.scan(pats, top_k=top_k), pt.scan(pats, top_k=top_k)
    for f in ("count", "found", "first_pos") + (("positions",)
                                                if top_k else ()):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)


@pytest.mark.parametrize("seed,base_n,limit,mq", [
    (0, 1200, 300, 32), (1, 700, 128, 16), (2, 2000, 500, 64),
])
def test_append_seal_schedule_matches_reference(seed, base_n, limit, mq):
    rng = np.random.default_rng(seed)
    base = C.random_dna(base_n, seed=seed)
    kw = dict(is_dna=True, memtable_limit=limit, max_query_len=mq)
    jt = JTable.from_codes(base, **kw)
    pt = SuffixTable.from_codes(base, device=CPU, **kw)
    pats = Q.random_patterns(90, 1, min(mq, 12), seed=seed) + [
        "A", "ACGT", "T" * 5]
    _assert_scans_agree(jt, pt, pats, top_k=0)
    for step in range(5):
        chunk = C.random_dna(int(rng.integers(40, limit)),
                             seed=100 * seed + step)
        jt.append(chunk)
        pt.append(chunk)
        if rng.random() < 0.3:
            jt.minor_compact()
            pt.minor_compact()
        assert (len(pt.runs), pt.memtable.size) == \
            (len(jt.runs), jt.memtable.size)
        _assert_scans_agree(jt, pt, pats, top_k=int(rng.integers(1, 6)))
        np.testing.assert_array_equal(pt.count(pats), jt.count(pats))
        np.testing.assert_array_equal(pt.contains(pats), jt.contains(pats))
        np.testing.assert_array_equal(pt.locate(pats[:10], top_k=3),
                                      jt.locate(pats[:10], top_k=3))
    for p in ("AC", "GATTA"):
        np.testing.assert_array_equal(pt.locate_range(p, limit=None),
                                      jt.locate_range(p, limit=None))
        np.testing.assert_array_equal(pt.locate_range(p, after=50, limit=4),
                                      jt.locate_range(p, after=50, limit=4))
    assert len(pt) == len(jt)
    assert pt.stats()["tiers"]["run_count"] == len(jt.runs)


def test_token_table_matches_reference():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 9, size=600).astype(np.int32)
    jt = JTable.from_codes(codes, max_query_len=8, memtable_limit=100)
    pt = SuffixTable.from_codes(codes, max_query_len=8, memtable_limit=100,
                                device=CPU)
    assert not pt.is_dna
    more = rng.integers(0, 9, size=130).astype(np.int32)
    jt.append(more)
    pt.append(more)
    patt = np.zeros((40, 8), np.int32)
    plen = rng.integers(1, 4, size=40).astype(np.int32)
    for i in range(40):
        s = int(rng.integers(0, 720))
        seg = np.concatenate([codes, more])[s:s + plen[i]]
        patt[i, :len(seg)] = seg
    import jax.numpy as jnp
    a = jt.scan_batch(jnp.asarray(patt), jnp.asarray(plen), top_k=3)
    b = pt.scan_batch(torch.from_numpy(patt), torch.from_numpy(plen),
                      top_k=3)
    for f in ("count", "found", "first_pos", "positions"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)


def test_stats_and_unported_options(tmp_path):
    pt = SuffixTable.from_codes("ACGTACGTTTGACA" * 20, device=CPU,
                                memtable_limit=64)
    pt.count(["ACG", "TTT"])
    pt.append("GGGGCCCC")
    pt.count(["GGGG"])
    s = pt.stats()
    assert s["device"] == "cpu" and s["build"]["mode"] == "in_memory"
    assert s["tiers"]["memtable_rows"] == 8
    assert s["planner"]["fused_batches"] == 1
    assert s["planner"]["base_only_batches"] == 1
    assert "dispatch" in s["latency"] and "dispatch_fused" in s["latency"]
    assert s["build"]["rounds"] == 10 and s["build"]["chunk_rows"] == 280
    assert s["planner"]["pad_slots"] == 0
    for kw in ({"mesh": object()}, {"distributed_build": True}):
        with pytest.raises(NotImplementedError):
            SuffixTable.from_codes("ACGT" * 8, device=CPU, **kw)
    # the routed mode's knobs are kept, as the reference keeps them
    t = SuffixTable.from_codes("ACGT" * 8, device=CPU, capacity_factor=1.5,
                               routed_min_batch=8)
    assert (t.capacity_factor, t.routed_min_batch) == (1.5, 8)
    # persistence, the commit log and compaction are ported: the
    # reference's rules for an in-memory table hold
    with pytest.raises(ValueError):
        SuffixTable.from_codes("ACGT" * 8, device=CPU, wal=True)
    with pytest.raises(RuntimeError):
        pt.flush()
    # the metrics feed is ported: one row per interval and a last one
    feed = str(tmp_path / "metrics.jsonl")
    pt.start_metrics(feed, interval_s=0)
    pt.stop_metrics()
    pt.stop_metrics()                      # idempotent
    with open(feed) as f:
        assert [__import__("json").loads(ln)["role"] for ln in f] == \
            ["table"]
    assert SuffixTable.from_codes("ACGT" * 8, device=CPU,
                                  max_runs=2).max_runs == 2
    assert s["version"] == 0 and s["wal"]["enabled"] is False
    assert pt.compact() == 1 and pt.stats()["tiers"]["base_rows"] == 288
    # the frozen tier is ported: the policy and freeze() both take it
    assert SuffixTable.from_codes("ACGT" * 8, device=CPU,
                                  fm_threshold=10).is_frozen
    assert pt.freeze().is_frozen and pt.stats()["tiers"]["frozen"]
    with pytest.raises(TypeError):
        SuffixTable.from_codes("ACGT", device=CPU, no_such_option=1)


def test_per_tier_match_positions_match_reference():
    """The per-tier oracle of the fused read (``Run``/``Memtable``
    ``match_positions``) agrees with the reference's, and its union with
    the base slice is the merged enumeration."""
    import jax.numpy as jnp
    base = C.random_dna(900, seed=9)
    kw = dict(is_dna=True, memtable_limit=200, max_query_len=16)
    jt = JTable.from_codes(base, **kw)
    pt = SuffixTable.from_codes(base, device=CPU, **kw)
    for i in range(5):
        chunk = C.random_dna(120, seed=900 + i)
        jt.append(chunk)
        pt.append(chunk)
    assert len(pt.runs) == 2 and pt.memtable.size == 120
    pats = Q.random_patterns(40, 1, 6, seed=9)
    jp, jl = jt.planner.encode(pats)
    pp, pl = pt.planner.encode(pats)
    for jtier, ptier in zip(jt.runs + [jt.memtable], pt.runs + [pt.memtable]):
        for g, w in zip(ptier.match_positions(pp, pl),
                        jtier.match_positions(jnp.asarray(jp),
                                              jnp.asarray(jl))):
            np.testing.assert_array_equal(g, w)
    text = np.concatenate([base] + [C.random_dna(120, seed=900 + i)
                                    for i in range(5)])
    for p in pats[:10]:
        want = [i for i in range(len(text) - len(p) + 1)
                if (text[i:i + len(p)] == C.encode_dna(p)).all()]
        np.testing.assert_array_equal(pt.locate_range(p, limit=None), want)


def test_planner_rebind_serves_the_new_store():
    from repro_torch.core.planner import ScanPlanner
    from repro_torch.core.tablet import build_tablet_store
    a = build_tablet_store(C.encode_dna("ACGTACGT"), device=CPU)
    b = build_tablet_store(C.encode_dna("TTTTTTTT"), device=CPU)
    plan = ScanPlanner(a)
    assert plan.scan(["TT"]).count[0] == 0
    gen = plan._cache.generation
    plan.rebind(b)
    assert plan._cache.generation == gen + 1
    assert plan.scan(["TT"]).count[0] == 7
    np.testing.assert_array_equal(plan.locate(["TTTTTTT"], top_k=3),
                                  [[1, 0, -1]])


@pytest.mark.parametrize("frozen", [False, True])
def test_stats_schema_matches_reference(frozen):
    """``stats()`` carries the reference's keys where the slice has them:
    ``tiers`` (with ``frozen`` and the six ``resident_bytes`` keys) and
    ``planner`` (all four ``mode_counts``), live and frozen; the frozen
    index's size agrees too."""
    base = C.random_dna(3000, seed=6)
    kw = dict(is_dna=True, memtable_limit=500)
    jt = JTable.from_codes(base, **kw)
    pt = SuffixTable.from_codes(base, device=CPU, **kw)
    if frozen:
        jt.freeze()
        pt.freeze()
    for t in (jt, pt):
        t.count(["ACGT", "A"])
        t.append(C.random_dna(600, seed=7))
        t.append(C.random_dna(100, seed=8))
        t.count(["ACGT", "GATTACA"])
    a, b = jt.stats(), pt.stats()
    assert set(b["tiers"]) == set(a["tiers"])
    assert set(b["tiers"]["resident_bytes"]) == set(
        a["tiers"]["resident_bytes"]) == {"base_sa", "fm", "text_device",
                                          "runs", "memtable", "text_host"}
    assert set(b["planner"]["mode_counts"]) == set(
        a["planner"]["mode_counts"])
    assert b["planner"]["mode_counts"] == a["planner"]["mode_counts"]
    assert b["tiers"]["frozen"] is a["tiers"]["frozen"] is frozen
    # base_sa differs on a live table by design: the reference keeps a
    # host mirror of the SA for first_pos, the port reduces on the device
    for k in ("fm", "memtable", "text_host") + (("base_sa",) if frozen
                                                 else ()):
        assert b["tiers"]["resident_bytes"][k] == \
            a["tiers"]["resident_bytes"][k], k
    if frozen:
        assert b["tiers"]["resident_bytes"]["text_device"] == 0
        assert 0 < b["tiers"]["resident_bytes"]["fm"] < 3000 * 4 / 4


def test_numpy_batches_match_reference():
    """``scan_batch`` and ``scan_encoded`` take numpy batches, as the
    reference's do: packed DNA words stay uint32, token codes int32;
    base only, then merged after an append."""
    jt = JTable.from_codes("ACGTACGTTACG", max_query_len=16)
    pt = SuffixTable.from_codes("ACGTACGTTACG", max_query_len=16,
                                device=CPU)
    patt, plen = (np.asarray(x) for x in jt.planner.encode(["ACG"]))
    assert patt.dtype == np.uint32 and plen.dtype == np.int32
    for want in (3, 4):
        a, b = jt.scan_batch(patt, plen, top_k=5), \
            pt.scan_batch(patt, plen, top_k=5)
        assert b.count.tolist() == a.count.tolist() == [want]
        for f in ("found", "first_pos", "positions"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
        ea, eb = jt.scan_encoded(patt, plen), pt.scan_encoded(patt, plen)
        for f in ("found", "count", "first_rank", "first_pos"):
            np.testing.assert_array_equal(getattr(eb, f).numpy(),
                                          np.asarray(getattr(ea, f)), f)
        jt.append("ACG")
        pt.append("ACG")
    codes = np.array([1, 2, 3, 1, 2], np.int32)
    jt = JTable.from_codes(codes, is_dna=False, max_query_len=4)
    pt = SuffixTable.from_codes(codes, is_dna=False, max_query_len=4,
                                device=CPU)
    patt = np.array([[1, 2, 0, 0]], np.int32)
    plen = np.array([2], np.int32)
    for want in (2, 3):
        a, b = jt.scan_batch(patt, plen, top_k=4), \
            pt.scan_batch(patt, plen, top_k=4)
        assert b.count.tolist() == a.count.tolist() == [want]
        np.testing.assert_array_equal(b.positions, a.positions)
        eb = pt.scan_encoded(patt, plen)
        assert eb.count.tolist() == [want]
        jt.append(np.array([1, 2], np.int32))
        pt.append(np.array([1, 2], np.int32))
