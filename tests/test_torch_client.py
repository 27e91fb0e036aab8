"""The client frontend of the port (``repro_torch.api.client``, on the
CPU) against ``repro.api.client``: the scripts of ``tests/test_client.py``
run through both packages, at that file's sizes, and every answer must be
equal — counts, found, first_pos, top-k positions, pages and cursors.
Raw-codes queries carry numpy arrays, as the reference's do.  The
metrics feed rows the port writes keep the reference's schema."""
import json
import threading

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                    # pragma: no cover
    from _hypothesis_compat import given, settings, strategies as st

torch = pytest.importorskip("torch")

import repro.api as R  # noqa: E402
import repro_torch.api as T  # noqa: E402
from repro.core import codec as RC, query as RQ  # noqa: E402
from repro_torch.core import codec as C, query as Q  # noqa: E402

PKGS = (R, T)


def _kw(pkg, **kw):
    """Construction keywords: the port's tables are built on the CPU."""
    return dict(kw, device="cpu") if pkg is T else kw


def _db_over(pkg, codes, name="dna", **kw):
    db = pkg.Database.in_memory()
    table = db.attach(name, pkg.SuffixTable.from_codes(
        codes, is_dna=True, **_kw(pkg, **kw)))
    return db, table


def _oracle_positions(codes, pattern):
    cc = np.asarray(codes).astype(np.int32)
    pc = C.encode_dna(pattern).astype(np.int32)
    k = len(pc)
    return [i for i in range(len(cc) - k + 1) if (cc[i:i + k] == pc).all()]


def _assert_same(got, want):
    """Two QueryResults (or ScanOutcomes) carry the same answer."""
    for f in ("count", "found", "first_pos"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    assert (got.positions is None) == (want.positions is None)
    if got.positions is not None:
        np.testing.assert_array_equal(got.positions, want.positions)


def test_codec_and_workload_generators_agree():
    """The scripts below feed both packages the same text and patterns."""
    np.testing.assert_array_equal(C.random_dna(777, seed=3),
                                  RC.random_dna(777, seed=3))
    assert Q.random_patterns(50, 1, 9, seed=4) == \
        RQ.random_patterns(50, 1, 9, seed=4)


# ---------------------------------------------------------------------------
# typed request validation + routing
# ---------------------------------------------------------------------------
def test_query_validation():
    Query = T.Query
    with pytest.raises(ValueError, match="kind"):
        Query(table="t", kind="explode", patterns=("A",))
    with pytest.raises(ValueError, match="exactly one"):
        Query(table="t", patterns=("A",), codes=np.zeros((1, 4)),
              lens=np.array([1]))
    with pytest.raises(ValueError, match="exactly one"):
        Query(table="t")
    with pytest.raises(ValueError, match="lens"):
        Query(table="t", codes=np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="max_len"):
        Query.count("t", ["ACGTACGT"], max_len=4)
    with pytest.raises(TypeError):
        Query(table="t", patterns=(b"ACGT",))
    q = Query.locate("t", ["ACGT"])            # locate defaults top_k to 8
    assert q.top_k == 8 and q.num_patterns == 1
    with pytest.raises(ValueError, match="top_k"):
        Query.locate("t", ["ACGT"], top_k=-5)
    assert Query.count("t", ["AC", "GT"]).num_patterns == 2


def _routes_script(pkg, root):
    """test_client.py's routing and lifecycle script; returns the counts
    it read."""
    db = pkg.Database(root, **_kw(pkg))
    db.create_table("dna", RC.random_dna(500, seed=0), is_dna=True,
                    **_kw(pkg))
    mem = pkg.SuffixTable.from_codes(RC.random_dna(300, seed=1),
                                     is_dna=True, **_kw(pkg))
    db.attach("scratch", mem)
    assert db.list_tables() == ["dna", "scratch"]
    assert "dna" in db and "scratch" in db and "nope" not in db
    with pytest.raises(ValueError, match="already attached"):
        db.attach("scratch", mem)
    db2 = pkg.Database(root, **_kw(pkg))
    a = int(db2.query(pkg.Query.count("dna", ["A"])).value[0])
    assert a == int(db.query(pkg.Query.count("dna", ["A"])).value[0])
    with pytest.raises(KeyError):
        pkg.Database.in_memory().table("anything")
    assert db.ensure_attached(mem) == "scratch"
    other = pkg.SuffixTable.from_codes(RC.random_dna(100, seed=2),
                                       **_kw(pkg))
    alt = db.ensure_attached(other, name="dna")
    assert alt != "dna" and db.table(alt) is other
    mdb = pkg.Database.in_memory()
    mdb.attach("t", mem)
    mdb.drop_table("t")
    mdb.drop_table("t", missing_ok=True)
    with pytest.raises(KeyError):
        mdb.drop_table("t")
    with pytest.raises(KeyError):
        db.drop_table("scratch")
    s = int(db.query(pkg.Query.count("scratch", ["A"])).value[0])
    db.close(), db2.close(), mdb.close()
    return a, s


def test_database_routes_and_lifecycle(tmp_path):
    want = _routes_script(R, str(tmp_path / "ref"))
    assert _routes_script(T, str(tmp_path / "port")) == want
    # the on-disk format is shared: the port's handle opens and serves
    # the reference's table
    db = T.Database(str(tmp_path / "ref"), device="cpu")
    assert int(db.query(T.Query.count("dna", ["A"])).count[0]) == want[0]
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        db.connect_plane("dna")
    made = db.create_table("dna3", RC.random_dna(200, seed=3), is_dna=True)
    assert made.device.type == "cpu"           # the handle's device
    db.drop_table("dna3")
    db.drop_table("dna")
    assert "dna" not in db and db.list_tables() == []
    db.close()
    with pytest.raises(RuntimeError, match="closed"):
        db.table("dna")


def test_kinds_payload_and_errors():
    pats = ["ACGT", "TTTTTTTTTTTTTTTTTTTTTTTTTTTTTTTT"]
    rdb, rt = _db_over(R, RC.random_dna(2000, seed=3))
    want = rt.scan(pats, top_k=8)
    db, table = _db_over(T, RC.random_dna(2000, seed=3))
    _assert_same(table.scan(pats, top_k=8), want)
    assert (db.query(T.Query.count("dna", pats)).value == want.count).all()
    assert (db.query(T.Query.contains("dna", pats)).value
            == want.found).all()
    assert (db.query(T.Query.locate("dna", pats, top_k=8)).value
            == want.positions).all()
    full = db.query(T.Query.scan("dna", pats, top_k=8)).value
    assert (full.first_pos == want.first_pos).all()
    bad = db.query(T.Query.count("nope", ["A"]))
    assert not bad.ok and "KeyError" in bad.error
    with pytest.raises(RuntimeError, match="query failed"):
        bad.value
    toolong = db.query(T.Query.count("dna", ["A" * 200]))
    assert not toolong.ok and "max_pattern_len" in toolong.error
    assert "max_pattern_len" in \
        rdb.query(R.Query.count("dna", ["A" * 200])).error
    db.close(), rdb.close()


# ---------------------------------------------------------------------------
# coalescing: bit-identical to per-call, across tables and callers
# ---------------------------------------------------------------------------
def _query_many_script(pkg):
    db, t1 = _db_over(pkg, RC.random_dna(3000, seed=4))
    t2 = db.attach("dna2", pkg.SuffixTable.from_codes(
        RC.random_dna(1500, seed=5), is_dna=True, **_kw(pkg)))
    t2.append("GATTACA")
    rng = np.random.default_rng(6)
    queries = []
    for i in range(40):
        name = "dna" if i % 2 == 0 else "dna2"
        pats = RQ.random_patterns(int(rng.integers(1, 4)), 1, 9,
                                  seed=100 + i)
        queries.append(pkg.Query.scan(name, pats,
                                      top_k=int(rng.integers(0, 6))))
    coalesced = db.query_many(queries)
    for q, got in zip(queries, coalesced):
        t1.clear_cache(), t2.clear_cache()
        _assert_same(got, db.query(q))
    assert all(r.ok for r in coalesced)
    assert any(r.batch_size > q.num_patterns
               for q, r in zip(queries, coalesced))
    db.close()
    return coalesced


def test_query_many_coalesces_bit_identical_across_tables():
    for got, want in zip(_query_many_script(T), _query_many_script(R)):
        _assert_same(got, want)
        assert got.batch_size == want.batch_size


def test_scheduler_coalesces_concurrent_callers():
    codes = RC.random_dna(4000, seed=7)
    pats = RQ.random_patterns(32, 1, 10, seed=8)
    rdb, rt = _db_over(R, codes)
    want = rt.scan(pats, top_k=4)
    rdb.close()
    db, table = _db_over(T, codes)
    _assert_same(table.scan(pats, top_k=4), want)
    table.clear_cache()
    results = [None] * len(pats)

    def caller(i):
        results[i] = db.submit(
            T.Query.scan("dna", [pats[i]], top_k=4)).result(timeout=30.0)

    threads = [threading.Thread(target=caller, args=(i,))
               for i in range(len(pats))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    for i, res in enumerate(results):
        assert res is not None and res.ok
        assert int(res.count[0]) == int(want.count[i])
        assert int(res.first_pos[0]) == int(want.first_pos[i])
        assert (res.positions[0] == want.positions[i]).all()
    s = db.scheduler.stats
    assert s.submitted == 32 and s.executed == 32
    assert s.batches < s.submitted          # some coalescing happened
    assert s.coalesced_queries > 0 and s.max_batch_patterns > 1
    db.close()
    with pytest.raises(RuntimeError, match="closed"):
        db.submit(T.Query.count("dna", ["A"]))


def test_inline_callers_race_scheduler_worker_on_shared_cache():
    """Inline callers race the scheduler worker on one hot pattern while
    client appends bump the cache generation: no error result, no stale
    count, and the final count equals the reference's after the same
    appends."""
    db, table = _db_over(T, RC.random_dna(1500, seed=20))
    probe = "GATTACA"
    floor = int(table.count([probe])[0])
    errors: list[str] = []

    def inline_caller():
        for _ in range(12):
            res = db.query(T.Query.count("dna", [probe]))
            if not res.ok:
                errors.append(res.error)
            elif int(res.count[0]) < floor:
                errors.append(f"stale count {int(res.count[0])} < {floor}")

    def writer():
        for i in range(6):
            db.append("dna", RC.random_dna(20, seed=30 + i))

    futs = [db.submit(T.Query.count("dna", [probe])) for _ in range(8)]
    threads = [threading.Thread(target=inline_caller) for _ in range(3)]
    threads.append(threading.Thread(target=writer))
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    for f in futs:
        res = f.result(timeout=30.0)
        assert res.ok and int(res.count[0]) >= floor
    assert errors == [], errors
    got = int(db.query(T.Query.count("dna", [probe])).count[0])
    assert got == int(table.count([probe])[0])
    rt = R.SuffixTable.from_codes(RC.random_dna(1500, seed=20), is_dna=True)
    for i in range(6):
        rt.append(RC.random_dna(20, seed=30 + i))
    assert got == int(rt.count([probe])[0])
    db.close()


def test_deadline_is_enforced_not_silently_dropped():
    db, _ = _db_over(T, RC.random_dna(500, seed=9))
    ok = db.query(T.Query.count("dna", ["ACGT"], deadline_ms=60_000.0))
    assert ok.ok
    expired = db.query(T.Query.count("dna", ["ACGT"], deadline_ms=0.0))
    assert not expired.ok and "deadline exceeded" in expired.error
    assert db.scheduler.stats.deadline_expired == 1
    wave = db.query_many([T.Query.count("dna", ["ACGT"], deadline_ms=0.0),
                          T.Query.count("dna", ["ACGT"])])
    assert not wave[0].ok and wave[1].ok
    rdb, _ = _db_over(R, RC.random_dna(500, seed=9))
    np.testing.assert_array_equal(
        wave[1].count, rdb.query(R.Query.count("dna", ["ACGT"])).count)
    db.close(), rdb.close()


def test_raw_codes_queries_carry_numpy_batches():
    """Raw-codes queries (numpy packed DNA words, numpy token codes)
    through both clients, base only and merged, coalesced in one wave."""
    out = {}
    for pkg in PKGS:
        db, dna = _db_over(pkg, RC.random_dna(1200, seed=21))
        tok = db.attach("tok", pkg.SuffixTable.from_codes(
            np.random.default_rng(2).integers(0, 9, 700).astype(np.int32),
            max_query_len=8, **_kw(pkg)))
        pats = RQ.random_patterns(12, 1, 10, seed=22)
        _, packed, lens = RQ.encode_patterns(pats, 128)
        codes = np.asarray(packed)
        lens = np.asarray(lens)
        assert codes.dtype == np.uint32
        rng = np.random.default_rng(23)
        tcodes = rng.integers(0, 9, (10, 8)).astype(np.int32)
        tlens = rng.integers(1, 4, 10).astype(np.int32)
        res = []
        for step in range(2):
            wave = db.query_many([
                pkg.Query(table="dna", kind="scan", codes=codes[:6],
                          lens=lens[:6], top_k=3),
                pkg.Query(table="dna", kind="scan", codes=codes[6:],
                          lens=lens[6:], top_k=3),
                pkg.Query(table="tok", kind="scan", codes=tcodes,
                          lens=tlens, top_k=2)])
            assert all(r.ok for r in wave), [r.error for r in wave]
            assert wave[0].batch_size == 12
            res += wave
            dna.append(RC.random_dna(300, seed=24))
            tok.append(rng.integers(0, 9, 90).astype(np.int32))
        db.close()
        out[pkg.__name__] = res
    for got, want in zip(out[T.__name__], out[R.__name__]):
        _assert_same(got, want)


# ---------------------------------------------------------------------------
# paged streaming (ReadSession)
# ---------------------------------------------------------------------------
def test_read_session_pages_and_cursor_resume():
    db, table = _db_over(T, RC.random_dna(3000, seed=10))
    probe = "AC"
    want = _oracle_positions(table._codes, probe)
    assert len(want) > 30
    pages = list(db.read_rows("dna", probe, page_size=7).pages())
    got = [int(x) for p in pages for x in p.positions]
    assert got == want
    assert pages[-1].is_last and not any(p.is_last for p in pages[:-1])
    assert all(len(p.positions) <= 7 for p in pages)
    sess = db.read_rows("dna", probe, page_size=7)
    first = sess.next_page()
    # cursors are the reference's tokens: one package resumes the other's
    rdb, _ = _db_over(R, RC.random_dna(3000, seed=10))
    rfirst = rdb.read_rows("dna", probe, page_size=7).next_page()
    assert json.loads(first.cursor) == json.loads(rfirst.cursor)
    rest = [int(x) for x in db.resume_read(rfirst.cursor).positions()]
    assert [int(x) for x in first.positions] + rest == want
    none = list(db.read_rows("dna", "A" * 40, page_size=5).pages())
    assert len(none) == 1 and none[0].is_last \
        and none[0].positions.size == 0
    with pytest.raises(ValueError):
        db.read_rows("dna", probe, page_size=0)
    db.close(), rdb.close()


@given(st.integers(0, 10_000), st.integers(1, 3), st.integers(40, 160),
       st.integers(1, 17))
@settings(max_examples=4, deadline=None)
def test_read_session_property_pages_equal_one_shot(seed, n_appends, chunk,
                                                    page_size):
    """Property: for random append/seal schedules, page concatenation ==
    the one-shot enumeration == the brute-force oracle == the
    reference's enumeration; a cursor taken mid-stream resumes exactly
    after a minor compaction reshapes the tiers under it."""
    rng = np.random.default_rng(seed)
    base = RC.random_dna(int(rng.integers(200, 600)), seed=seed)
    db, table = _db_over(T, base)
    ref = R.SuffixTable.from_codes(base, is_dna=True)
    combined = base
    for a in range(n_appends):
        app = RC.random_dna(chunk, seed=seed * 11 + a)
        table.append(app)
        ref.append(app)
        combined = np.concatenate([combined, app])
        if rng.random() < 0.5:
            table.minor_compact()
            ref.minor_compact()
    probe = C.decode_dna(combined[:int(rng.integers(1, 3))])
    want = _oracle_positions(combined, probe)
    one_shot = [int(x) for x in table.locate_range(probe, limit=10**6)]
    assert one_shot == want
    assert [int(x) for x in ref.locate_range(probe, limit=10**6)] == want
    got = [int(x)
           for x in db.read_rows("dna", probe, page_size=page_size)
           .positions()]
    assert got == want

    sess = db.read_rows("dna", probe, page_size=page_size)
    first = sess.next_page()
    cursor = first.cursor
    head = [int(x) for x in first.positions]
    app = RC.random_dna(60, seed=seed + 999)
    table.append(app)
    combined = np.concatenate([combined, app])
    table.minor_compact()
    tail = [int(x) for x in db.resume_read(cursor).positions()]
    new_want = _oracle_positions(combined, probe)
    cut = head[-1] if head else -1
    assert tail == [p for p in new_want if p > cut]
    assert head == [p for p in new_want if p <= cut]
    db.close()


# ---------------------------------------------------------------------------
# cache staleness + stats schema
# ---------------------------------------------------------------------------
def test_topk_cache_generation_stamping():
    from repro_torch.core.planner import TopKCache
    c = TopKCache(8)
    c.put("p", 3, 7, 0, None)
    assert c.get("p", 0) == (3, 7, None)
    gen = c.bump()
    assert gen == 1 and c.get("p", 0) is None
    c.put("p", 4, 7, 0, None)
    assert c.get("p", 0) == (4, 7, None)
    c.put("q", 5, 1, 8, np.arange(8))
    c.bump()
    c.put("q", 6, 2, 0, None)
    assert c.get("q", 0) == (6, 2, None)
    assert c.hits == 3 and c.misses == 1


def test_no_stale_counts_after_write_through_any_surface():
    """A count cached before a write is never served after it: through
    the table, a captured planner, or a serving engine built before a
    major compaction; every count equals the reference's."""
    from repro_torch.serving import HedgedScanService
    codes = RC.random_dna(1200, seed=11)
    table = T.SuffixTable.from_codes(codes, is_dna=True, device="cpu")
    ref = R.SuffixTable.from_codes(codes, is_dna=True)
    svc = HedgedScanService(table, seed=0)
    planner = table.planner
    probe = "GATTACA" * 2
    base = int(table.count([probe])[0])
    assert base == int(ref.count([probe])[0])
    planner.scan([probe])

    table.append(probe)
    assert int(table.count([probe])[0]) == base + 1
    table.minor_compact()
    assert int(table.count([probe])[0]) == base + 1
    table.compact()
    assert int(table.count([probe])[0]) == base + 1
    assert planner is table.planner
    assert int(planner.scan([probe]).count[0]) == base + 1
    _, pp, pl = Q.encode_patterns([probe], 128, device="cpu")
    assert int(svc.scan(pp, pl, hedged=False)[0].count[0]) == base + 1


def test_stats_schema_is_stable_and_documented():
    """The port's ``stats()`` carries the reference's keys at every level
    (plus ``device``), on the same script, with the same build record
    and planner counters apart from ``pad_slots``: the port pads no
    batch, so it stays 0 where the reference counts its bucket padding."""
    stats = {}
    for pkg in PKGS:
        db, table = _db_over(pkg, RC.random_dna(800, seed=12),
                             memtable_limit=200)
        db.query(pkg.Query.count("dna", ["ACGT"]))
        db.query(pkg.Query.count("dna", ["ACGT"]))     # cached
        table.append(RC.random_dna(250, seed=13))      # seals a run
        db.query(pkg.Query.scan("dna", ["ACG", "T", "GATTACA"], top_k=2))
        stats[pkg.__name__] = (table.stats(), db.stats())
        db.close()
    (s, dbs), (r, rdbs) = stats[T.__name__], stats[R.__name__]
    assert set(s) == set(r) | {"device"} and s["device"] == "cpu"
    for k in ("tiers", "cache", "build", "planner", "wal"):
        assert set(s[k]) == set(r[k]), k
    assert list(s["build"]) == list(r["build"])
    assert set(s["tiers"]["resident_bytes"]) == \
        set(r["tiers"]["resident_bytes"])
    assert set(s["latency"]["total"]) == set(r["latency"]["total"])
    assert set(s["latency"]) <= set(r["latency"]) | {"dispatch_fused"}
    for k in ("mode", "n_bases", "rounds", "n_chunks", "chunk_rows",
              "peak_device_bytes", "spill_bytes"):
        assert s["build"][k] == r["build"][k], k
    assert s["tiers"]["base_rows"] == 800 and s["tiers"]["run_count"] == 1
    for k in ("base_rows", "run_count", "run_rows", "memtable_rows",
              "frozen"):
        assert s["tiers"][k] == r["tiers"][k], k
    assert s["cache"] == r["cache"]
    for k in ("batches", "queries", "bucketed_batches", "bucketed_queries",
              "retried_overflow", "retried_saturated",
              "retried_inexact_rank", "mode_counts", "fused_batches",
              "base_only_batches", "tier_reads"):
        assert s["planner"][k] == r["planner"][k], k
    assert s["planner"]["pad_slots"] == 0 < r["planner"]["pad_slots"]
    assert s["wal"] == r["wal"]
    assert set(dbs) == set(rdbs) == {"scheduler", "tables"}
    assert set(dbs["scheduler"]) == set(rdbs["scheduler"])
    assert set(dbs["scheduler"]["latency"]) == \
        set(rdbs["scheduler"]["latency"])
    for k in ("submitted", "executed", "batches", "coalesced_queries",
              "max_batch_patterns", "fast_path_queries"):
        assert dbs["scheduler"][k] == rdbs["scheduler"][k], k


def test_scan_batch_bucket_padding_accounts_slots():
    """The reference pads 5 queries to a bucket of 8 and counts 3 pad
    slots; the port pads nothing: one bucketed batch of 5 real queries,
    0 pad slots, and the same answers."""
    rt = R.SuffixTable.from_codes(RC.random_dna(600, seed=14), is_dna=True)
    table = T.SuffixTable.from_codes(RC.random_dna(600, seed=14),
                                     is_dna=True, device="cpu")
    pats = RQ.random_patterns(5, 1, 8, seed=15)
    patt, plen = table.planner.encode(pats)
    before = table.planner.stats.as_dict()
    out = table.scan_batch(patt, plen, top_k=4)
    after = table.planner.stats
    assert out.count.shape == (5,) and out.positions.shape == (5, 4)
    assert after.queries - before["queries"] == 5
    assert after.pad_slots - before["pad_slots"] == 0
    assert after.bucketed_batches - before["bucketed_batches"] == 1
    assert after.bucketed_queries - before["bucketed_queries"] == 5
    want = table.scan(pats, top_k=4)
    assert (out.count == want.count).all()
    assert (out.positions == want.positions).all()
    rp, rl = rt.planner.encode(pats)
    _assert_same(out, rt.scan_batch(np.asarray(rp), np.asarray(rl),
                                    top_k=4))


# ---------------------------------------------------------------------------
# the metrics feed
# ---------------------------------------------------------------------------
def test_metrics_feed_rows_keep_the_reference_schema(tmp_path):
    """``start_metrics`` rows have the key set of the reference's
    ``table_record`` rows for the same table state, the reference's
    ``aggregate_metrics`` reads the port's feed, and the port's
    aggregator reads it the same way."""
    from repro.serving import metrics as RM
    from repro_torch.serving import metrics as TM
    rows = {}
    for pkg in PKGS:
        table = pkg.SuffixTable.from_codes(RC.random_dna(900, seed=16),
                                           is_dna=True, memtable_limit=300,
                                           **_kw(pkg))
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        table.start_metrics(path, interval_s=0, name="feed")
        table.count(["ACGT", "GG"])
        table.append(RC.random_dna(320, seed=17))
        table.count(["ACGT"])
        table.stop_metrics()
        table.start_metrics(path, interval_s=0)       # restarts, unnamed
        table.close()                                 # stops: final row
        rows[pkg.__name__] = TM.read_lines(path)
    got, want = rows[T.__name__], rows[R.__name__]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert set(g["stats"]) == set(w["stats"]) | {"device"}
        for k in ("role", "table", "queries"):
            assert g[k] == w[k], k
    assert got[0]["table"] == "feed" and got[1]["table"] is None
    ref_agg = RM.aggregate_metrics(str(tmp_path / f"{T.__name__}.jsonl"))
    port_agg = TM.aggregate_metrics(str(tmp_path / f"{T.__name__}.jsonl"))
    assert ref_agg == port_agg
    assert ref_agg["summary"]["tables"] == 2
    assert ref_agg["summary"]["queries"] == 2 * got[0]["queries"] > 0


def test_metrics_helpers_match_the_reference(tmp_path):
    """``LatencyWindow``, ``append_line``, ``read_lines`` (torn lines
    skipped) and ``aggregate_metrics`` over a mixed feed agree with the
    reference's copies."""
    from repro.serving import metrics as RM
    from repro_torch.serving import metrics as TM
    rng = np.random.default_rng(18)
    samples = rng.exponential(3.0, 700)
    windows = [TM.LatencyWindow(size=512), RM.LatencyWindow(size=512)]
    for w in windows:
        assert w.quantiles()["n"] == 0
        for x in samples:
            w.record(x)
    assert windows[0].quantiles() == windows[1].quantiles()
    assert windows[0].total == 700
    path = str(tmp_path / "metrics.jsonl")
    recs = [{"role": "worker", "tablet": t, "replica": 0, "pid": 10 + t,
             "queries": 5 * t, "p50_ms": 1.0 + t, "p95_ms": 2.0 + t,
             "rpcs": t, "shed": 0, "ts": float(t)} for t in range(3)]
    recs += [{"role": "router", "pid": 99, "hedge_fired": 2,
              "hedge_wins": 1, "failovers": 0, "quota_shed": 1, "ts": 5.0},
             TM.table_record("t", {"planner": {"queries": 7},
                                   "latency": {"total": {"p50_ms": 0.5}}})]
    for r in recs:
        TM.append_line(path, r)
    with open(path, "a") as f:
        f.write('{"torn": \n')
    assert len(TM.read_lines(path)) == len(RM.read_lines(path)) == 5
    assert TM.aggregate_metrics(path) == RM.aggregate_metrics(path)
    em = TM.MetricsEmitter(path, lambda: {"role": "table", "x": 1},
                           interval_s=0)
    em.stop()
    emitted = TM.read_lines(path)
    assert emitted[-1]["x"] == 1 and "ts" in emitted[-1]
