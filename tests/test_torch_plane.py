"""The port's serving plane (``repro_torch.serving.{rpc,tablet_server,
router,plane}`` and ``Database.connect_plane``) against the
single-process port table and against ``repro``'s plane over the SAME
root, at ``tests/test_plane.py``'s sizes, ``device="cpu"``.

One module-scoped fixture builds a staged port table (so the snapshot is
shard-streamed and each worker opens only its shards) with every LSM
tier populated (base + sealed run + memtable snapshot + a commit-log
tail), then deploys a 4-tablet x 2-replica port plane and a 4-tablet
``repro`` plane beside it.  Every answer must be EQUAL: counts,
``first_pos``, top-k positions, ``locate_range`` pages.  Process faults
(kill -9, restart + log replay) run against the port's fleet; the
hedging, failover and admission policies are pinned by in-process RPC
tests."""
import json
import os
import shutil
import signal
import tempfile
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import rpc as j_rpc  # noqa: E402
from repro.serving.plane import ServingPlane as JPlane  # noqa: E402
from repro.serving.plane import split_table as j_split  # noqa: E402
from repro.serving.tablet_server import \
    encode_pattern_rows as j_encode  # noqa: E402
from repro_torch.api import Database, Query  # noqa: E402
from repro_torch.core import query as Q  # noqa: E402
from repro_torch.serving import rpc  # noqa: E402
from repro_torch.serving.metrics import aggregate_metrics  # noqa: E402
from repro_torch.serving.plane import ServingPlane, split_table  # noqa: E402
from repro_torch.serving.router import (OverloadedError,  # noqa: E402
                                        RemoteTable, TabletRouter,
                                        TokenBucket, _RemoteOutcome,
                                        connect)
from repro_torch.serving.tablet_server import (  # noqa: E402
    TabletIndex, encode_pattern_rows)

N_TABLETS = 4
REPLICAS = 2
ALIAS = "dna@plane"          # the port's plane
REF = "dna@ref"              # repro's plane over the same root
PLANTED = "TTTTTTTTGGGGGGGG"


def _rand_pats(rng, n, lmin=1, lmax=24):
    return ["".join("ACGT"[c] for c in rng.integers(0, 4, size=int(L)))
            for L in rng.integers(lmin, lmax + 1, size=n)]


class PlaneEnv:
    def __init__(self, root, db, table, plane, remote, ref_plane,
                 ref_remote):
        self.root = root
        self.db = db
        self.table = table            # the live single-process oracle
        self.plane = plane
        self.remote = remote
        self.ref_plane = ref_plane
        self.ref_remote = ref_remote


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("plane") / "root")
    rng = np.random.default_rng(7)
    db = Database(root, device="cpu")
    table = db.create_table(
        "dna", rng.integers(0, 4, size=16000, dtype=np.uint8),
        is_dna=True, max_query_len=64, build_chunk_rows=3000)
    assert table.stats()["build"]["mode"] == "staged"
    for _ in range(2):
        db.append("dna", rng.integers(0, 4, size=500, dtype=np.uint8))
    table.minor_compact()
    db.append("dna", np.concatenate(
        [np.array([3] * 8 + [2] * 8, np.uint8),
         rng.integers(0, 4, size=300, dtype=np.uint8)]))
    table.flush()                                # publish the snapshot
    db.append("dna", np.concatenate(
        [rng.integers(0, 4, size=100, dtype=np.uint8),
         np.array([3] * 8 + [2] * 8, np.uint8)]))    # log tail only
    assert int(table.count([PLANTED])[0]) >= 2

    ref_plane = JPlane.deploy(root, "dna", N_TABLETS, replicas=1,
                              metrics_interval_s=0.5)
    ref_remote = ref_plane.remote_table()
    db.attach(REF, ref_remote)
    plane = ServingPlane.deploy(root, "dna", N_TABLETS, replicas=REPLICAS,
                                metrics_interval_s=0.5)
    remote = db.connect_plane("dna", attach_as=ALIAS)
    yield PlaneEnv(root, db, table, plane, remote, ref_plane, ref_remote)
    plane.stop()
    ref_plane.stop()
    ref_remote.close()
    db.close()


def _assert_same(a, b, fields=("count", "first_pos", "positions", "found")):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert np.array_equal(np.asarray(x), np.asarray(y)), f


# ---------------------------------------------------------------------------
# equal answers across the typed Query surface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("top_k", [0, 8])
def test_scan_equal_to_table_and_reference_plane(env, top_k):
    rng = np.random.default_rng(11 + top_k)
    pats = _rand_pats(rng, 150) + [PLANTED, "ACGT", "A"]
    local = env.table.scan(pats, top_k=top_k)
    routed = env.remote.scan(pats, top_k=top_k)
    _assert_same(local, routed)
    _assert_same(routed, env.ref_remote.scan(pats, top_k=top_k))
    assert int(local.count.sum()) > 0


@pytest.mark.parametrize("kind", ["count", "contains", "locate", "scan"])
def test_typed_queries_equal(env, kind):
    rng = np.random.default_rng(13)
    pats = _rand_pats(rng, 40) + [PLANTED]
    ctor = getattr(Query, kind)
    a = env.db.query(ctor("dna", pats))
    for name in (ALIAS, REF):
        b = env.db.query(ctor(name, pats))
        assert a.ok and b.ok
        _assert_same(a, b)


def test_raw_codes_query_equal(env):
    """Packed-uint32 DNA batches (the planner's raw encoding) route too."""
    pats = _rand_pats(np.random.default_rng(17), 32)
    _, packed, plen = Q.encode_patterns(pats, 64, device="cpu")
    rs = [env.db.query(Query(table=t, codes=packed.numpy(),
                             lens=plen.numpy()))
          for t in ("dna", ALIAS, REF)]
    assert all(r.ok for r in rs)
    for r in rs[1:]:
        _assert_same(rs[0], r, ("count", "first_pos"))


def test_read_session_pages_across_tablets(env):
    """Paged streaming crosses tablet boundaries with a resumable
    cursor: pages through either plane equal pages off the table."""
    pat = "ACG"
    local = [p.positions for p in env.db.read_rows("dna", pat,
                                                   page_size=16).pages()]
    assert np.array_equal(
        np.concatenate(local), env.table.locate_range(pat, limit=None))
    for name in (ALIAS, REF):
        sess = env.db.read_rows(name, pat, page_size=16)
        routed, cursor = [], None
        for i, page in enumerate(sess.pages()):
            routed.append(page.positions)
            if i == 2:
                cursor = page.cursor          # resume mid-stream below
        assert len(local) == len(routed)
        for a, b in zip(local, routed):
            assert np.array_equal(a, b)
        tail = np.concatenate([p.positions for p in
                               env.db.resume_read(cursor).pages()]
                              or [np.zeros(0, np.int64)])
        assert np.array_equal(tail, np.concatenate(routed[3:]))


@pytest.mark.parametrize("pat", ["ACGT", "A", "TTTTTTTTGGGG"])
def test_locate_range_merge(env, pat):
    full = env.table.locate_range(pat, after=-1, limit=None)
    for remote in (env.remote, env.ref_remote):
        assert np.array_equal(full, remote.locate_range(pat, after=-1,
                                                        limit=None))
        for after, limit in ((int(full[len(full) // 2]), 9), (-1, 1),
                             (int(full[-1]), 5)):
            assert np.array_equal(
                env.table.locate_range(pat, after=after, limit=limit),
                remote.locate_range(pat, after=after, limit=limit))


def test_encoder_parity(env):
    """The worker's numpy-only pattern encoder matches the reference's
    and the port planner's encoding symbol for symbol."""
    pats = _rand_pats(np.random.default_rng(23), 20)
    rows, lens = encode_pattern_rows(pats)
    jrows, jlens = j_encode(pats)
    assert np.array_equal(rows, jrows) and np.array_equal(lens, jlens)
    codes, _packed, plens = Q.encode_patterns(pats, 64, device="cpu")
    for i, p in enumerate(pats):
        assert int(lens[i]) == int(plens[i])
        assert np.array_equal(rows[i, :len(p)], codes[i, :len(p)].numpy())
    with pytest.raises(ValueError, match="non-DNA"):
        encode_pattern_rows(["ACGN"])


def test_delta_match_equals_full_window_compare():
    """The owner's delta match finds exactly the windows of base + delta
    that equal the pattern and end in the delta
    (``n_base < g + L <= n_base + delta_len``), by brute force."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=300).astype(np.uint8)
    delta = rng.integers(0, 4, size=400).astype(np.uint8)
    idx = TabletIndex(codes=codes, sa_slice=np.zeros(0, np.int64),
                      rank_lo=0, rank_hi=0, delta_codes=delta,
                      max_query_len=16, is_dna=True, serves_delta=True)
    win = idx._window
    for L in (1, 2, 5, 15, 16):
        for _ in range(20):
            row = win[int(rng.integers(0, len(win) - L))
                      :][:L].astype(np.int32)
            text = np.concatenate([codes, delta]).astype(np.int32)
            want = [g for g in range(len(text) - L + 1)
                    if idx.n_base < g + L <= idx.n_base + len(delta)
                    and np.array_equal(text[g:g + L], row)]
            assert np.array_equal(idx.delta_positions_one(row, L),
                                  np.asarray(want, np.int64))


# ---------------------------------------------------------------------------
# crash / failover / restart; the owner's log replay
# ---------------------------------------------------------------------------
def _worker_stats(path, mod=rpc):
    client = mod.RpcClient(path)
    try:
        return client.call({"op": "stats"})["stats"]
    finally:
        client.close()


def test_kill9_failover_and_bitwise_restart(env):
    rng = np.random.default_rng(29)
    pats = _rand_pats(rng, 60) + [PLANTED]
    want = env.table.scan(pats, top_k=8)
    victim = 1
    sock = env.plane._sock_path(victim, 0)
    crc_before = _worker_stats(sock)["text_crc"]

    env.plane.kill(victim, 0, sig=signal.SIGKILL)
    assert not env.plane.alive(victim, 0)
    before = env.remote.router.failovers
    got = env.remote.scan(pats, top_k=8)       # the replica serves
    _assert_same(want, got)
    assert env.remote.router.failovers >= before

    env.plane.restart(victim, 0)
    assert env.plane.alive(victim, 0)
    # the restarted worker serves the same text: snapshot slice + log tail
    assert _worker_stats(sock)["text_crc"] == crc_before
    _assert_same(want, env.remote.scan(pats, top_k=8))


def test_owner_replays_wal_tail_as_the_reference(env):
    st = _worker_stats(env.plane._sock_path(N_TABLETS - 1, 0))
    assert st["serves_delta"] is True
    assert st["wal_records_replayed"] == 1
    assert st["delta_len"] == 2 * 500 + 316 + 116
    jst = _worker_stats(env.ref_plane._sock_path(N_TABLETS - 1, 0), j_rpc)
    for k in ("rank_lo", "rank_hi", "n_base", "serves_delta", "delta_len",
              "wal_records_replayed", "text_crc"):
        assert st[k] == jst[k], k


# ---------------------------------------------------------------------------
# the paper's workload through HedgedScanService over the plane
# ---------------------------------------------------------------------------
def _record_scans(monkeypatch, service_cls) -> list:
    """Every batch ``service_cls.scan`` answers from now on, as host
    arrays (packed patterns, lengths, found, count, first_pos)."""
    inner = service_cls.scan
    recorded = []

    def scan(self, patterns_packed, plen, hedged=True):
        res, lat = inner(self, patterns_packed, plen, hedged=hedged)
        recorded.append([np.asarray(v) for v in (
            patterns_packed, plen, res.found, res.count, res.first_pos)])
        return res, lat

    monkeypatch.setattr(service_cls, "scan", scan)
    return recorded


@pytest.mark.parametrize("hedged", [False, True])
def test_hedged_scan_service_over_the_plane(env, monkeypatch, hedged):
    """``HedgedScanService`` serves a ``RemoteTable`` as the reference's
    does: no planner, the pattern cap from ``max_query_len``, the
    router's real hedging toggled per call and restored after it.  The
    statistics of 200 queries in batches of 50, and every answer
    (``found``, ``count``, ``first_pos``), equal the reference service's
    over the reference's plane, on the same seeds (wall latencies are
    not compared)."""
    from repro.api import Database as JDatabase
    from repro.serving import HedgedScanService as JService
    from repro_torch.serving import HedgedScanService
    ours_rec = _record_scans(monkeypatch, HedgedScanService)
    ref_rec = _record_scans(monkeypatch, JService)

    router = env.remote.router
    fired = []
    call_hedged = router._call_hedged
    monkeypatch.setattr(router, "_call_hedged",
                        lambda *a: fired.append(a) or call_hedged(*a))
    assert router.hedge_enabled
    svc = HedgedScanService(env.remote, database=env.db)
    assert svc.is_remote and svc.planner is None and svc.table_name == ALIAS
    kw = dict(batch=50, max_len=64, hedged=hedged, seed=5)
    ours = svc.run_workload(200, **kw)
    assert router.hedge_enabled                 # restored after each call
    assert bool(fired) == hedged                # toggled during it
    with pytest.raises(ValueError, match="pattern cap 64"):
        svc.run_workload(10, max_len=65)

    jdb = JDatabase.in_memory()
    try:
        ref = JService(env.ref_remote, database=jdb).run_workload(200, **kw)
    finally:
        jdb.close()
    assert ours["n"] == 200
    for k in ("n", "hit_rate", "mean_len", "corr_len_outcome"):
        assert ours[k] == ref[k], k
    assert 0.0 < ours["hit_rate"] < 1.0
    assert len(ours_rec) == len(ref_rec) == 4
    for k, name in enumerate(("patterns", "plen", "found", "count",
                              "first_pos")):
        got = np.concatenate([r[k] for r in ours_rec])
        want = np.concatenate([r[k] for r in ref_rec])
        np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
def test_tenant_quota_sheds_typed_overloaded(env):
    env.remote.router.set_quota("abuser", rate_per_s=1.0, burst=8.0)
    pats = ["ACGT"] * 4
    want = int(env.table.count(["ACGT"])[0])
    shed = ok = 0
    for _ in range(8):
        r = env.db.query(Query.count(ALIAS, pats, tenant="abuser"))
        if r.overloaded:
            shed += 1
            assert "OVERLOADED" in r.error
        else:
            ok += 1
            assert int(r.count[0]) == want
    assert shed >= 1 and ok >= 1          # burst admits, then the shed
    r = env.db.query(Query.count(ALIAS, pats, tenant="good"))
    assert r.ok and not r.overloaded
    assert env.db.scheduler.stats.shed >= 1


def test_metrics_feed_and_varz(env):
    path = os.path.join(env.root, "dna", "metrics.jsonl")
    deadline = time.time() + 10
    while time.time() < deadline:
        agg = aggregate_metrics(path)
        if agg["summary"]["workers"] >= N_TABLETS * REPLICAS:
            break
        time.sleep(0.25)
    s = agg["summary"]
    assert s["tablets"] == N_TABLETS
    assert s["queries"] > 0
    assert s["wal_records_replayed"] >= 1
    assert all("p95_ms" in r for r in agg["latest"]
               if r.get("role") == "worker")
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    assert all("ts" in r for r in recs)


# ---------------------------------------------------------------------------
# in-process policy units: framing, buckets, hedge, failover, shed
# ---------------------------------------------------------------------------
def test_rpc_frame_roundtrip_and_reference_wire():
    msg = {"op": "scan", "top_k": 3, "note": "héllo",
           "rows": np.arange(12, dtype=np.int32).reshape(3, 4),
           "lens": np.array([4, 2, 1], np.int64)}
    frame = rpc.encode_message(msg)
    assert frame == j_rpc.encode_message(msg)     # the reference's bytes
    for dec in (rpc.decode_message, j_rpc.decode_message):
        out = dec(frame[4:])
        assert out["op"] == "scan" and out["top_k"] == 3
        assert out["note"] == "héllo"
        assert np.array_equal(out["rows"], msg["rows"])
        assert out["rows"].dtype == np.int32
        assert np.array_equal(out["lens"], msg["lens"])


def test_token_bucket():
    b = TokenBucket(rate_per_s=1000.0, burst=3.0)
    assert b.try_acquire(3)
    assert not b.try_acquire(1)         # drained
    time.sleep(0.01)
    assert b.try_acquire(1)             # refilled at 1000/s
    with pytest.raises(ValueError):
        TokenBucket(rate_per_s=0.0, burst=1.0)


@pytest.fixture
def sock_dir():
    """A short socket dir under /tmp (AF_UNIX paths cap at ~108 bytes)."""
    d = tempfile.mkdtemp(prefix="saplane-test-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _one_tablet_manifest():
    return {"table": "t", "step": 0, "table_version": 1, "is_dna": True,
            "max_query_len": 8, "n_base": 0, "key_len": 4,
            "n_tablets": 1,
            "tablets": [{"id": 0, "rank_lo": 0, "rank_hi": 0, "key": []}]}


def test_hedge_fires_and_backup_wins(sock_dir):
    d = sock_dir
    slow = rpc.RpcServer(os.path.join(d, "a.sock"), lambda m: (
        time.sleep(0.4), {"status": "ok", "who": 0})[1])
    fast = rpc.RpcServer(os.path.join(d, "b.sock"),
                         lambda m: {"status": "ok", "who": 1})
    try:
        r = TabletRouter(_one_tablet_manifest(),
                         [[slow.path, fast.path]], hedge_deadline_ms=40)
        reply = r._call_tablet(0, {"op": "x"})
        assert reply["who"] == 1            # backup won the race
        assert r.hedge_fired == 1 and r.hedge_wins == 1
        assert "hedge_wait" in r.stats()["latency"]
        r.close()
    finally:
        slow.stop()
        fast.stop()


def test_failover_on_dead_primary(sock_dir):
    d = sock_dir
    alive = rpc.RpcServer(os.path.join(d, "b.sock"),
                          lambda m: {"status": "ok", "who": 1})
    try:
        r = TabletRouter(_one_tablet_manifest(),
                         [[os.path.join(d, "dead.sock"), alive.path]],
                         hedge_enabled=False)
        assert r._call_tablet(0, {"op": "x"})["who"] == 1
        assert r.failovers == 1
        r.close()
        r = TabletRouter(_one_tablet_manifest(),
                         [[os.path.join(d, "dead.sock")]])
        with pytest.raises(rpc.RpcError, match="every replica"):
            r._call_tablet(0, {"op": "x"})
        r.close()
    finally:
        alive.stop()


def test_all_replicas_shedding_raises_overloaded(sock_dir):
    d = sock_dir
    gate = threading.Event()

    def stuck(m):
        gate.wait(5.0)
        return {"status": "ok"}

    srv = rpc.RpcServer(os.path.join(d, "a.sock"), stuck, max_inflight=1)
    try:
        r = TabletRouter(_one_tablet_manifest(), [[srv.path]],
                         hedge_enabled=False)
        occupier = threading.Thread(
            target=lambda: r._call_tablet(0, {"op": "x"}), daemon=True)
        occupier.start()
        deadline = time.time() + 2
        while srv.queue_depth == 0 and time.time() < deadline:
            time.sleep(0.005)
        with pytest.raises(OverloadedError) as ei:
            r._call_tablet(0, {"op": "x"})   # queue full -> typed shed
        assert str(ei.value).startswith("OVERLOADED")
        assert srv.shed_count >= 1
        gate.set()
        occupier.join(timeout=5)
        assert not occupier.is_alive()
        r.close()
    finally:
        gate.set()
        srv.stop()


def test_scheduler_runs_remote_tables_concurrently():
    """supports_concurrent_scans bypasses the per-table dispatch lock —
    two callers must be able to overlap inside scan() (a barrier would
    time out if the scheduler serialized them)."""

    class FakeRemote:
        supports_concurrent_scans = True
        is_remote = True
        barrier = threading.Barrier(2, timeout=5.0)

        def scan(self, pats, top_k=0):
            self.barrier.wait()
            B = len(pats)
            z = np.zeros(B, np.int64)
            return _RemoteOutcome(z > 0, z, np.full(B, -1, np.int64), None)

    db = Database.in_memory()
    db.attach("r", FakeRemote())
    errs = []

    def call():
        r = db.query(Query.count("r", ["ACGT"]))
        if not r.ok:
            errs.append(r.error)

    ts = [threading.Thread(target=call) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
        assert not t.is_alive()
    assert errs == []
    db.close()


# ---------------------------------------------------------------------------
# split / catalog / lifecycle
# ---------------------------------------------------------------------------
def test_split_table_manifest_equals_reference(env):
    path = os.path.join(env.root, "dna", "tablets", "manifest.json")
    with open(path) as f:
        m = json.load(f)
    assert m["n_tablets"] == N_TABLETS
    assert m["tablets"][0]["rank_lo"] == 0
    assert m["tablets"][-1]["rank_hi"] == m["n_base"] == 16000
    for a, b in zip(m["tablets"], m["tablets"][1:]):
        assert a["rank_hi"] == b["rank_lo"]        # contiguous cover
    # both packages cut the same map (and rewrite it unchanged)
    assert j_split(env.root, "dna", N_TABLETS) == m
    assert split_table(env.root, "dna", N_TABLETS) == m
    for key_len in (1, 8):
        got = split_table(env.root, "dna", 3, key_len=key_len)
        assert got == j_split(env.root, "dna", 3, key_len=key_len)
    split_table(env.root, "dna", N_TABLETS)        # restore the live map
    with pytest.raises(ValueError):
        split_table(env.root, "dna", 0)


def test_split_rejects_frozen(tmp_path):
    root = str(tmp_path / "root")
    db = Database(root, device="cpu")
    db.create_table("f", np.random.default_rng(0).integers(
        0, 4, size=2000, dtype=np.uint8), is_dna=True)
    db.freeze("f")
    with pytest.raises(RuntimeError, match="frozen"):
        split_table(root, "f", 2)
    db.close()


def test_catalog_reconcile_keeps_plane_dirs(env):
    from repro_torch.api.catalog import Catalog
    cat = Catalog(env.root)                      # reconciles on init
    assert "dna" in cat
    assert os.path.exists(os.path.join(env.root, "dna", "tablets",
                                       "manifest.json"))
    assert os.path.exists(os.path.join(env.root, "dna", "metrics.jsonl"))
    ghost = os.path.join(env.root, "ghost")
    os.makedirs(os.path.join(ghost, "tablets"))
    open(os.path.join(ghost, "metrics.jsonl"), "w").close()
    removed = Catalog(env.root).reconcile()
    assert not os.path.exists(ghost) or "ghost" in removed


def test_remote_table_rejects_overlong_pattern(env):
    with pytest.raises(ValueError, match="max_query_len"):
        env.remote.scan(["A" * 65])
    with pytest.raises(ValueError, match="limit"):
        env.remote.locate_range("A", limit=0)


def test_connect_helper_from_disk(env):
    """A second client process would connect from the published
    manifest + serving.json alone — same answers."""
    rt = connect(env.root, "dna")
    try:
        pats = ["ACGT", PLANTED]
        assert np.array_equal(env.table.scan(pats).count,
                              rt.scan(pats).count)
        assert rt.stats()["remote"] is True
    finally:
        rt.close()
    assert isinstance(rt, RemoteTable)


def test_connect_plane_needs_a_root_and_a_free_alias(env):
    mem = Database.in_memory()
    with pytest.raises(RuntimeError, match="catalog root"):
        mem.connect_plane("dna")
    mem.close()
    with pytest.raises(ValueError, match="already attached"):
        env.db.connect_plane("dna", attach_as=ALIAS)
