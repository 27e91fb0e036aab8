"""Serving launcher — the paper's workload end-to-end, through the
client; the port of ``repro.launch.serve``::

    PYTHONPATH=src python -m repro_torch.launch.serve --text-len 200000 \
        --queries 10000 --batch 512 --coalesce-window 2.0

Opens a ``repro_torch.api.Database`` handle (one catalog root, many
named tables) and serves batched random-pattern scans through
``HedgedScanService``: every batch is a typed ``Query`` routed by table
name, coalesced by the shared ``QueryScheduler`` and searched on the
table's device (``--device``, ``cuda`` unless told otherwise).  Prints
the paper's Table III/IV statistics with and without hedged reads, then
the client surface: cross-caller coalescing over two tables
(``[client]``), ``locate`` (``[locate]``), paged ``ReadSession``
streaming (``[stream]``), the write path (append, minor and major
compaction: ``[write ]``) and the table's ``stats()`` schema.  The
printed lines are the reference's.

Pass ``--root DIR`` to persist: the first run creates ``--table`` under
DIR, later runs re-open it (no rebuild) and replay its commit log
(``[wal  ] recovered``).  ``--metrics-interval`` streams the table's
``stats()`` tree into ``root/<table>/metrics.jsonl``; ``--dump-stats``
aggregates that feed and exits without importing torch.

``--max-device-bytes`` / ``--spill-dir`` with ``--root`` build the
table out of core under that device budget (``[build ] mode=staged``).
``--tablets N`` with ``--root`` range-splits the table after the write
demo and serves it from N tablet worker processes (x
``--plane-replicas``), answering the same typed queries through the
router (``[plane ]``).

``--host-devices N`` serves over N tablets (``REPRO_TORCH_HOST_DEVICES``,
set before any table resolves its mesh; ``launch.mesh``): N x ``cpu``
with ``--device cpu``, N tablets round-robin over the cards on
``cuda``.  Not carried over from the reference: ``--tuned`` (it sets
TF/XLA environment only).
"""
from __future__ import annotations

import argparse
import os
import time


def _dump_stats(args) -> None:
    """The /varz snapshot: aggregate root/<table>/metrics.jsonl and
    print fleet totals + the latest line per emitter (no torch)."""
    from repro_torch.serving.metrics import aggregate_metrics
    if args.root is None:
        print("[varz  ] --dump-stats needs --root (metrics.jsonl lives "
              "in the table's catalog dir)")
        return
    path = os.path.join(args.root, args.table, "metrics.jsonl")
    agg = aggregate_metrics(path)
    s = agg["summary"]
    print(f"[varz  ] table={args.table} emitters={s['emitters']} "
          f"workers={s['workers']} tablets={s['tablets']} "
          f"tables={s['tables']}")
    print(f"[varz  ] queries={s['queries']} rpcs={s['rpcs']} "
          f"shed_worker={s['shed_worker']} shed_quota={s['shed_quota']} "
          f"hedge_fired={s['hedge_fired']} hedge_wins={s['hedge_wins']} "
          f"failovers={s['failovers']} "
          f"wal_replayed={s['wal_records_replayed']}")
    print(f"[varz  ] queue_depth={s['queue_depth']} "
          f"p50_ms_median={s['p50_ms_median']} "
          f"p95_ms_max={s['p95_ms_max']}")
    for rec in agg["latest"]:
        role = rec.get("role", "worker")
        if role == "worker":
            print(f"[varz  ] worker t{rec.get('tablet')}r"
                  f"{rec.get('replica')} pid={rec.get('pid')} "
                  f"queries={rec.get('queries')} shed={rec.get('shed')} "
                  f"p50={rec.get('p50_ms')} p95={rec.get('p95_ms')} "
                  f"crc={rec.get('text_crc')}")
        elif role == "table":
            # in-process emitter (SuffixTable.start_metrics): same row
            # schema, full stats() tree under "stats"
            tiers = (rec.get("stats") or {}).get("tiers") or {}
            print(f"[varz  ] table-proc {rec.get('table')} "
                  f"pid={rec.get('pid')} queries={rec.get('queries')} "
                  f"p50={rec.get('p50_ms')} p95={rec.get('p95_ms')} "
                  f"p99={rec.get('p99_ms')} "
                  f"base={tiers.get('base_rows')} "
                  f"runs={tiers.get('run_count')} "
                  f"frozen={tiers.get('frozen')}")
        else:
            print(f"[varz  ] router pid={rec.get('pid')} "
                  f"rpcs={rec.get('rpcs')} "
                  f"hedge={rec.get('hedge_fired')}/"
                  f"{rec.get('hedge_wins')} "
                  f"failovers={rec.get('failovers')} "
                  f"quota_shed={rec.get('quota_shed')}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--text-len", type=int, default=200_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--max-pattern", type=int, default=100)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--capacity-factor", type=float, default=2.0)
    ap.add_argument("--top-k", type=int, default=5,
                    help="positions per query in the locate demo")
    ap.add_argument("--coalesce-window", type=float, default=2.0,
                    help="QueryScheduler micro-batch window in ms "
                         "(0 disables waiting, not coalescing)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="ReadSession page size in the streaming demo")
    ap.add_argument("--memtable-limit", type=int, default=None,
                    help="seal the memtable into an immutable run (minor "
                         "compaction) once it reaches this many symbols")
    ap.add_argument("--max-runs", type=int, default=None,
                    help="fold runs into the base (major compaction, "
                         "merge-based) once this many are live")
    ap.add_argument("--fm-threshold", type=int, default=None,
                    help="freeze the base tier onto the compressed "
                         "FM-index once it reaches this many symbols; "
                         "major compactions re-freeze automatically")
    ap.add_argument("--freeze", action="store_true",
                    help="freeze the main table explicitly right after "
                         "build/open (one-shot --fm-threshold)")
    ap.add_argument("--wal", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="write-ahead commit log for persistent tables: "
                         "appends are CRC-framed and fsync'd before the "
                         "ack, and reopen replays the log tail "
                         "(--no-wal restores the volatile pre-log path)")
    ap.add_argument("--group-commit-ms", type=float, default=0.0,
                    help="group-commit window: concurrent client appends "
                         "arriving within this many ms share ONE fsync "
                         "before acking (0 = fsync per append)")
    ap.add_argument("--max-device-bytes", type=int, default=None,
                    help="per-device build budget in bytes: create runs "
                         "the staged out-of-core pipeline with chunk_rows "
                         "= budget/24 instead of one in-memory sort "
                         "(needs --root)")
    ap.add_argument("--spill-dir", default=None,
                    help="spill the staged build's working arrays to "
                         "files under this dir instead of host RAM "
                         "(implies the staged pipeline; needs --root)")
    ap.add_argument("--root", default=None,
                    help="catalog root dir; omit for an in-memory table")
    ap.add_argument("--table", default="dna_serve",
                    help="table name under --root")
    ap.add_argument("--aux-table", default="dna_aux",
                    help="second table for the multi-table demo")
    ap.add_argument("--metrics-interval", type=float, default=1.0,
                    help="stream the table's full stats() tree into "
                         "root/<table>/metrics.jsonl every this many "
                         "seconds, the reference's feed schema, "
                         "aggregated by --dump-stats (0 = one final row "
                         "on close, negative = no feed; needs --root)")
    ap.add_argument("--device", default="cuda",
                    help="device the tables build and search on "
                         "(cpu: the kernels' plain versions)")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="serve over this many tablets of the table's "
                         "device type (sets REPRO_TORCH_HOST_DEVICES "
                         "before any table resolves its mesh; a CPU-only "
                         "box then runs the mesh scan paths for real)")
    ap.add_argument("--dump-stats", action="store_true",
                    help="print the /varz aggregation of the table's "
                         "metrics.jsonl serving feed and exit (no torch "
                         "import, no table open)")
    ap.add_argument("--tablets", type=int, default=0,
                    help="after the write demo, range-split the table "
                         "into this many tablets and serve them from "
                         "separate worker processes (needs --root)")
    ap.add_argument("--plane-replicas", type=int, default=1,
                    help="worker processes per tablet in the plane demo "
                         "(2+ enables real hedged reads + failover)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.dump_stats:
        return _dump_stats(args)

    if args.host_devices is not None:
        from repro_torch.launch.mesh import HOST_DEVICES_ENV
        os.environ[HOST_DEVICES_ENV] = str(args.host_devices)
        print(f"[tune  ] {HOST_DEVICES_ENV}={args.host_devices}")

    import numpy as np

    from repro_torch.api import Database, Query, SuffixTable
    from repro_torch.core.codec import decode_dna, random_dna
    from repro_torch.launch.mesh import visible_devices
    from repro_torch.serving import HedgedScanService

    n_dev = len(visible_devices(args.device))
    lsm = {"memtable_limit": args.memtable_limit, "max_runs": args.max_runs,
           "fm_threshold": args.fm_threshold}
    # durability knobs only make sense with a root (in-memory tables have
    # no log); open_kw reach every table this handle opens from disk — the
    # reopen path must honor --capacity-factor just like create does
    wal_kw = {"wal": args.wal, "group_commit_ms": args.group_commit_ms}
    open_kw = dict(lsm, capacity_factor=args.capacity_factor,
                   device=args.device, **wal_kw)
    db = Database(args.root, coalesce_window_ms=args.coalesce_window,
                  **(open_kw if args.root is not None else {}))

    t0 = time.time()
    if args.root is not None and args.table in db:
        print(f"[open ] table {args.table!r} from {args.root} "
              f"({n_dev} device(s)) ...", flush=True)
        table = db.table(args.table)
        print(f"[open ] v{table.version}, {len(table)} bases "
              f"({len(table.runs)} run(s)) in {time.time() - t0:.1f}s "
              f"(no rebuild, cf={table.capacity_factor})")
        rec = table.stats()["wal"]["recovery"]
        if rec is not None and (rec["records_replayed"]
                                or rec["torn_bytes"]):
            print(f"[wal  ] recovered: replayed="
                  f"{rec['records_replayed']} skipped="
                  f"{rec['records_skipped']} torn_bytes="
                  f"{rec['torn_bytes']} ({rec['reason']})")
    else:
        print(f"[build] suffix array over {args.text_len} bases "
              f"({n_dev} device(s)) ...", flush=True)
        codes = random_dna(args.text_len, seed=args.seed)
        # build-only knobs: they go to create_table ONLY — never into the
        # Database open_kw, which reach every later open() of the table
        build_kw = {}
        if args.max_device_bytes is not None:
            build_kw["max_device_bytes"] = args.max_device_bytes
        if args.spill_dir is not None:
            build_kw["spill_dir"] = args.spill_dir
        if args.root is None:
            if build_kw:
                print("[clamp ] --max-device-bytes/--spill-dir need "
                      "--root (staged builds persist shard-at-a-time); "
                      "building in-memory")
            table = db.attach(args.table, SuffixTable.from_codes(
                codes, is_dna=True, capacity_factor=args.capacity_factor,
                device=args.device, **lsm))
        else:
            table = db.create_table(
                args.table, codes, is_dna=True,
                capacity_factor=args.capacity_factor, device=args.device,
                **build_kw, **lsm, **wal_kw)
        dt = time.time() - t0
        print(f"[build] done in {dt:.1f}s "
              f"({args.text_len / max(dt, 1e-9) / 1e6:.2f} Mbase/s)")

    if args.freeze and not table.is_frozen:
        t1 = time.time()
        db.freeze(args.table)
        rb = table.stats()["tiers"]["resident_bytes"]
        print(f"[freeze] base tier -> FM-index in {time.time() - t1:.1f}s "
              f"(fm={rb['fm']}B, base_sa={rb['base_sa']}B)")

    # stream the in-process stats() tree into the reference's
    # metrics.jsonl feed: --dump-stats (and the reference's
    # check_regression.py --from-feed) aggregate it
    if args.root is not None and args.metrics_interval >= 0:
        mpath = os.path.join(args.root, args.table, "metrics.jsonl")
        table.start_metrics(mpath, interval_s=args.metrics_interval)
        print(f"[feed  ] stats() -> {mpath} "
              f"every {args.metrics_interval}s")

    # clamp to the table's pattern cap: run_workload validates up front
    max_pattern = min(args.max_pattern, table.max_query_len)
    if max_pattern < args.max_pattern:
        print(f"[clamp ] --max-pattern {args.max_pattern} -> {max_pattern} "
              f"(table max_query_len)")
    svc = HedgedScanService(table, replicas=args.replicas, database=db)
    for hedged in (False, True):
        stats = svc.run_workload(args.queries, batch=args.batch,
                                 max_len=max_pattern, hedged=hedged,
                                 seed=args.seed)
        mode = "hedged" if hedged else "single"
        print(f"[{mode:6s}] n={stats['n']} mean={stats['mean_ms']:.3f}ms "
              f"sd={stats['sd_ms']:.3f} min={stats['min_ms']:.2f} "
              f"max={stats['max_ms']:.1f} p99={stats['p99_ms']:.2f} "
              f"hit={stats['hit_rate']:.3f} "
              f"corr(len,t)={stats['corr_len_time']:.3f} "
              f"corr(len,hit)={stats['corr_len_outcome']:.3f}")

    # multi-table serving from one root: a second table next to the first,
    # and interleaved queries from simulated concurrent callers to BOTH
    # submitted through the one scheduler (cross-caller, cross-table
    # coalescing — each wave costs one scan per table, not one per
    # caller)
    if args.aux_table in db:
        aux = db.table(args.aux_table)
    elif args.root is not None:
        aux = db.create_table(args.aux_table,
                              random_dna(args.text_len // 4,
                                         seed=args.seed + 17), is_dna=True,
                              device=args.device, **wal_kw)
    else:
        aux = db.attach(args.aux_table, SuffixTable.from_codes(
            random_dna(args.text_len // 4, seed=args.seed + 17),
            is_dna=True, device=args.device))
    hot = ["ACGT", "GATTACA", "TTTT", "CCCCGGGG"]
    before = db.scheduler.stats.batches
    futs = [db.submit(Query.count(name, [p]))
            for p in hot for name in (args.table, args.aux_table)]
    waves = [f.result(timeout=30.0) for f in futs]
    s = db.scheduler.stats
    print(f"[client] {len(futs)} concurrent single-pattern callers over "
          f"2 tables -> {s.batches - before} dispatch(es) "
          f"(scheduler: submitted={s.submitted} coalesced="
          f"{s.coalesced_queries} max_batch={s.max_batch_patterns})")
    del aux, waves

    # match enumeration through typed queries + paged streaming
    if args.top_k > 0:
        out = db.query(Query.scan(args.table, hot[:3], top_k=args.top_k))
        for p, c, row in zip(hot[:3], out.count, out.positions):
            shown = [int(x) for x in row if x >= 0]
            print(f"[locate] {p!r}: count={int(c)} "
                  f"first_{args.top_k}={shown}")
    sess = db.read_rows(args.table, "ACGT", page_size=args.page_size)
    n_pages = n_pos = 0
    for page in sess.pages():
        n_pages += 1
        n_pos += int(page.positions.size)
    want = int(db.query(Query.count(args.table, ["ACGT"])).count[0])
    print(f"[stream] ReadRows('ACGT'): {n_pos} positions in {n_pages} "
          f"page(s) of <= {args.page_size} (one-shot count {want})")

    # the write path: append, merged read, minor compaction (seal to an
    # immutable run), then major compaction (merge-fold into the base)
    planted = "GATTACA" * 3
    before = int(table.count([planted])[0])
    table.append(planted + decode_dna(random_dna(993, seed=args.seed + 1)))
    after = int(table.count([planted])[0])
    n_runs = table.minor_compact()
    sealed = int(table.count([planted])[0])
    v = table.compact()
    print(f"[write ] append 1000 bases: count({planted[:10]}...) "
          f"{before} -> {after} (merged read); sealed into run "
          f"#{n_runs} (count still {sealed}); major-compacted to v{v}")

    # the serving plane: range-split into tablets, serve from separate
    # worker processes, answer the same typed queries through the router
    if args.tablets > 0:
        if args.root is None:
            print("[clamp ] --tablets needs --root (tablet workers serve "
                  "a persisted snapshot); skipping the plane demo")
        else:
            from repro_torch.serving.plane import ServingPlane
            t2 = time.time()
            with ServingPlane.deploy(args.root, args.table, args.tablets,
                                     replicas=args.plane_replicas,
                                     metrics_interval_s=1.0) as plane:
                alias = args.table + "@plane"
                remote = db.connect_plane(args.table, attach_as=alias)
                probe = hot + [planted, "A", "ACG"]
                local_r = db.query(Query.scan(args.table, probe, top_k=4))
                plane_r = db.query(Query.scan(alias, probe, top_k=4))
                same = (np.array_equal(local_r.count, plane_r.count)
                        and np.array_equal(local_r.first_pos,
                                           plane_r.first_pos)
                        and np.array_equal(local_r.positions,
                                           plane_r.positions))
                print(f"[plane ] {args.tablets} tablet(s) x "
                      f"{args.plane_replicas} replica(s) up in "
                      f"{time.time() - t2:.1f}s: routed scan identical="
                      f"{same} over {len(probe)} probes")
                rs = remote.router.stats()
                print(f"[plane ] router rpcs={rs['rpcs']} "
                      f"hedge_fired={rs['hedge_fired']} "
                      f"hedge_wins={rs['hedge_wins']} "
                      f"failovers={rs['failovers']} "
                      f"p50={rs['p50_ms']}ms p95={rs['p95_ms']}ms")
                del plane

    # the table's stats() schema, the reference's
    st = table.stats()
    print(f"[table ] {st['name'] or args.table} v{st['version']} "
          f"dna={st['is_dna']} cap={st['max_query_len']}")
    print(f"[tiers ] base={st['tiers']['base_rows']} "
          f"runs={st['tiers']['run_count']} "
          f"run_rows={st['tiers']['run_rows']} "
          f"memtable={st['tiers']['memtable_rows']}")
    b = st["build"]
    if b is not None:
        print(f"[build ] mode={b['mode']} rounds={b['rounds']} "
              f"chunks={b['n_chunks']}x{b['chunk_rows']} "
              f"peak_device_bytes={b['peak_device_bytes']} "
              f"spill_bytes={b['spill_bytes']} "
              f"bases_per_s={b['bases_per_s']:.0f}")
    rb = st["tiers"]["resident_bytes"]
    print(f"[bytes ] frozen={st['tiers']['frozen']} "
          f"base_sa={rb['base_sa']} fm={rb['fm']} "
          f"runs={rb['runs']} memtable={rb['memtable']} "
          f"text_device={rb['text_device']}")
    print(f"[cache ] entries={st['cache']['entries']} "
          f"hits={st['cache']['hits']} misses={st['cache']['misses']} "
          f"generation={st['cache']['generation']}")
    pl = st["planner"]
    print(f"[plan  ] batches={pl['batches']} queries={pl['queries']} "
          f"bucketed_batches={pl['bucketed_batches']} "
          f"pad_slots={pl['pad_slots']} modes={pl['mode_counts']} "
          f"retried={pl['retried_overflow']}/{pl['retried_saturated']}"
          f"/{pl['retried_inexact_rank']}")
    lat = st["latency"]
    if lat:
        spans = " ".join(
            f"{k}={v['p50_ms']}/{v['p95_ms']}/{v['p99_ms']}"
            for k, v in lat.items())
        print(f"[trace ] span p50/p95/p99 ms: {spans}")
    else:
        print("[trace ] no spans recorded")
    w = st["wal"]
    if w["enabled"]:
        print(f"[wal   ] seq={w['seq']} appends={w['log']['appends']} "
              f"fsyncs={w['log']['fsyncs']} seals={w['log']['seals']} "
              f"group_commit_ms={w['log']['group_commit_ms']}")
    else:
        print("[wal   ] disabled (in-memory table or --no-wal)")
    db.close()


if __name__ == "__main__":
    main()
