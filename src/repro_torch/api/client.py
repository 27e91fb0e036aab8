"""``repro_torch.api.client`` — the Bigtable-style client frontend, the
port of ``repro.api.client``.

* :class:`Database` — a handle over one :class:`~repro_torch.api.Catalog`
  root.  It routes typed queries by table name, lazily opens and caches
  tables, owns the :class:`QueryScheduler`, and is the only object a
  serving caller needs;
* :class:`Query` / :class:`QueryResult` — the typed request/response
  pair.  ``kind`` is one of ``count`` / ``contains`` / ``locate`` /
  ``scan``; patterns are strings or raw encoded code rows (numpy);
  ``top_k``, ``max_len`` and a per-query deadline ride along;
* :class:`QueryScheduler` — cross-caller micro-batch coalescing: N
  callers each submitting one pattern inside the coalesce window cost
  ONE table scan, and so one search launch on the card, not N;
* :class:`ReadSession` — the ``ReadRows`` analogue: a huge ``locate``
  enumeration streams back in bounded pages with a resumable
  continuation cursor (positions are global text offsets, so cursors
  survive minor and major compactions).

Semantics: every path funnels into ``SuffixTable.scan`` /
``scan_batch``, so coalesced results are bit-identical to per-call
results.  ``Database.connect_plane`` routes a table through its
multi-process serving plane (``repro_torch.serving.plane``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Iterator, Optional, Sequence, Union

import numpy as np

from repro_torch.api.catalog import Catalog
from repro_torch.api.table import SuffixTable
from repro_torch.core.planner import ScanOutcome
from repro_torch.serving.trace import Tracer

QUERY_KINDS = ("count", "contains", "locate", "scan")


# ---------------------------------------------------------------------------
# typed request / response
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Query:
    """One typed read request against a named table.

    Exactly one of ``patterns`` (strings, encoded by the table) or
    ``codes`` + ``lens`` (a pre-encoded batch in the table's store
    encoding: packed uint32 DNA words or int32 code rows) must be given.

    ``kind`` picks the payload of :attr:`QueryResult.value`:
    ``count`` → exact counts, ``contains`` → membership, ``locate`` →
    the ``top_k`` smallest positions, ``scan`` → the full result.
    ``max_len`` rejects over-long patterns at construction (the table
    cap still applies at execution); ``deadline_ms`` bounds how long the
    query may wait in the scheduler queue before execution starts —
    an expired query gets an error result, never a silent stale answer.
    ``tenant`` names the quota account the query is charged to when the
    table meters admission (an ``admit`` method, as the reference's
    routed ``RemoteTable`` has); unmetered tables ignore it.
    """
    table: str
    kind: str = "scan"
    patterns: Optional[tuple] = None
    codes: Optional[np.ndarray] = None
    lens: Optional[np.ndarray] = None
    top_k: int = 0
    max_len: Optional[int] = None
    deadline_ms: Optional[float] = None
    tenant: Optional[str] = None

    def __post_init__(self):
        if self.kind not in QUERY_KINDS:
            raise ValueError(f"kind must be one of {QUERY_KINDS}, "
                             f"got {self.kind!r}")
        if (self.patterns is None) == (self.codes is None):
            raise ValueError("exactly one of patterns= (strings) or "
                             "codes=+lens= (encoded rows) must be given")
        if self.patterns is not None:
            pats = tuple(self.patterns)
            if not pats:
                raise ValueError("empty pattern list")
            if not all(isinstance(p, str) for p in pats):
                raise TypeError("patterns must be strings; pass encoded "
                                "batches via codes=/lens=")
            object.__setattr__(self, "patterns", pats)
        else:
            if self.lens is None:
                raise ValueError("codes= requires lens= (per-row lengths)")
            codes = np.asarray(self.codes)
            lens = np.asarray(self.lens)
            if codes.ndim != 2 or lens.ndim != 1 \
                    or codes.shape[0] != lens.shape[0]:
                raise ValueError(
                    f"codes must be (B, W) with lens (B,); got "
                    f"{codes.shape} / {lens.shape}")
            if codes.shape[0] == 0:
                raise ValueError("empty encoded batch")
            object.__setattr__(self, "codes", codes)
            object.__setattr__(self, "lens", lens)
        if self.max_len is not None:
            too_long = (max(len(p) for p in self.patterns)
                        if self.patterns is not None
                        else int(np.max(self.lens)))
            if too_long > self.max_len:
                raise ValueError(f"pattern length {too_long} exceeds this "
                                 f"query's max_len={self.max_len}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.kind == "locate" and self.top_k == 0:
            object.__setattr__(self, "top_k", 8)

    @property
    def num_patterns(self) -> int:
        return (len(self.patterns) if self.patterns is not None
                else int(self.codes.shape[0]))

    # -- convenience constructors -------------------------------------------
    @classmethod
    def count(cls, table: str, patterns: Sequence[str], **kw) -> "Query":
        return cls(table=table, kind="count", patterns=tuple(patterns), **kw)

    @classmethod
    def contains(cls, table: str, patterns: Sequence[str], **kw) -> "Query":
        return cls(table=table, kind="contains", patterns=tuple(patterns),
                   **kw)

    @classmethod
    def locate(cls, table: str, patterns: Sequence[str], top_k: int = 8,
               **kw) -> "Query":
        return cls(table=table, kind="locate", patterns=tuple(patterns),
                   top_k=top_k, **kw)

    @classmethod
    def scan(cls, table: str, patterns: Sequence[str], top_k: int = 0,
             **kw) -> "Query":
        return cls(table=table, kind="scan", patterns=tuple(patterns),
                   top_k=top_k, **kw)


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Typed response: always exact, merged over every LSM tier.

    ``positions`` rows follow the table's text-order semantics (the
    ``top_k`` smallest occurrence positions, ascending, −1-padded).
    ``batch_size`` is the number of patterns in the coalesced batch this
    query actually rode in (== ``num_patterns`` for an uncoalesced
    call); ``wait_ms`` is the time it spent queued before execution.
    A deadline expiry or execution failure sets ``error`` (arrays are
    then empty) — check :attr:`ok` or use :attr:`value`, which raises.
    """
    kind: str
    found: np.ndarray                      # (B,)  bool
    count: np.ndarray                      # (B,)  int64
    first_pos: np.ndarray                  # (B,)  int64
    positions: Optional[np.ndarray]        # (B, top_k) int64 | None
    batch_size: int = 0
    wait_ms: float = 0.0
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def overloaded(self) -> bool:
        """True when the query was SHED by admission control — a tenant
        quota or a saturated worker fleet — rather than failed.  Shed is
        a typed, retryable outcome: the caller should back off, not
        treat the answer as wrong."""
        return self.error is not None and "OVERLOADED" in self.error

    @property
    def value(self):
        """The kind-appropriate payload; raises on an error result."""
        if self.error is not None:
            raise RuntimeError(f"query failed: {self.error}")
        if self.kind == "count":
            return self.count
        if self.kind == "contains":
            return self.found
        if self.kind == "locate":
            return self.positions
        return self


def _error_result(query: Query, message: str,
                  wait_ms: float = 0.0) -> QueryResult:
    z = np.zeros((0,), np.int64)
    return QueryResult(kind=query.kind, found=z.astype(bool), count=z,
                       first_pos=z, positions=None, batch_size=0,
                       wait_ms=wait_ms, error=message)


class QueryFuture:
    """Handle for a submitted query; ``result()`` blocks until set."""

    __slots__ = ("_event", "_result")

    def __init__(self):
        self._event = threading.Event()
        self._result: Optional[QueryResult] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> QueryResult:
        if not self._event.wait(timeout):
            raise TimeoutError("query result not ready")
        return self._result

    def _set(self, result: QueryResult) -> None:
        self._result = result
        self._event.set()


# ---------------------------------------------------------------------------
# the coalescing scheduler
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SchedulerStats:
    """Counters for the coalescing frontend (``Database.stats()``)."""
    submitted: int = 0            # queries accepted (submit + inline)
    executed: int = 0             # queries that ran to a result
    batches: int = 0              # group executions (device dispatches)
    coalesced_queries: int = 0    # queries that shared a batch with others
    max_batch_patterns: int = 0   # largest coalesced pattern batch seen
    deadline_expired: int = 0
    errors: int = 0
    fast_path_queries: int = 0    # ran inline, bypassing the window
    shed: int = 0                 # rejected by admission (quota/overload)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Pending:
    query: Query
    future: QueryFuture
    t_submit: float


class QueryScheduler:
    """Coalesces concurrent queries from many callers and tables.

    The first query to arrive opens a coalesce window of ``window_ms``;
    everything submitted before it closes (or before ``max_batch``
    queries accumulate) is drained as one wave, grouped by (table,
    encoding), and each group executes as a SINGLE table scan through
    ``SuffixTable.scan`` / ``scan_batch``.
    Queries whose ``deadline_ms`` expired while queued get an error
    result instead of running — and the window never waits past the
    earliest live deadline.

    ``window_ms=0`` still coalesces whatever is queued at drain time
    (submissions racing the drain), it just never waits for more.  The
    worker thread starts lazily on the first :meth:`submit` and exits on
    :meth:`close` after draining the queue.

    **Adaptive window** (``adaptive=True``, the default): ``window_ms``
    becomes a CEILING, not a constant price.  The scheduler keeps an
    EWMA of observed inter-arrival gaps and

    * under LOW load (average gap >= ``fastpath_gap_ms``, i.e. waiting
      would not find a peer to coalesce with) a submit with an idle
      queue executes INLINE on the caller thread — no window, no worker
      hop (``stats.fast_path_queries``);
    * otherwise the drain closes once the queue has been quiet for
      ``~2x`` the average gap (capped at ``window_ms``) instead of
      sleeping out the rest of the window — a lone straggler stops
      paying the full window for peers that never arrive, while a
      saturating caller population (gap << window) still fills whole
      waves and keeps the coalesced-throughput win.

    ``adaptive=False`` restores the fixed-window behavior exactly.
    """

    def __init__(self, resolve_table, *, window_ms: float = 2.0,
                 max_batch: int = 1024, adaptive: bool = True,
                 fastpath_gap_ms: Optional[float] = None):
        if window_ms < 0 or max_batch < 1:
            raise ValueError(f"need window_ms >= 0 and max_batch >= 1, got "
                             f"window_ms={window_ms} max_batch={max_batch}")
        self._resolve = resolve_table          # name -> SuffixTable
        self.window_ms = float(window_ms)
        self.max_batch = int(max_batch)
        self.adaptive = bool(adaptive)
        # gap above which a query would (on average) close its window
        # alone — waiting buys nothing, so the fast path takes over
        self.fastpath_gap_ms = (max(self.window_ms, 0.5)
                                if fastpath_gap_ms is None
                                else float(fastpath_gap_ms))
        self._ewma_gap_ms: Optional[float] = None   # arrival-gap EWMA
        self._last_arrival: Optional[float] = None
        self._window_current_ms = self.window_ms    # exported in stats
        self._busy = 0                 # waves executing right now
        self.stats = SchedulerStats()
        # span histograms (stats_snapshot()["latency"]): coalesce_wait,
        # admission, execute
        self.tracer = Tracer("client")
        self._cv = threading.Condition()
        # one lock PER TABLE OBJECT serializes that table's scans and
        # client-side writes: the worker thread draining windowed waves
        # and inline execute_now() callers would otherwise scan the same
        # table (and its caches/stats) concurrently, and a write landing
        # mid-scan would tear the multi-tier view.  Keyed per table so a
        # slow write/compaction on one table never stalls serving of the
        # others.  Coalescing is the concurrency story; dispatches to
        # any single table are serial.
        self._table_locks: dict[int, threading.Lock] = {}
        self._pending: list[_Pending] = []
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- adaptive window ------------------------------------------------------
    def _note_arrival(self, now: float) -> None:
        """Fold one submit into the arrival-gap EWMA and refresh the
        current window size (call with ``_cv`` held)."""
        if self._last_arrival is not None:
            gap_ms = (now - self._last_arrival) * 1e3
            a = 0.25
            self._ewma_gap_ms = (gap_ms if self._ewma_gap_ms is None
                                 else (1 - a) * self._ewma_gap_ms + a * gap_ms)
        self._last_arrival = now
        if not self.adaptive:
            return
        if self._ewma_gap_ms is None:
            self._window_current_ms = self.window_ms
        elif self._ewma_gap_ms >= self.fastpath_gap_ms:
            self._window_current_ms = 0.0      # low load: don't wait at all
        else:
            # quiet for ~2 average gaps => nobody else is coming.  Floored
            # at 0.5 ms: saturated submitters (gap ~ microseconds) stall
            # for that long on GC/GIL hiccups, and closing the window on
            # one would split the wave into fragment batches, each a
            # launch of its own.
            self._window_current_ms = min(self.window_ms,
                                          max(0.5, 2.0 * self._ewma_gap_ms))

    def _fast_path_ok(self) -> bool:
        """Inline execution beats windowing: queue idle, nothing mid-
        drain, and arrivals too sparse for coalescing to find a peer
        (call with ``_cv`` held)."""
        return (self.adaptive and not self._pending and self._busy == 0
                and (self._ewma_gap_ms is None
                     or self._ewma_gap_ms >= self.fastpath_gap_ms))

    # -- async path ----------------------------------------------------------
    def submit(self, query: Query) -> QueryFuture:
        """Enqueue for the current coalesce window; returns a future.
        Under adaptive low load the query instead executes inline on the
        calling thread (the window would buy nothing) — the future is
        already resolved when it returns."""
        fut = QueryFuture()
        now = time.perf_counter()
        pend = _Pending(query, fut, now)
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self.stats.submitted += 1
            self._note_arrival(now)
            if self._fast_path_ok():
                self.stats.fast_path_queries += 1
                self._busy += 1
                inline = True
            else:
                inline = False
                self._pending.append(pend)
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._loop, name="query-scheduler",
                        daemon=True)
                    self._thread.start()
                self._cv.notify_all()
        if inline:
            try:
                self._execute([pend])
            finally:
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()
        return fut

    def _deadline_of(self, wave_open: float) -> float:
        """Absolute drain time: window close (adaptive: or the queue
        going quiet for the current window), capped by the earliest
        per-query deadline among pending queries."""
        t = wave_open + self.window_ms / 1e3
        if self.adaptive and self._last_arrival is not None:
            t = min(t, self._last_arrival + self._window_current_ms / 1e3)
        for p in self._pending:
            if p.query.deadline_ms is not None:
                t = min(t, p.t_submit + p.query.deadline_ms / 1e3)
        return t

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                wave_open = self._pending[0].t_submit
                while (not self._closed
                       and len(self._pending) < self.max_batch):
                    now = time.perf_counter()
                    left = self._deadline_of(wave_open) - now
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                wave = self._pending[:self.max_batch]
                del self._pending[:len(wave)]
                self._busy += 1
            try:
                self._execute(wave)
            finally:
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()

    def _lock_for(self, table):
        # tables that fan work out to OTHER processes (the reference's
        # RemoteTable) are safe, and meant, to scan concurrently:
        # serializing their dispatches behind one lock would collapse a
        # plane back to single-worker throughput, so they get a no-op
        # guard
        if getattr(table, "supports_concurrent_scans", False):
            return contextlib.nullcontext()
        with self._cv:
            lock = self._table_locks.get(id(table))
            if lock is None:
                lock = self._table_locks[id(table)] = threading.Lock()
            return lock

    def run_exclusive(self, table, fn):
        """Run ``fn()`` while no query batch is executing against
        ``table`` (the object, not the name — aliased registrations
        share one lock) — the hook client-side writes and paged reads
        use so a mutation never lands mid-scan (a seal between the base
        pass and the delta fan-out would double-count the sealed rows)."""
        with self._lock_for(table):
            return fn()

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting queries, drain the queue, join the worker."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout)

    # -- sync path (inline coalescing, no window wait) -----------------------
    def execute_now(self, queries: Sequence[Query]) -> list[QueryResult]:
        """Run ``queries`` as one coalesced wave on the calling thread —
        the inline path ``Database.query``/``query_many`` use.  Grouping
        and results are identical to the windowed path."""
        now = time.perf_counter()
        wave = [_Pending(q, QueryFuture(), now) for q in queries]
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self.stats.submitted += len(wave)
            self._busy += 1
        try:
            self._execute(wave)
        finally:
            with self._cv:
                self._busy -= 1
                self._cv.notify_all()
        return [p.future.result(timeout=0) for p in wave]

    def stats_snapshot(self) -> dict:
        """``SchedulerStats.as_dict()`` plus the adaptive window's live
        state — ``window_ms_current`` (what the next drain will wait)
        and ``ewma_gap_ms`` (the smoothed inter-arrival gap, ``None``
        before two submits) — plus ``latency``: the scheduler tracer's
        span histograms (``coalesce_wait`` / ``admission`` /
        ``execute``), the reference's schema."""
        with self._cv:
            d = self.stats.as_dict()
            d["window_ms_current"] = self._window_current_ms
            d["ewma_gap_ms"] = self._ewma_gap_ms
        d["latency"] = self.tracer.snapshot()
        return d

    # -- execution core ------------------------------------------------------
    def _execute(self, wave: list[_Pending]) -> None:
        groups: dict[tuple, list[_Pending]] = {}
        for p in wave:
            if p.query.patterns is not None:
                key = (p.query.table, "str")
            else:                     # raw rows coalesce only on equal width
                key = (p.query.table, "raw", p.query.codes.shape[1],
                       p.query.codes.dtype.str)
            groups.setdefault(key, []).append(p)
        for key, plist in groups.items():
            self._execute_group(key, plist)

    def _fail(self, plist: list[_Pending], msg: str, now: float) -> None:
        with self._cv:
            self.stats.errors += len(plist)
        for p in plist:
            p.future._set(_error_result(
                p.query, msg, wait_ms=(now - p.t_submit) * 1e3))

    def _execute_group(self, key: tuple, plist: list[_Pending]) -> None:
        try:
            table = self._resolve(plist[0].query.table)
        except Exception as e:  # noqa: BLE001 — futures must never hang
            self._fail(plist, f"{type(e).__name__}: {e}",
                       time.perf_counter())
            return
        tr = self.tracer
        with self._lock_for(table):
            # deadlines are judged HERE, lock in hand: time queued behind
            # earlier groups or a long client-side write counts against
            # the budget, so an expired query is reported expired instead
            # of executing late over text it never agreed to wait for
            now = time.perf_counter()
            live: list[_Pending] = []
            for p in plist:
                dl = p.query.deadline_ms
                if dl is not None and (now - p.t_submit) * 1e3 > dl:
                    with self._cv:
                        self.stats.deadline_expired += 1
                    p.future._set(_error_result(
                        p.query,
                        f"deadline exceeded: waited "
                        f"{(now - p.t_submit) * 1e3:.2f}ms of {dl}ms budget",
                        wait_ms=(now - p.t_submit) * 1e3))
                else:
                    tr.record("coalesce_wait", (now - p.t_submit) * 1e3)
                    live.append(p)
            # admission: a metered table (one with an ``admit`` method)
            # may shed per tenant BEFORE any work is dispatched; shed is
            # a typed result (`QueryResult.overloaded`), never an answer
            admit = getattr(table, "admit", None)
            if admit is not None and live:
                admitted = []
                with tr.span("admission"):
                    for p in live:
                        if admit(p.query.tenant, p.query.num_patterns):
                            admitted.append(p)
                        else:
                            with self._cv:
                                self.stats.shed += 1
                            p.future._set(_error_result(
                                p.query,
                                f"OVERLOADED: tenant "
                                f"{p.query.tenant!r} is over quota",
                                wait_ms=(now - p.t_submit) * 1e3))
                live = admitted
            if not live:
                return
            try:
                top_k = max(p.query.top_k for p in live)
                spans, n = [], 0
                for p in live:
                    spans.append((n, n + p.query.num_patterns))
                    n += p.query.num_patterns
                with tr.span("execute"):
                    if key[1] == "str":
                        pats: list[str] = []
                        for p in live:
                            pats.extend(p.query.patterns)
                        out = table.scan(pats, top_k=top_k)
                    else:
                        codes = np.concatenate(
                            [p.query.codes for p in live])
                        lens = np.concatenate(
                            [np.asarray(p.query.lens) for p in live])
                        out = table.scan_batch(codes, lens, top_k=top_k)
            except Exception as e:  # noqa: BLE001
                self._fail(live, f"{type(e).__name__}: {e}", now)
                return
        with self._cv:
            self.stats.batches += 1
            self.stats.executed += len(live)
            if len(live) > 1:
                self.stats.coalesced_queries += len(live)
            self.stats.max_batch_patterns = max(
                self.stats.max_batch_patterns, n)
        for p, (lo, hi) in zip(live, spans):
            p.future._set(self._slice(p.query, out, lo, hi, n,
                                      (now - p.t_submit) * 1e3))

    @staticmethod
    def _slice(query: Query, out: ScanOutcome, lo: int, hi: int,
               batch_size: int, wait_ms: float) -> QueryResult:
        """Carve one query's rows out of the group ScanOutcome.  The
        group ran with the max top_k, and positions are ascending-
        complete, so slicing ``[:top_k]`` is bit-identical to running
        the query alone."""
        positions = None
        if query.top_k > 0 and out.positions is not None:
            positions = np.asarray(out.positions[lo:hi, :query.top_k])
        return QueryResult(
            kind=query.kind,
            found=np.asarray(out.found[lo:hi]),
            count=np.asarray(out.count[lo:hi]),
            first_pos=np.asarray(out.first_pos[lo:hi]),
            positions=positions,
            batch_size=batch_size, wait_ms=wait_ms)


# ---------------------------------------------------------------------------
# paged result streaming (the ReadRows analogue)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Page:
    """One bounded chunk of a streamed enumeration."""
    positions: np.ndarray        # ascending global offsets, <= page_size
    cursor: str                  # resume token for the NEXT page
    is_last: bool


class ReadSession:
    """Streams every occurrence position of one pattern in bounded pages.

    The cursor after each page is the last position returned; the next
    page holds the smallest positions strictly greater than it.  Because
    positions are global text offsets — stable across minor and major
    compactions — a serialized cursor (:attr:`cursor`, a JSON token)
    resumes correctly in another process, after an ``append`` or a
    compaction, via :meth:`Database.resume_read`.  Writes landing behind
    the cursor are (by design) not re-surfaced; writes ahead of it show
    up in later pages.
    """

    def __init__(self, database: "Database", table: str, pattern: str, *,
                 page_size: int = 256, start_after: int = -1):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.database = database
        self.table_name = str(table)
        self.pattern = str(pattern)
        self.page_size = int(page_size)
        self._after = int(start_after)
        self._exhausted = False
        # one enumeration per (table write_generation), sliced per page —
        # a stream of P pages costs one scan, not P scans of everything
        self._enum: Optional[np.ndarray] = None
        self._enum_gen: Optional[int] = None

    @property
    def cursor(self) -> str:
        """Serializable continuation token (``Database.resume_read``)."""
        return json.dumps({"v": 1, "table": self.table_name,
                           "pattern": self.pattern,
                           "after": self._after,
                           "page_size": self.page_size})

    @classmethod
    def from_cursor(cls, database: "Database",
                    cursor: Union[str, dict]) -> "ReadSession":
        tok = json.loads(cursor) if isinstance(cursor, str) else dict(cursor)
        if tok.get("v") != 1:
            raise ValueError(f"unknown cursor version {tok.get('v')!r}")
        return cls(database, tok["table"], tok["pattern"],
                   page_size=int(tok["page_size"]),
                   start_after=int(tok["after"]))

    def next_page(self) -> Optional[Page]:
        """The next bounded chunk, or ``None`` once exhausted.  The final
        chunk (possibly empty) has ``is_last=True``; a later resume from
        its cursor sees only rows appended past it since."""
        if self._exhausted:
            return None
        table = self.database.table(self.table_name)

        def _refresh():
            gen = table.write_generation
            if self._enum is None or self._enum_gen != gen:
                self._enum = table.locate_range(self.pattern, after=-1,
                                                limit=None)
                self._enum_gen = gen

        # under the table's execution lock: a write landing mid-
        # enumeration would tear the base/delta view like a mid-scan write
        self.database.scheduler.run_exclusive(table, _refresh)
        start = int(np.searchsorted(self._enum, self._after, side="right"))
        got = self._enum[start:start + self.page_size]
        more = self._enum.size > start + self.page_size
        if got.size:
            self._after = int(got[-1])
        self._exhausted = not more
        return Page(positions=got, cursor=self.cursor, is_last=not more)

    def pages(self) -> Iterator[Page]:
        while True:
            page = self.next_page()
            if page is None:
                return
            yield page

    def positions(self) -> Iterator[int]:
        """Every remaining position, one page at a time."""
        for page in self.pages():
            yield from (int(x) for x in page.positions)

    def __iter__(self) -> Iterator[Page]:
        return self.pages()


# ---------------------------------------------------------------------------
# the database handle
# ---------------------------------------------------------------------------
class Database:
    """A client handle over one catalog root — the serving entry point.

    ``Database(root)`` opens (or creates) a :class:`Catalog` directory
    and routes queries by table name, opening tables lazily and caching
    the handles; ``Database.in_memory()`` (or ``root=None``) skips the
    catalog entirely and serves only :meth:`attach`-ed in-memory tables
    (persistent roots can attach extra in-memory tables too).
    ``open_kw`` (``device=``, ``memtable_limit=``, ...) reach every
    table the handle opens from the root.  One
    :class:`QueryScheduler` is shared by every table, so concurrent
    callers coalesce ACROSS tables into per-table batches.

    The three ways to read::

        db.query(q)            # inline: coalesces only q's own patterns
        db.query_many(qs)      # inline: coalesces the listed queries
        db.submit(q).result()  # windowed: coalesces with OTHER callers

    plus :meth:`read_rows` for paged streaming.  ``close()`` (or a
    ``with`` block) drains the scheduler.
    """

    def __init__(self, root: Optional[str] = None, *,
                 coalesce_window_ms: float = 2.0, max_batch: int = 1024,
                 adaptive_window: bool = True,
                 fastpath_gap_ms: Optional[float] = None,
                 **open_kw):
        self.catalog = Catalog(root) if root is not None else None
        self._open_kw = dict(open_kw)
        self._tables: dict[str, SuffixTable] = {}
        self._owned: set[str] = set()       # opened/created by this handle
        self._remote: set[str] = set()      # plane handles we must close
        self._closed = False
        self._open_lock = threading.Lock()
        self.scheduler = QueryScheduler(
            self.table, window_ms=coalesce_window_ms, max_batch=max_batch,
            adaptive=adaptive_window, fastpath_gap_ms=fastpath_gap_ms)

    @classmethod
    def in_memory(cls, **kw) -> "Database":
        """A rootless database: serves attached tables only."""
        return cls(None, **kw)

    @property
    def root(self) -> Optional[str]:
        return self.catalog.root if self.catalog is not None else None

    # -- table routing -------------------------------------------------------
    def table(self, name: str) -> SuffixTable:
        """The named table — attached, cached, or lazily opened."""
        if self._closed:
            raise RuntimeError("database is closed")
        t = self._tables.get(name)
        if t is None:
            if self.catalog is None:
                raise KeyError(
                    f"no table {name!r} attached to this in-memory "
                    f"database (attach() it, or open a Database(root))")
            with self._open_lock:         # concurrent callers open once
                t = self._tables.get(name)
                if t is None:
                    t = self.catalog.open_table(name, **self._open_kw)
                    self._tables[name] = t
                    self._owned.add(name)
        return t

    def attach(self, name: str, table: SuffixTable) -> SuffixTable:
        """Register an in-memory table under ``name`` for routing."""
        if name in self._tables:
            raise ValueError(f"table {name!r} is already attached")
        self._tables[name] = table
        return table

    def connect_plane(self, name: str, *, attach_as: Optional[str] = None,
                      **router_kw):
        """Route ``name`` through its deployed serving plane
        (``root/<name>/tablets/``, ``repro_torch.serving.plane``).

        Reads the tablet manifest + live endpoints, builds a
        :class:`~repro_torch.serving.router.RemoteTable`, and attaches it
        — by default UNDER THE TABLE'S OWN NAME, so every typed query
        against ``name`` becomes a routed multi-process read (the
        attached handle shadows the lazy on-disk open).  ``attach_as``
        registers it under an alias instead, keeping the local open
        reachable for side-by-side comparison.  ``router_kw`` reaches
        the ``TabletRouter`` (hedging, quotas, metrics).  The handle is
        owned: :meth:`close` shuts its router down."""
        if self.root is None:
            raise RuntimeError("in-memory database has no catalog root "
                               "to read a tablet manifest from")
        from repro_torch.serving.router import connect
        alias = attach_as or name
        if alias in self._tables:
            raise ValueError(f"table {alias!r} is already attached")
        remote = connect(self.root, name, **router_kw)
        self._tables[alias] = remote
        self._remote.add(alias)
        return remote

    def ensure_attached(self, table: SuffixTable,
                        name: Optional[str] = None) -> str:
        """Route an already-built table through this handle and return
        the name to put in ``Query.table``.  Reuses an existing
        registration of the same object; picks a unique private name
        when the natural name is taken by a DIFFERENT table (attached or
        on disk).  The serving engine uses this to ride a shared handle."""
        if name is None:
            for reg, t in self._tables.items():
                if t is table:
                    return reg
        name = name or table.name or "_served"
        if self._tables.get(name) is table:
            return name
        if (name not in self._tables
                and not (self.catalog is not None and name in self.catalog)):
            self._tables[name] = table
            return name
        alt = f"_{name}_{id(table):x}"
        self._tables[alt] = table
        return alt

    def create_table(self, name: str, codes, **kw) -> SuffixTable:
        """Create + persist a table in this root and route to it (on the
        handle's ``device=`` unless ``kw`` names one)."""
        if self.catalog is None:
            raise RuntimeError("in-memory database: attach() a table built "
                               "with SuffixTable.from_codes instead")
        if "device" in self._open_kw:      # the handle's device, unless told
            kw.setdefault("device", self._open_kw["device"])
        t = self.catalog.create_table(name, codes, **kw)
        self._tables[name] = t
        self._owned.add(name)
        return t

    def drop_table(self, name: str, *, missing_ok: bool = False) -> None:
        if self.catalog is None:
            if self._tables.pop(name, None) is None and not missing_ok:
                raise KeyError(f"no table {name!r} attached to this "
                               f"in-memory database")
            return
        # catalog validates (and raises) BEFORE we detach: a failed drop
        # must leave an attached/cached table routed and usable
        self.catalog.drop_table(name, missing_ok=missing_ok)
        t = self._tables.pop(name, None)
        if t is not None:
            t.close()                 # release the dropped table's log fd
        self._owned.discard(name)

    def list_tables(self) -> list[str]:
        names = set(self._tables)
        if self.catalog is not None:
            names.update(self.catalog.list_tables())
        return sorted(names)

    def __contains__(self, name: str) -> bool:
        return (name in self._tables
                or (self.catalog is not None and name in self.catalog))

    # -- typed reads ---------------------------------------------------------
    def query(self, query: Query) -> QueryResult:
        """Execute one query inline (no window wait)."""
        return self.scheduler.execute_now([query])[0]

    def query_many(self, queries: Sequence[Query]) -> list[QueryResult]:
        """Execute a wave of queries inline, coalesced per table."""
        return self.scheduler.execute_now(list(queries))

    def submit(self, query: Query) -> QueryFuture:
        """Enqueue into the coalesce window shared with other callers."""
        return self.scheduler.submit(query)

    # -- writes through the client -------------------------------------------
    def append(self, table: str, codes) -> int:
        """Append through the client: the write is serialized against
        in-flight query batches, so concurrent readers on this handle
        never observe a torn multi-tier view (mutating a table directly
        while other threads read through the client is not
        synchronized).  On a persistent table this call is a **durable
        write ack**: the commit record is logged under the table lock
        but the fsync is awaited OUTSIDE it, so concurrent clients
        appending to the same table batch into one group-commit fsync
        (the write-side mirror of read coalescing — the table's
        ``group_commit_ms`` sets the batching window) while the next
        writer's mutation proceeds.  Triggers the table's automatic
        minor/major compactions as usual; returns the memtable size."""
        t = self.table(table)
        size, token = self.scheduler.run_exclusive(
            t, lambda: t.append_nowait(codes))
        t.wait_durable(token)
        return size

    def compact(self, table: str) -> int:
        """Major-compact through the client (serialized like
        :meth:`append`, against this table's readers only); returns the
        new version."""
        t = self.table(table)
        return self.scheduler.run_exclusive(t, t.compact)

    def freeze(self, table: str, *, sample_rate: int = 32) -> dict:
        """Freeze ``table`` onto the FM-index tier (serialized against
        its readers like :meth:`compact` — the planner rebind must not
        land mid-scan).  Returns the table's per-tier resident-bytes
        stats so the footprint change is immediately observable."""
        t = self.table(table)
        self.scheduler.run_exclusive(
            t, lambda: t.freeze(sample_rate=sample_rate))
        return t.stats()["tiers"]

    def read_rows(self, table: str, pattern: str, *, page_size: int = 256,
                  start_after: int = -1) -> ReadSession:
        """Stream every occurrence position of ``pattern`` in pages."""
        return ReadSession(self, table, pattern, page_size=page_size,
                           start_after=start_after)

    def resume_read(self, cursor: Union[str, dict]) -> ReadSession:
        """Rebuild a :class:`ReadSession` from a serialized cursor."""
        return ReadSession.from_cursor(self, cursor)

    # -- lifecycle / observability -------------------------------------------
    def stats(self) -> dict:
        """``{"scheduler": ..., "tables": {name: table.stats()}}`` for
        every table this handle has touched."""
        return {"scheduler": self.scheduler.stats_snapshot(),
                "tables": {name: t.stats()
                           for name, t in sorted(self._tables.items())}}

    def close(self) -> None:
        """Shut the handle down, idempotently: stop accepting queries,
        drain and JOIN the scheduler's worker thread, then release the
        commit-log fds and metrics emitters of every table THIS handle
        opened or created and the routers of every plane it connected
        (attached in-memory tables stay open — the attacher owns their
        lifecycle).  After ``close()``, :meth:`table` and new queries
        raise."""
        if self._closed:
            return
        self._closed = True
        self.scheduler.close()
        for name in sorted(self._owned):
            t = self._tables.get(name)
            if t is not None:
                t.close()
        for alias in sorted(self._remote):
            self._tables[alias].close()

    def __enter__(self) -> "Database":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
