"""Closed-loop users: ``callers`` users, each sending one string pattern
a request (``Query.scan`` with the traffic's ``top_k``) through
``Database.submit`` and the client's default ``QueryScheduler``, and
sending the next once the answer is in hand.  Each user is a thread of
its own, as the paper's users are clients of their own: the client's
adaptive window coalesces whatever the threads have submitted when it
dispatches.

Each caller draws its own stream from the seed, in chunks of ``CHUNK``
patterns (a few microseconds a pattern, taken as the caller's own
work): bases uniform, lengths uniform in ``min_len..max_len`` as
shuffled blocks that hold each length once, so that every seed asks for
the same lengths in another order.  The
warm-up sends ``warmup_queries`` patterns of another stream the same
way, enough to bring the table's LRU pattern cache to the state a
long-running server has.
"""
from __future__ import annotations

import dataclasses
import time
import types

import numpy as np

from suffixbench.harness import run_window

ASCII = np.frombuffer(b"ACGT", np.uint8)
CHUNK = 1000
WARM_STREAM, WINDOW_STREAM = 1, 2


@dataclasses.dataclass
class Request:
    t_submit: float
    t_done: float
    n_patterns: int
    ok: bool
    caller: int
    index: int
    count: int
    found: bool
    first_pos: int


class Patterns:
    """One caller's stream of patterns, drawn a chunk at a time."""

    def __init__(self, seed: int, stream: int, caller: int, lo: int,
                 hi: int):
        self._rng = np.random.default_rng([seed % (1 << 64), stream,
                                           caller])
        self.lo, self.hi = lo, hi
        self.strings: list[str] = []
        self.codes: list[np.ndarray] = []
        self.lens: list[np.ndarray] = []

    def __getitem__(self, i: int) -> str:
        while i >= len(self.strings):
            span = np.arange(self.lo, self.hi + 1)
            lens = np.concatenate([self._rng.permutation(span) for _ in
                                   range(-(-CHUNK // span.size))])[:CHUNK]
            codes = self._rng.integers(0, 4, size=(CHUNK, self.hi),
                                       dtype=np.uint8)
            raw = ASCII[codes].tobytes()
            w = self.hi
            self.strings.extend(raw[j * w:j * w + int(lens[j])].decode()
                                for j in range(CHUNK))
            self.codes.append(codes)
            self.lens.append(lens)
        return self.strings[i]


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.n_callers = int(t["callers"])
        self.lo, self.hi = int(t["min_len"]), int(t["max_len"])
        self.top_k = int(t.get("top_k", 0))
        self.kind = t.get("kind", "scan")
        self.streams: list[Patterns] = []

    def _caller(self, stream: Patterns, caller: int, limit=None):
        """One user: submits a pattern, waits for its answer, submits
        the next, until ``stop_at`` (or ``limit`` requests)."""
        from repro_torch.api import Query
        db, name = self.ctx.db, self.ctx.table_name
        kind, top_k = self.kind, self.top_k

        def run(stop_at):
            out = []
            i = 0
            while (time.perf_counter() < stop_at if limit is None
                   else i < limit):
                q = Query(table=name, kind=kind, patterns=(stream[i],),
                          top_k=top_k)
                t0 = time.perf_counter()
                res = db.submit(q).result()
                t1 = time.perf_counter()
                if res.ok:
                    out.append(Request(t0, t1, 1, True, caller, i,
                                       int(res.count[0]),
                                       bool(res.found[0]),
                                       int(res.first_pos[0])))
                else:
                    out.append(Request(t0, t1, 1, False, caller, i, -1,
                                       False, -1))
                i += 1
            return out
        return run

    def _streams(self, stream: int) -> list[Patterns]:
        return [Patterns(self.ctx.seed, stream, c, self.lo, self.hi)
                for c in range(self.n_callers)]

    def warm_up(self) -> None:
        per = -(-int(self.ctx.traffic["warmup_queries"]) // self.n_callers)
        run_window([self._caller(p, c, limit=per) for c, p in
                    enumerate(self._streams(WARM_STREAM))], 0.0)

    def callers(self) -> list:
        self.streams = self._streams(WINDOW_STREAM)
        for p in self.streams:
            p[0]                   # each caller's first chunk, in set-up
        return [self._caller(p, c) for c, p in enumerate(self.streams)]

    def window_patterns(self, n: int):
        """The first ``n`` patterns the window's callers would send, in
        turn (codes, lengths): what the control answers."""
        streams = self._streams(WINDOW_STREAM)
        per = -(-n // self.n_callers)
        for p in streams:
            p[per - 1]
        codes = np.concatenate([np.concatenate(p.codes)[:per]
                                for p in streams])[:n]
        lens = np.concatenate([np.concatenate(p.lens)[:per]
                               for p in streams])[:n]
        return codes, lens

    def answers(self, requests) -> types.SimpleNamespace:
        """Every answered pattern of the window with its answer."""
        ok = [r for r in requests if r.ok]
        caller = np.array([r.caller for r in ok], np.int64)
        index = np.array([r.index for r in ok], np.int64)
        codes = np.zeros((len(ok), self.hi), np.uint8)
        plen = np.zeros(len(ok), np.int64)
        for c, p in enumerate(self.streams):
            m = caller == c
            if m.any():
                codes[m] = np.concatenate(p.codes)[index[m]]
                plen[m] = np.concatenate(p.lens)[index[m]]
        return types.SimpleNamespace(
            codes=codes, plen=plen,
            count=np.array([r.count for r in ok], np.int64),
            found=np.array([r.found for r in ok], bool),
            first_pos=np.array([r.first_pos for r in ok], np.int64),
            unanswered=len(requests) - len(ok))
