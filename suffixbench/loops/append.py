"""Read-latest under durable appends (YCSB core workload D): one
closed-loop caller that writes sequencing reads into the table on a
fixed schedule and reads it between the writes.

Appended reads are ``read_len`` bases copied from uniform positions of
the base text, each base substituted by another with probability
``substitution_rate``: resequencing data of the same genome.  They are
drawn on the run's device in one call from the seed, every read the run
will append (the load phase's and every one the window schedules).

* **Load** (set-up, YCSB's load phase): ``load_reads`` reads through
  ``Database.append``, ``reads_per_append`` a call, then
  ``warmup_batches`` read batches.
* **Window**: each turn first sends every append whose time on the
  schedule has come (one ``Database.append`` of ``reads_per_append``
  reads every ``append_period_ms`` from the window's start, late ones
  included), then one read batch through ``Database.query``.  Once the
  window closes, the appends scheduled before its close that are still
  due go out, so every run sends the same appends and seals the same
  runs.  An append's latency runs from its time on the schedule to its
  durable ack (open loop), a read's from submit to answer.
* **A read batch**: ``uniform_per_length`` uniform patterns of each
  length ``min_len..max_len`` (pre-encoded, as the ``bulk`` loop draws
  them) and ``latest_per_length`` "latest" patterns of each length, each
  cut at a uniform offset from an appended read chosen by a Zipf law
  (``zipf_theta``) over recency, newest first, over every read appended
  so far (YCSB's ``requestdistribution=latest``).

Each answer carries ``n_visible``: the base length plus the bases
acknowledged before its batch was sent, the text it is judged over.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time
import types

import numpy as np
import torch

from suffixbench.harness import derive
from suffixbench.loops.bulk import Batches
from suffixbench.roofline import BASES_PER_WORD, unpack_words

WARM_STREAM, WINDOW_STREAM = 3, 4
READ_STREAM, LATEST_WARM_STREAM, LATEST_STREAM = 5, 6, 7


@dataclasses.dataclass
class Request:
    t_submit: float
    t_done: float
    n_patterns: int
    ok: bool
    n_visible: int
    words: np.ndarray
    lens: np.ndarray
    count: np.ndarray
    found: np.ndarray
    first_pos: np.ndarray


def pack_words(codes: np.ndarray) -> np.ndarray:
    """(B, 16 W) codes 0..3 -> (B, W) uint32 words, base ``s`` of a word
    at bit ``30 - 2s`` (the inverse of ``roofline.unpack_words``)."""
    B = codes.shape[0]
    c = codes.astype(np.uint32).reshape(B, -1, BASES_PER_WORD)
    shifts = 30 - 2 * np.arange(BASES_PER_WORD, dtype=np.uint32)
    return np.bitwise_or.reduce(c << shifts, axis=2).astype(np.uint32)


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        lo, hi = int(t["min_len"]), int(t["max_len"])
        self.lengths = np.repeat(np.arange(lo, hi + 1),
                                 int(t["uniform_per_length"]))
        self.latest_lengths = np.repeat(np.arange(lo, hi + 1),
                                        int(t["latest_per_length"]))
        self.width = -(-hi // BASES_PER_WORD) * BASES_PER_WORD
        self.kind = t.get("kind", "scan")
        self.top_k = int(t.get("top_k", 0))
        self.read_len = int(t["read_len"])
        self.per_append = int(t["reads_per_append"])
        self.period_ms = int(t["append_period_ms"])
        self.n_load = int(t["load_reads"])
        # every append the window schedules before it closes
        self.n_window_appends = math.ceil(
            round(float(ctx.seconds) * 1000) / self.period_ms)
        self.reads = self._draw_reads(
            self.n_load + self.n_window_appends * self.per_append)
        weights = np.arange(1, self.reads.shape[0] + 1,
                            dtype=np.float64) ** -float(t["zipf_theta"])
        self._zipf_cdf = np.cumsum(weights)
        self.batches = Batches(ctx, WINDOW_STREAM, self.lengths,
                               int(t["block_batches"]))
        self.batches[int(t["pool_batches"]) - 1]       # drawn in set-up
        self.n_acked = 0            # reads acknowledged, in append order
        self.append_log: list[tuple[float, float]] = []   # (due, acked)
        self.last: Request | None = None

    # -- data ---------------------------------------------------------------
    def _draw_reads(self, n_reads: int) -> np.ndarray:
        """(n_reads, read_len) uint8 reads, drawn on the run's device."""
        dev, L = self.ctx.device, self.read_len
        g = torch.Generator(device=dev)
        g.manual_seed(derive(self.ctx.seed, READ_STREAM))
        text = torch.from_numpy(self.ctx.text).to(dev)
        pos = torch.randint(0, text.numel() - L + 1, (n_reads, 1),
                            generator=g, device=dev)
        reads = text[pos + torch.arange(L, device=dev)]
        sub = torch.rand((n_reads, L), generator=g, device=dev) < float(
            self.ctx.traffic["substitution_rate"])
        shift = torch.randint(1, 4, (n_reads, L), generator=g, device=dev,
                              dtype=torch.uint8)
        reads = torch.where(sub, (reads + shift) % 4, reads)
        return reads.cpu().numpy()

    def _latest(self, stream: int, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Batch ``i``'s "latest" patterns over the reads acked so far:
        (B, W) words and (B,) lengths."""
        rng = np.random.default_rng(derive(self.ctx.seed, stream, i))
        lens = self.latest_lengths
        B, n = lens.size, self.n_acked
        cdf = self._zipf_cdf[:n]
        rank = np.minimum(np.searchsorted(cdf, rng.random(B) * cdf[-1],
                                          side="right"), n - 1)
        read = n - 1 - rank                        # rank 0: the newest
        off = (rng.random(B) * (self.read_len - lens + 1)).astype(np.int64)
        cols = off[:, None] + np.arange(self.width)
        codes = self.reads[read[:, None],
                           np.minimum(cols, self.read_len - 1)]
        codes = np.where(np.arange(self.width) < lens[:, None], codes, 0)
        return pack_words(codes), lens.astype(np.int32)

    def _batch(self, batches: Batches, stream: int, i: int):
        words, lens = batches[i]
        lw, ll = self._latest(stream, i)
        return np.concatenate([words, lw]), np.concatenate([lens, ll])

    # -- requests -----------------------------------------------------------
    def _append(self, n_reads: int) -> None:
        """``Database.append`` of the next ``n_reads`` reads: a durable
        ack when it returns."""
        k = self.n_acked
        self.ctx.db.append(self.ctx.table_name,
                           self.reads[k:k + n_reads].reshape(-1))
        self.n_acked = k + n_reads

    def _n_visible(self) -> int:
        return self.ctx.n_bases + self.n_acked * self.read_len

    def _read(self, words, lens, db=None) -> Request:
        from repro_torch.api import Query
        n_visible = self._n_visible()
        q = Query(table=self.ctx.table_name, kind=self.kind, codes=words,
                  lens=lens, top_k=self.top_k)
        t0 = time.perf_counter()
        res = (db or self.ctx.db).query(q)
        t1 = time.perf_counter()
        return Request(t0, t1, int(lens.shape[0]), res.ok, n_visible,
                       words, lens, res.count, res.found, res.first_pos)

    def warm_up(self) -> None:
        """The load phase, then the warm-up read batches."""
        t0 = time.perf_counter()
        for k in range(0, self.n_load, self.per_append):
            self._append(min(self.per_append, self.n_load - k))
        t1 = time.perf_counter()
        n = int(self.ctx.traffic["warmup_batches"])
        warm = Batches(self.ctx, WARM_STREAM, self.lengths, n)
        for i in range(n):
            self._read(*self._batch(warm, LATEST_WARM_STREAM, i))
        print(f"load: reads={self.n_load} seconds={t1 - t0:.3f} "
              f"warmup_seconds={time.perf_counter() - t1:.3f}",
              file=sys.stderr)

    def callers(self) -> list:
        period_s = self.period_ms / 1e3
        seconds = float(self.ctx.seconds)

        def run(stop_at):
            start = stop_at - seconds
            out = []
            j = i = 0

            def send_due(now):
                nonlocal j
                while j < self.n_window_appends and \
                        start + j * period_s <= now:
                    self._append(self.per_append)
                    self.append_log.append((start + j * period_s,
                                            time.perf_counter()))
                    j += 1

            while time.perf_counter() < stop_at:
                send_due(time.perf_counter())
                out.append(self._read(*self._batch(self.batches,
                                                   LATEST_STREAM, i)))
                i += 1
            send_due(math.inf)
            self.last = out[-1] if out else None
            return out
        return [run]

    # -- after the window ---------------------------------------------------
    def appended(self) -> np.ndarray:
        """Every acknowledged appended code, in ack order."""
        return self.reads[:self.n_acked].reshape(-1)

    def reread(self, db) -> types.SimpleNamespace:
        """The window's last read batch answered again by ``db``."""
        return self.answers([self._read(self.last.words, self.last.lens,
                                        db)])

    def answers(self, requests) -> types.SimpleNamespace:
        """Every answered pattern of ``requests`` with its answer and the
        text length it was answered over."""
        ok = [r for r in requests if r.ok]
        cat = (lambda xs, dt: np.concatenate(xs).astype(dt) if xs
               else np.zeros(0, dt))
        hi = self.width
        return types.SimpleNamespace(
            codes=(np.concatenate([unpack_words(r.words)[:, :hi]
                                   for r in ok]) if ok
                   else np.zeros((0, hi), np.uint8)),
            plen=cat([r.lens for r in ok], np.int64),
            n_visible=cat([np.full(r.n_patterns, r.n_visible)
                           for r in ok], np.int64),
            count=cat([r.count for r in ok], np.int64),
            found=cat([r.found for r in ok], bool),
            first_pos=cat([r.first_pos for r in ok], np.int64),
            unanswered=sum(r.n_patterns for r in requests if not r.ok))

    def control_batches(self, n: int) -> types.SimpleNamespace:
        """The control's input, with no program: at least ``n`` patterns
        of the window's batches as if each batch followed one scheduled
        append (codes, lengths, ``n_visible``, and ``latest``, the mask
        of the "latest" patterns)."""
        codes, plen, vis, latest = [], [], [], []
        i = 0
        while sum(p.size for p in plen) < n:
            self.n_acked = self.n_load + self.per_append * min(
                i + 1, self.n_window_appends)
            words, lens = self._batch(self.batches, LATEST_STREAM, i)
            codes.append(unpack_words(words)[:, :self.width])
            plen.append(lens.astype(np.int64))
            vis.append(np.full(lens.size, self._n_visible()))
            latest.append(np.arange(lens.size) >= self.lengths.size)
            i += 1
        return types.SimpleNamespace(codes=np.concatenate(codes),
                                     plen=np.concatenate(plen),
                                     n_visible=np.concatenate(vis),
                                     latest=np.concatenate(latest))
