"""Read-latest under durable appends with the insert share fixed by
count (YCSB core workload D: ``insert_share`` of the operations are
inserts, whatever the rate): the ``append`` loop's reads, load, data and
checks, with the window's appends tied to the reads instead of to the
clock.

Before each read batch the caller sends the appends that keep the reads
appended at ``insert_share`` of the reads appended plus the patterns
read: a batch of ``P`` patterns owes ``P * insert_share / (1 -
insert_share)`` reads, sent ``reads_per_append`` at a time once owed
(500 patterns and 25 reads an append at 5%: one append before each
batch, two before every 19th).  So every read follows an append on any
host, and a faster host sends more appends, not a smaller share.
``max_window_appends`` bounds the reads drawn in set-up; a window that
would send more fails.  An append's latency runs from its send to its
durable ack.
"""
from __future__ import annotations

import time

import numpy as np

from suffixbench.loops import append
from suffixbench.loops.bulk import Batches
from suffixbench.roofline import BASES_PER_WORD


class Traffic(append.Traffic):
    def __init__(self, ctx):
        """The ``append`` loop's set-up, the window's reads drawn for
        ``max_window_appends`` appends, with no period to derive them."""
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
        self.share = float(t["insert_share"])
        self.n_load = int(t["load_reads"])
        self.n_window_appends = int(t["max_window_appends"])
        self.reads = self._draw_reads(
            self.n_load + self.n_window_appends * self.per_append)
        weights = np.arange(1, self.reads.shape[0] + 1,
                            dtype=np.float64) ** -float(t["zipf_theta"])
        self._zipf_cdf = np.cumsum(weights)
        self.batches = Batches(ctx, append.WINDOW_STREAM, self.lengths,
                               int(t["block_batches"]))
        self.batches[int(t["pool_batches"]) - 1]       # drawn in set-up
        self.n_acked = 0            # reads acknowledged, in append order
        self.append_log: list[tuple[float, float]] = []   # (sent, acked)
        self.last = None

    def callers(self) -> list:
        per_batch = self.lengths.size + self.latest_lengths.size
        owed_a_batch = per_batch * self.share / (1.0 - self.share)

        def run(stop_at):
            out = []
            i = 0
            owed = 0.0
            while time.perf_counter() < stop_at:
                owed += owed_a_batch
                while owed >= self.per_append:
                    if len(self.append_log) >= self.n_window_appends:
                        raise RuntimeError(
                            "the window needs more than "
                            f"max_window_appends={self.n_window_appends}")
                    sent = time.perf_counter()
                    self._append(self.per_append)
                    self.append_log.append((sent, time.perf_counter()))
                    owed -= self.per_append
                out.append(self._read(*self._batch(
                    self.batches, append.LATEST_STREAM, i)))
                i += 1
            self.last = out[-1] if out else None
            return out
        return [run]
