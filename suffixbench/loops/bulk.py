"""Bulk screening: one closed-loop caller sending pre-encoded batches
(``Query(kind=..., codes=, lens=)``, packed 2-bit words) through
``Database.query``, the next once the answer is in its hand.

Each batch holds exactly ``per_length`` patterns of each length
``min_len..max_len``, in an order shuffled from the seed, with uniform
bases: every batch asks for the same work, so a run's work does not
swing with how many one-base patterns (each a quarter of the text) a
random draw would hold.  Batches are drawn on the run's device in
blocks of ``block_batches`` from the seed; ``pool_batches`` of them are
drawn in set-up, more (a block at a time) only if the window outruns
them.  The warm-up sends ``warmup_batches`` batches of another stream.
"""
from __future__ import annotations

import dataclasses
import time
import types

import numpy as np
import torch

from suffixbench.harness import derive, run_window
from suffixbench.roofline import BASES_PER_WORD, unpack_words

WARM_STREAM, WINDOW_STREAM = 3, 4


@dataclasses.dataclass
class Request:
    t_submit: float
    t_done: float
    n_patterns: int
    ok: bool
    batch: int
    count: np.ndarray
    found: np.ndarray
    first_pos: np.ndarray


class Batches:
    """The batches of one stream, drawn a block at a time."""

    def __init__(self, ctx, stream: int, lengths: np.ndarray,
                 block: int):
        self.ctx, self.stream, self.block = ctx, stream, int(block)
        self.lengths = torch.as_tensor(lengths, device=ctx.device)
        self.n_words = -(-int(lengths.max()) // BASES_PER_WORD)
        self.words: list[np.ndarray] = []
        self.lens: list[np.ndarray] = []

    def __getitem__(self, i: int):
        while i >= self.block * len(self.words):
            self._draw(len(self.words))
        k, j = divmod(i, self.block)
        return self.words[k][j], self.lens[k][j]

    def _draw(self, k: int) -> None:
        dev = self.ctx.device
        g = torch.Generator(device=dev)
        g.manual_seed(derive(self.ctx.seed, self.stream, k))
        B = int(self.lengths.numel())
        width = self.n_words * BASES_PER_WORD
        order = torch.argsort(torch.rand((self.block, B), generator=g,
                                         device=dev), dim=1)
        lens = self.lengths[order]
        codes = torch.randint(0, 4, (self.block, B, width), generator=g,
                              device=dev, dtype=torch.uint8).to(torch.int64)
        codes *= torch.arange(width, device=dev) < lens[..., None]
        shifts = 30 - 2 * torch.arange(BASES_PER_WORD, device=dev)
        words = (codes.view(self.block, B, self.n_words, BASES_PER_WORD)
                 << shifts).sum(-1)
        self.words.append(words.cpu().numpy().astype(np.uint32))
        self.lens.append(lens.cpu().numpy().astype(np.int32))


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        lo, hi = int(t["min_len"]), int(t["max_len"])
        self.lengths = np.repeat(np.arange(lo, hi + 1),
                                 int(t["per_length"]))
        self.block = int(t["block_batches"])
        self.kind = t.get("kind", "scan")
        self.top_k = int(t.get("top_k", 0))
        self.batches = Batches(ctx, WINDOW_STREAM, self.lengths, self.block)
        self.batches[int(t["pool_batches"]) - 1]       # drawn in set-up

    def _caller(self, batches: Batches, limit=None):
        from repro_torch.api import Query
        db, name = self.ctx.db, self.ctx.table_name
        kind, top_k = self.kind, self.top_k

        def run(stop_at):
            out = []
            i = 0
            while (time.perf_counter() < stop_at if limit is None
                   else i < limit):
                words, lens = batches[i]
                q = Query(table=name, kind=kind, codes=words, lens=lens,
                          top_k=top_k)
                t0 = time.perf_counter()
                res = db.query(q)
                t1 = time.perf_counter()
                out.append(Request(t0, t1, int(lens.shape[0]), res.ok, i,
                                   res.count, res.found, res.first_pos))
                i += 1
            return out
        return run

    def warm_up(self) -> None:
        n = int(self.ctx.traffic["warmup_batches"])
        warm = Batches(self.ctx, WARM_STREAM, self.lengths, n)
        run_window([self._caller(warm, limit=n)], 0.0)

    def callers(self) -> list:
        return [self._caller(self.batches)]

    def window_patterns(self, n: int):
        """The patterns of the window's first batches, at least ``n``
        (codes, lengths): what the control answers."""
        hi = int(self.lengths.max())
        k = -(-n // int(self.lengths.size))
        return (np.concatenate([unpack_words(self.batches[i][0])[:, :hi]
                                for i in range(k)]),
                np.concatenate([self.batches[i][1] for i in range(k)]))

    def answers(self, requests) -> types.SimpleNamespace:
        """Every answered pattern of the window with its answer."""
        ok = [r for r in requests if r.ok]
        hi = int(self.lengths.max())
        codes = [unpack_words(self.batches[r.batch][0])[:, :hi] for r in ok]
        lens = [self.batches[r.batch][1] for r in ok]
        cat = (lambda xs, dt: np.concatenate(xs).astype(dt) if xs
               else np.zeros(0, dt))
        return types.SimpleNamespace(
            codes=(np.concatenate(codes) if codes
                   else np.zeros((0, hi), np.uint8)),
            plen=cat(lens, np.int64),
            count=cat([r.count for r in ok], np.int64),
            found=cat([r.found for r in ok], bool),
            first_pos=cat([r.first_pos for r in ok], np.int64),
            unanswered=sum(r.n_patterns for r in requests if not r.ok))
