"""Serving: LM prefill/decode entry points + the TabletSA scan service —
the port of ``repro.serving.engine``.

LM serving runs eagerly under ``torch.inference_mode()`` (no jit, nothing
to compile): ``make_prefill_fn``/``make_decode_fn`` return plain
functions and ``greedy_generate`` loops over them; the decode step
writes into the caches it is given (``models.transformer.decode_step``).

The scan service reproduces the paper's §V experiment shape (batched
random-pattern scans) and adds the production feature the paper's Table IV
is begging for: **hedged reads** over tablet replicas.  The paper measured
a max reply of 771 ms against a 5.3 ms mean — a 145x tail.  With replicas
and a backup request fired at the p95 deadline, the tail collapses to
~max(primary, backup-after-deadline); the service simulates per-replica
latency (lognormal body + pareto tail) and reports the same statistics
as Tables III/IV.  Patterns are generated and encoded on the host and
reach the table as numpy; the table searches them on its device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import query as Q
from repro_torch.core.planner import ScanPlanner
from repro_torch.core.tablet import TabletStore
from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import batch_to, param_device


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0         # 0 = greedy


def make_prefill_fn(cfg: ModelConfig, serve: ServeConfig):
    """fn(params, batch) -> (last logits, caches of capacity
    ``serve.max_len``); the batch (numpy or tensors) moves to the
    params' device."""
    @torch.inference_mode()
    def fn(params, batch):
        return prefill(cfg, params, batch_to(batch, param_device(params)),
                       max_len=serve.max_len)

    return fn


def make_decode_fn(cfg: ModelConfig):
    """fn(params, tokens, caches) -> (logits, caches): one decode step."""
    @torch.inference_mode()
    def fn(params, tokens, caches):
        return decode_step(cfg, params, tokens, caches)

    return fn


@torch.inference_mode()
def greedy_generate(cfg: ModelConfig, params, batch, num_steps: int,
                    serve: Optional[ServeConfig] = None) -> torch.Tensor:
    """Greedy generation loop: (B, num_steps) int32 tokens on the params'
    device."""
    serve = serve or ServeConfig()
    logits, caches = prefill(cfg, params,
                             batch_to(batch, param_device(params)),
                             max_len=serve.max_len)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out = [tok]
    for _ in range(num_steps - 1):
        logits, caches = decode_step(cfg, params, tok, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)


def _host(x) -> np.ndarray:
    """A batch as a host numpy array (torch tensors leave their
    device)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _safe_corr(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson correlation, defined as 0.0 when either column has zero
    variance (hit rate exactly 0.0 or 1.0 made np.corrcoef emit NaN)."""
    if len(a) < 2 or float(a.std()) == 0.0 or float(b.std()) == 0.0:
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])


@dataclasses.dataclass
class HedgedScanService:
    """A replica/hedging POLICY on top of the client frontend.

    The service owns no scan execution: every batch becomes a typed
    raw-codes :class:`repro_torch.api.Query` (numpy codes) dispatched
    through a :class:`repro_torch.api.Database` handle, which routes by
    table name and coalesces with any other caller sharing the handle
    (pass ``database=`` to share one).  What remains here is the serving
    *policy* the paper's Table IV begs for — replicas, simulated
    per-replica latency, and hedged backup requests.

    ``table`` is the :class:`repro_torch.api.SuffixTable` being served;
    reads go through the table's merged LSM path, so appended-but-
    uncompacted data is visible with exact counts.  A bare
    :class:`TabletStore` is still accepted and wrapped in an in-memory
    table.

    ``replicas`` tablet-store replicas serve every scan batch;
    per-request replica latency = base_ms * lognormal(sigma) with a
    pareto tail of probability tail_p and scale tail_scale (the paper's
    771 ms events).  A backup request fires after ``hedge_deadline_ms``;
    effective latency is min(primary, deadline + backup).  Scan RESULTS
    come from the real engine (on the table's device); only latency is
    simulated — UNLESS the served table is a
    :class:`~repro_torch.serving.router.RemoteTable`: then the hedge is a
    real second RPC to a different worker process (the router's replica
    machinery — ``hedged=`` toggles it per call) and the reported
    latency is the real measured wall time of the routed batch, so the
    same Table III/IV statistics compare simulated and genuine hedging.
    """
    table: "object"          # SuffixTable | RemoteTable | TabletStore
    replicas: int = 2
    base_ms: float = 5.0
    sigma: float = 0.35
    tail_p: float = 0.002
    tail_scale_ms: float = 300.0
    hedge_deadline_ms: float = 15.0
    seed: int = 0
    planner: Optional[ScanPlanner] = None
    database: Optional["object"] = None      # repro_torch.api.Database

    def __post_init__(self):
        from repro_torch.api import Database
        from repro_torch.api.table import SuffixTable
        self.is_remote = bool(getattr(self.table, "is_remote", False))
        if isinstance(self.table, TabletStore):
            self.table = SuffixTable.from_store(self.table,
                                                planner=self.planner)
        if self.planner is None and not self.is_remote:
            self.planner = self.table.planner
        if self.database is None:
            self.database = Database.in_memory()
        self.table_name = self.database.ensure_attached(self.table)
        # private generator (not a dataclass field): repeated workloads are
        # reproducible per service instance, and scan() no longer mutates
        # the dataclass's compare-by-value state (the old `self.seed += 1`)
        self._rng = np.random.default_rng(self.seed)

    @property
    def store(self) -> TabletStore:
        """The served table's base store (back-compat accessor)."""
        return self.table.store

    def _latency(self, rng, n) -> np.ndarray:
        lat = self.base_ms * rng.lognormal(0.0, self.sigma, size=n)
        tail = rng.random(n) < self.tail_p
        lat = lat + np.where(tail,
                             rng.pareto(1.5, size=n) * self.tail_scale_ms, 0)
        return lat

    def scan(self, patterns_packed, plen, hedged: bool = True):
        """Returns (QueryResult, latency_ms per query).  The batch (numpy
        or torch) rides a typed raw-codes Query through the client as
        numpy, as the reference's does; the table moves it to its
        device (merged LSM tiers, one search launch on the card)."""
        from repro_torch.api import Query
        q = Query(table=self.table_name, kind="scan",
                  codes=_host(patterns_packed), lens=_host(plen))
        n = int(q.lens.shape[0])
        if self.is_remote:
            # real plane: toggle the router's genuine hedging per call
            # and report measured wall latency (every query of the batch
            # experienced the same routed dispatch)
            router = self.table.router
            prev = router.hedge_enabled
            router.hedge_enabled = bool(hedged)
            try:
                t0 = time.perf_counter()
                res = self.database.query(q)
                wall_ms = (time.perf_counter() - t0) * 1e3
            finally:
                router.hedge_enabled = prev
            if not res.ok:
                raise RuntimeError(f"scan failed: {res.error}")
            return res, np.full(n, wall_ms)
        res = self.database.query(q)
        if not res.ok:
            raise RuntimeError(f"scan failed: {res.error}")
        rng = self._rng
        primary = self._latency(rng, n)
        if not hedged or self.replicas < 2:
            return res, primary
        backup = self._latency(rng, n)
        hedged_lat = np.minimum(primary,
                                self.hedge_deadline_ms + backup)
        return res, hedged_lat

    def run_workload(self, num_queries: int, batch: int = 1024,
                     min_len: int = 1, max_len: int = 100,
                     hedged: bool = True, seed: int = 0):
        """The paper's §V workload: random patterns, uniform length.
        Returns dict of Table III/IV statistics.

        ``max_len`` is validated against the served table's pattern cap
        up front — the planner rejects over-cap patterns per batch, so an
        invalid workload would otherwise crash midway with partial work
        done and an opaque traceback."""
        cap = int(self.planner.max_pattern_len if self.planner is not None
                  else self.table.max_query_len)
        if max_len > cap:
            raise ValueError(
                f"run_workload max_len={max_len} exceeds the table's "
                f"pattern cap {cap} (its max_query_len); clamp max_len "
                f"or rebuild the table with a larger max_query_len")
        if not 1 <= min_len <= max_len:
            raise ValueError(f"need 1 <= min_len <= max_len, got "
                             f"min_len={min_len} max_len={max_len}")
        lat_all, out_all, len_all = [], [], []
        done = 0
        b = 0
        while done < num_queries:
            take = min(batch, num_queries - done)
            # random_patterns takes an int seed; derive a distinct stream
            # per batch instead of passing an ad-hoc tuple
            pats = Q.random_patterns(take, min_len, max_len,
                                     seed=seed * 100_003 + b)
            _, pp, pl = Q.encode_patterns(
                pats, ((max_len + 15) // 16) * 16, device="cpu")
            res, lat = self.scan(pp, pl, hedged=hedged)
            lat_all.append(lat)
            out_all.append(np.asarray(res.found))
            len_all.append(np.asarray(pl))
            done += take
            b += 1
        if not lat_all:            # num_queries == 0: well-defined zeros
            z = 0.0
            return {"n": 0, "mean_ms": z, "sd_ms": z, "min_ms": z,
                    "max_ms": z, "p99_ms": z, "hit_rate": z, "mean_len": z,
                    "corr_len_time": z, "corr_len_outcome": z}
        lat = np.concatenate(lat_all)
        out = np.concatenate(out_all)
        ln = np.concatenate(len_all)
        return {
            "n": len(lat),
            "mean_ms": float(lat.mean()), "sd_ms": float(lat.std()),
            "min_ms": float(lat.min()), "max_ms": float(lat.max()),
            "p99_ms": float(np.percentile(lat, 99)),
            "hit_rate": float(out.mean()),
            "mean_len": float(ln.mean()),
            "corr_len_time": _safe_corr(ln, lat),
            "corr_len_outcome": _safe_corr(ln, out.astype(float)),
        }
