"""Deployment of the serving plane: tablet split + worker supervision;
the port's own copy of ``repro.serving.plane``.

``split_table`` is the Bigtable master's tablet-assignment step scaled
to one table: it cuts the table's latest published snapshot into
``n_tablets`` contiguous suffix-rank ranges, derives each boundary's
**split key** (the first ``key_len`` symbols of the boundary suffix —
what the router needs to route a pattern without consulting the SA),
and records the layout in ``root/<name>/tablets/manifest.json`` — the
METADATA tablet map, living inside the same catalog directory scheme
the ``Catalog`` already manages.

:class:`ServingPlane` is the process supervisor: it spawns one
``python -m repro_torch.serving.tablet_server`` per (tablet, replica) —
numpy-only workers, millisecond startup — publishes the live socket
endpoints in ``tablets/serving.json``, health-checks them, and supports
kill / restart (the failover test's kill -9 path) and clean shutdown.
Sockets live in a fresh ``/tmp`` directory because ``AF_UNIX`` paths
cap at ~108 bytes — a pytest ``tmp_path`` would overflow it.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

from repro_torch.serving.router import RemoteTable, TabletRouter
from repro_torch.serving.tablet_server import SnapshotReader


def _latest_step(table_dir: str) -> int:
    steps = [int(d[len("step_"):]) for d in os.listdir(table_dir)
             if d.startswith("step_")
             and os.path.isdir(os.path.join(table_dir, d))]
    if not steps:
        raise FileNotFoundError(f"no published snapshot under {table_dir}")
    return max(steps)


def split_table(root: str, name: str, n_tablets: int, *,
                key_len: int = 32) -> dict:
    """Cut the table's latest snapshot into ``n_tablets`` rank ranges
    and write the ``tablets/manifest.json`` METADATA map.

    Boundary ``i`` sits at rank ``round(i * n / T)``; its split key is
    the first ``key_len`` symbols of the suffix at that rank, so the
    router can bound any pattern's rank range by prefix-comparing
    against the keys alone.  Raises on a frozen table (the FM tier has
    no suffix array to partition — split before ``freeze()``).
    """
    if n_tablets < 1:
        raise ValueError(f"n_tablets must be >= 1, got {n_tablets}")
    table_dir = os.path.join(root, name)
    step = _latest_step(table_dir)
    snap = SnapshotReader(table_dir, step)
    extra = snap.extra
    if extra.get("frozen"):
        raise RuntimeError(
            f"table {name!r} is frozen onto the FM-index: no suffix "
            f"array to range-partition — split before freeze()")
    sa = np.asarray(snap.load("sa_real")).astype(np.int64)
    codes = np.asarray(snap.load("codes"))
    n = int(sa.shape[0])
    if n_tablets > max(n, 1):
        raise ValueError(f"cannot cut {n} suffixes into {n_tablets} "
                         f"tablets")
    bounds = [round(i * n / n_tablets) for i in range(n_tablets + 1)]
    tablets = []
    for i in range(n_tablets):
        lo, hi = bounds[i], bounds[i + 1]
        g = int(sa[lo]) if lo < n else n
        key = codes[g:g + key_len].astype(int).tolist()
        tablets.append({"id": i, "rank_lo": lo, "rank_hi": hi,
                        "key": key})
    manifest = {
        "table": name,
        "step": step,
        "table_version": int(extra["version"]),
        "is_dna": bool(extra["is_dna"]),
        "max_query_len": int(extra["max_query_len"]),
        "n_base": n,
        "key_len": int(key_len),
        "n_tablets": int(n_tablets),
        "tablets": tablets,
    }
    tdir = os.path.join(table_dir, "tablets")
    os.makedirs(tdir, exist_ok=True)
    path = os.path.join(tdir, "manifest.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, path)           # readers see old map or new, never half
    return manifest


class ServingPlane:
    """Supervisor for one table's worker fleet.

    ``replicas`` is processes PER TABLET (1 = no replication).  Worker
    knobs (``max_inflight``, ``device_floor_ms``, slow-injection) are
    passed straight through to ``tablet_server`` argv.  Use as a
    context manager or call :meth:`stop`.
    """

    def __init__(self, root: str, name: str, *, replicas: int = 1,
                 max_inflight: int = 8, metrics_interval_s: float = 2.0,
                 device_floor_ms: float = 0.0,
                 inject_slow_ms: float = 0.0, inject_slow_p: float = 0.0,
                 inject_slow_replica: Optional[int] = None,
                 python: Optional[str] = None):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.root = os.path.abspath(root)
        self.name = name
        self.replicas = int(replicas)
        self.max_inflight = int(max_inflight)
        self.metrics_interval_s = float(metrics_interval_s)
        self.device_floor_ms = float(device_floor_ms)
        self.inject_slow_ms = float(inject_slow_ms)
        self.inject_slow_p = float(inject_slow_p)
        # None = every worker injects; an int restricts injection to that
        # replica index (a designated straggler victim, so fault-injection
        # benches measure the hedge path deterministically)
        self.inject_slow_replica = (None if inject_slow_replica is None
                                    else int(inject_slow_replica))
        self.python = python or sys.executable
        self.tablets_dir = os.path.join(self.root, name, "tablets")
        self.manifest_path = os.path.join(self.tablets_dir,
                                          "manifest.json")
        with open(self.manifest_path) as f:
            self.manifest = json.load(f)
        self.n_tablets = int(self.manifest["n_tablets"])
        # AF_UNIX socket paths are capped (~108 bytes): keep them short
        # and in /tmp, never under a deep pytest tmp_path
        self._sock_dir = tempfile.mkdtemp(prefix="saplane-")
        self._procs: dict[tuple[int, int], subprocess.Popen] = {}
        self._logs: list = []

    @classmethod
    def deploy(cls, root: str, name: str, n_tablets: int, *,
               key_len: int = 32, start: bool = True,
               wait: bool = True, **kw) -> "ServingPlane":
        """split + construct (+ start) in one call — the common path."""
        split_table(root, name, n_tablets, key_len=key_len)
        plane = cls(root, name, **kw)
        if start:
            plane.start(wait=wait)
        return plane

    # -- process management --------------------------------------------------
    def _sock_path(self, tablet: int, replica: int) -> str:
        return os.path.join(self._sock_dir, f"t{tablet}r{replica}.sock")

    def _spawn(self, tablet: int, replica: int) -> subprocess.Popen:
        slow_p = self.inject_slow_p
        if (self.inject_slow_replica is not None
                and replica != self.inject_slow_replica):
            slow_p = 0.0
        argv = [
            self.python, "-m", "repro_torch.serving.tablet_server",
            "--manifest", self.manifest_path,
            "--tablet", str(tablet), "--replica", str(replica),
            "--sock", self._sock_path(tablet, replica),
            "--max-inflight", str(self.max_inflight),
            "--metrics-path", os.path.join(self.root, self.name,
                                           "metrics.jsonl"),
            "--metrics-interval", str(self.metrics_interval_s),
            "--device-floor-ms", str(self.device_floor_ms),
            "--inject-slow-ms", str(self.inject_slow_ms),
            "--inject-slow-p", str(slow_p),
            "--seed", str(1 + tablet * self.replicas + replica),
        ]
        env = dict(os.environ)
        # the src dir the workers must import the package from
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        log = open(os.path.join(
            self.tablets_dir, f"worker_t{tablet}_r{replica}.log"), "ab")
        self._logs.append(log)
        proc = subprocess.Popen(argv, stdout=log, stderr=log, env=env)
        self._procs[(tablet, replica)] = proc
        return proc

    def start(self, *, wait: bool = True,
              timeout_s: float = 30.0) -> None:
        for t in range(self.n_tablets):
            for r in range(self.replicas):
                self._spawn(t, r)
        self._write_serving()
        if wait:
            self.wait_ready(timeout_s=timeout_s)

    def _write_serving(self) -> None:
        endpoints = [[self._sock_path(t, r) for r in range(self.replicas)]
                     for t in range(self.n_tablets)]
        pids = [[self._procs[(t, r)].pid for r in range(self.replicas)]
                for t in range(self.n_tablets)]
        path = os.path.join(self.tablets_dir, "serving.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"endpoints": endpoints, "pids": pids}, f, indent=1)
        os.replace(tmp, path)

    def wait_ready(self, *, timeout_s: float = 30.0) -> None:
        from repro_torch.serving.rpc import RpcClient
        deadline = time.monotonic() + timeout_s
        for (t, r), proc in sorted(self._procs.items()):
            client = RpcClient(self._sock_path(t, r), timeout=2.0)
            try:
                while not client.ping(timeout=1.0):
                    if proc.poll() is not None:
                        raise RuntimeError(
                            f"tablet worker t{t}r{r} exited with "
                            f"{proc.returncode} before becoming ready "
                            f"(see worker_t{t}_r{r}.log)")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"tablet worker t{t}r{r} not ready after "
                            f"{timeout_s}s")
                    time.sleep(0.05)
            finally:
                client.close()

    def alive(self, tablet: int, replica: int = 0) -> bool:
        proc = self._procs.get((tablet, replica))
        return proc is not None and proc.poll() is None

    def pid(self, tablet: int, replica: int = 0) -> int:
        return self._procs[(tablet, replica)].pid

    def kill(self, tablet: int, replica: int = 0, *,
             sig: int = signal.SIGKILL) -> None:
        """Hard-kill one worker (the failover test's crash injection)."""
        proc = self._procs[(tablet, replica)]
        if proc.poll() is None:
            proc.send_signal(sig)
            proc.wait(timeout=10)

    def restart(self, tablet: int, replica: int = 0, *,
                wait: bool = True, timeout_s: float = 30.0) -> None:
        """Respawn one worker on its old socket path (it unlinks the
        stale socket on bind); pooled router connections to the dead
        process fail once and redial."""
        self.kill(tablet, replica, sig=signal.SIGKILL)
        self._spawn(tablet, replica)
        self._write_serving()
        if wait:
            from repro_torch.serving.rpc import RpcClient
            client = RpcClient(self._sock_path(tablet, replica),
                               timeout=2.0)
            deadline = time.monotonic() + timeout_s
            try:
                while not client.ping(timeout=1.0):
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"restarted worker t{tablet}r{replica} not "
                            f"ready after {timeout_s}s")
                    time.sleep(0.05)
            finally:
                client.close()

    # -- client handles ------------------------------------------------------
    def endpoints(self) -> list[list[str]]:
        return [[self._sock_path(t, r) for r in range(self.replicas)]
                for t in range(self.n_tablets)]

    def router(self, **kw) -> TabletRouter:
        kw.setdefault("metrics_path",
                      os.path.join(self.root, self.name, "metrics.jsonl"))
        return TabletRouter(self.manifest, self.endpoints(), **kw)

    def remote_table(self, **kw) -> RemoteTable:
        return RemoteTable.from_manifest(self.router(**kw))

    # -- lifecycle -----------------------------------------------------------
    def stop(self, *, grace_s: float = 5.0) -> None:
        for proc in self._procs.values():
            if proc.poll() is None:
                proc.terminate()
        deadline = time.monotonic() + grace_s
        for proc in self._procs.values():
            left = max(0.0, deadline - time.monotonic())
            try:
                proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5)
        for log in self._logs:
            try:
                log.close()
            except OSError:
                pass
        self._logs = []
        shutil.rmtree(self._sock_dir, ignore_errors=True)

    def __enter__(self) -> "ServingPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
