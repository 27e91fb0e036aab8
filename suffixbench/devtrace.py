"""The device trace of a traced run: ``torch.profiler`` over a stretch of
the measured window, reduced to what the per-layer readers need.

Device operations (kernels, copies, sets) come from the profiler's
CUPTI records; the busy time is the union of their intervals inside the
traced stretch, so overlapping operations count once.  The idle gaps
are the stretches between them, each named by the innermost host event
(an operator or a CUDA runtime call, of any thread the profiler saw)
that spans its middle, or ``host`` where none does.

Each kernel also keeps the host time of the CUDA runtime call that
launched it (the call with the kernel's correlation id), or -1 where the
trace lost that call: what ties a launch to the call of the program
that made it when the trace has lost some launches.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernels: dict            # name -> (start_ns, duration_ns, launch_ns)
                             # arrays, in order
    device_ops: list         # [[name, seconds], ...] most time first
    idle_gaps: list          # [[host event, seconds], ...] longest first

    def kernel_ns(self, part: str) -> np.ndarray:
        """Durations (ns), in launch order, of the kernels whose name
        holds ``part``."""
        return self.kernel_launches(part)[1]

    def kernel_launches(self, part: str) -> tuple[np.ndarray, np.ndarray]:
        """(launch_ns, duration_ns), in launch order, of the kernels
        whose name holds ``part``; ``launch_ns`` is -1 where the trace
        lost the runtime call that launched one."""
        found = [v for name, v in self.kernels.items() if part in name]
        if not found:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        starts, durs, launches = (np.concatenate([v[i] for v in found])
                                  for i in range(3))
        order = np.argsort(starts, kind="stable")
        return launches[order], durs[order]


class Profiler:
    """Starts and stops ``torch.profiler`` (CPU and CUDA activities) and
    reduces its events to a :class:`DeviceTrace`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._t0 = self._t1 = None

    def start(self, device) -> None:
        """Starts the profiler, and the traced stretch once its
        collection runs: one small operation on ``device`` waited for,
        then a pause, both before the stretch."""
        import torch
        self._prof.start()
        torch.zeros(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        time.sleep(0.05)
        self._t0 = time.time_ns()

    def stop(self) -> None:
        self._t1 = time.time_ns()
        self._prof.stop()

    def result(self, top: int = 10) -> DeviceTrace:
        events = self._prof.profiler.kineto_results.events()
        t0, t1 = self._t0, self._t1
        dev, host = [], []
        launched = {}            # correlation id -> start of its launch
        for e in events:
            s = int(e.start_ns())
            d = int(e.duration_ns())
            if str(e.device_type()).endswith("CUDA"):
                dev.append((e.name(), s, d, int(e.correlation_id())))
            else:
                host.append((e.name(), s, d))
                if "Launch" in e.name() and e.correlation_id():
                    launched[int(e.correlation_id())] = s
        kernels: dict[str, list] = {}
        per_name: dict[str, int] = {}
        iv = []
        for name, s, d, corr in dev:
            kernels.setdefault(name, []).append(
                (s, d, launched.get(corr, -1) if corr else -1))
            per_name[name] = per_name.get(name, 0) + d
            a, b = max(s, t0), min(s + d, t1)
            if b > a:
                iv.append((a, b))
        busy, gaps = _union(iv, t0, t1)
        window_s = (t1 - t0) / 1e9
        ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return DeviceTrace(
            window_s=window_s, busy_s=busy / 1e9,
            kernels={k: tuple(np.array([x[i] for x in v], np.int64)
                              for i in range(3))
                     for k, v in kernels.items()},
            device_ops=[[name[:120], ns / 1e9] for name, ns in ops],
            idle_gaps=[[_host_at(host, (a + b) // 2), (b - a) / 1e9]
                       for a, b in longest])


def _union(iv, t0: int, t1: int):
    """Busy ns of the intervals ``iv`` and the gaps between them in
    ``[t0, t1]``, as (start, end) pairs."""
    busy = 0
    gaps = []
    cur = t0
    for a, b in sorted(iv):
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if t1 > cur:
        gaps.append((cur, t1))
    return busy, gaps


def _host_at(host, t: int) -> str:
    """The innermost host event spanning ``t``, or ``host``."""
    best = None
    for name, s, d in host:
        if s <= t <= s + d and (best is None or d < best[1]):
            best = (name, d)
    return best[0][:120] if best else "host"
