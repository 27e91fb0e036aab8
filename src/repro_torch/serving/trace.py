"""Lightweight per-query tracing — the port's own copy of
``repro.serving.trace`` (numpy only; the port imports nothing of
``repro``).

Each stage of the read path wraps itself in a named *span*
(``with tracer.span("dispatch"): ...``); the wall time lands in a
bounded ring buffer per span name, and ``snapshot()`` reduces the rings
to rolling p50/p95/p99 histograms — what ``SuffixTable.stats()
["latency"]`` returns.  A span is two ``time.monotonic_ns()`` calls and
one ring-slot store; ``Tracer(enabled=False)`` swaps ``span()`` for a
shared no-op context.  On a CUDA device the work inside a span is
asynchronous until some host conversion waits for it, so a span times
enqueue plus whatever wait it forces.

Each tracer names its component (``table`` for a table and its planner,
``client`` for the scheduler, ``router`` and ``tablet`` for the plane,
``planner`` for a planner built alone).  While a ``torch.profiler``
records, a span also opens a profiler range ``<component>.<span>``
(``table.merge``, ``client.execute``) for its extent: the profiler
stamps it on the clock of the kernels it traces, and ranges nested on
one thread are nested in the trace.  Whether one records is read per
span from ``torch.autograd.profiler._is_profiler_enabled``, a Python
flag every thread sees, through ``sys.modules``: this module imports no
torch, and a process without torch opens no range.  ``record()``, which
logs a duration measured elsewhere, opens none.  A range is
``torch._C._profiler._RecordFunctionFast``, not ``record_function``:
it costs a tenth as much, on a thread the profiler records and on one
it does not (~1-2 us against ~15-17 us on a CPU core), and it is an
operator range, not a user annotation, so the profiler puts no copy of
it on the device row, where it would read as busy time.
"""

from __future__ import annotations

import sys
import time

import numpy as np

__all__ = ["SpanHistogram", "Tracer"]

_DEFAULT_RING = 2048
# quantiles exported by every histogram snapshot, in feed order
_QUANTILES = (("p50_ms", 0.50), ("p95_ms", 0.95), ("p99_ms", 0.99))


class SpanHistogram:
    """Bounded ring of span durations (ms) reduced to rolling quantiles.

    The ring keeps the most recent ``size`` samples; ``total`` counts
    every sample ever recorded (so feeds can rate-convert) and
    ``sum_ms`` accumulates total time for mean/utilisation math.
    """

    __slots__ = ("_buf", "_size", "_n", "_sum_ms")

    def __init__(self, size: int = _DEFAULT_RING):
        if size <= 0:
            raise ValueError(f"ring size must be positive, got {size}")
        self._size = int(size)
        self._buf = np.zeros(self._size, np.float64)
        self._n = 0
        self._sum_ms = 0.0

    def record(self, ms: float) -> None:
        # lock-free: a slot store + int bump, each atomic under the GIL
        self._buf[self._n % self._size] = ms
        self._n += 1
        self._sum_ms += ms

    @property
    def count(self) -> int:
        return self._n

    def quantiles(self) -> dict:
        """Rolling p50/p95/p99 over the ring window (same empirical
        quantile rule as ``metrics.LatencyWindow``: the sorted sample
        at index ``int(frac * n)``, clamped)."""
        n = min(self._n, self._size)
        if n == 0:
            out = {name: 0.0 for name, _ in _QUANTILES}
            out.update(n=0, total=0, sum_ms=0.0)
            return out
        data = np.sort(self._buf[:n])
        out = {name: round(float(data[min(n - 1, int(frac * n))]), 4)
               for name, frac in _QUANTILES}
        out.update(n=int(n), total=int(self._n),
                   sum_ms=round(float(self._sum_ms), 4))
        return out


class _Span:
    """One timed region.  Deliberately not ``@contextmanager`` — a tiny
    __enter__/__exit__ class is several times cheaper per call."""

    __slots__ = ("_tracer", "_name", "_t0")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer = tracer
        self._name = name

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer.record(self._name,
                            (time.monotonic_ns() - self._t0) / 1e6)
        return False


class _NullSpan:
    """Shared no-op context for disabled tracers."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


# read per span (inline: a call would cost more than the read)
_MODULES = sys.modules
_PROFILER = "torch.autograd.profiler"
_RANGES = "torch._C._profiler"         # in sys.modules once torch is


class _RangedSpan(_Span):
    """A span that is also a profiler range ``<component>.<span>``,
    opened before its clock starts and closed after it stops."""

    __slots__ = ("_range",)

    def __init__(self, tracer: "Tracer", name: str, ranges):
        super().__init__(tracer, name)
        self._range = ranges._RecordFunctionFast(
            f"{tracer.component}.{name}")

    def __enter__(self) -> "_RangedSpan":
        self._range.__enter__()
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        super().__exit__(exc_type, exc, tb)
        self._range.__exit__(exc_type, exc, tb)
        return False


class Tracer:
    """Named span histograms for one ``component`` (``table``,
    ``client``, ``router``, ...).  ``span(name)`` times a region (and is
    the profiler range ``<component>.<name>`` while one records);
    ``record(name, ms)`` logs an externally measured duration (e.g. a
    queue wait computed from a stored submit timestamp); ``count(name,
    n)`` keeps a counter beside them; ``snapshot()`` is the
    ``stats()["latency"]`` payload."""

    def __init__(self, component: str, *, ring_size: int = _DEFAULT_RING,
                 enabled: bool = True):
        self.component = str(component)
        self.enabled = bool(enabled)
        self._ring_size = int(ring_size)
        self._spans: dict[str, SpanHistogram] = {}

    def span(self, name: str):
        if not self.enabled:
            return _NULL_SPAN
        prof = _MODULES.get(_PROFILER)
        if prof is not None and prof._is_profiler_enabled:
            return _RangedSpan(self, name, _MODULES[_RANGES])
        return _Span(self, name)

    def record(self, name: str, ms: float) -> None:
        if not self.enabled:
            return
        hist = self._spans.get(name)
        if hist is None:
            # setdefault: two racing first-recorders converge on one ring
            hist = self._spans.setdefault(name,
                                          SpanHistogram(self._ring_size))
        hist.record(float(ms))

    def count(self, name: str, n: int) -> None:
        """Adds ``n`` to the counter ``name``: a histogram of counts, one
        sample a call, whose ``sum_ms`` in :meth:`snapshot` is the sum of
        the counts and ``total`` the number of calls.  Opens no range."""
        self.record(name, n)

    def snapshot(self) -> dict:
        """``{span_name: {p50_ms, p95_ms, p99_ms, n, total, sum_ms}}``,
        name-sorted so feed rows diff cleanly."""
        return {name: self._spans[name].quantiles()
                for name in sorted(self._spans)}

    def reset(self) -> None:
        self._spans.clear()
