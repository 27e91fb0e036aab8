"""The readers of the ``merge`` span's parts on a made-up context: the
arithmetic, and None where the span is absent (as from a program that
lacks it) or no pattern was answered; then a traced run on the CPU."""
import os
import time
import types

import pytest
import torch

from suffixbench import harness, spec

READERS = ("table.range_min_ms_per_query",
           "table.merge_self_ms_per_query",
           "table.lf_walk_ms_per_query.frozen")


def _reader(name):
    return spec.load_module(
        os.path.join(spec.HERE, "layer_metrics", f"{name}.py"),
        f"suffixbench_test_{name}")


def _ctx(counters, patterns=500):
    return types.SimpleNamespace(counters=counters,
                                 segment_patterns=patterns)


LIVE = {"table.merge": (40.0, 10), "table.range_min": (30.0, 10),
        "table.dispatch": (2.0, 10), "client.executed": 10}
FROZEN = {"table.merge": (1600.0, 1), "table.lf_walk": (1550.0, 1)}


def test_live_parts_add_up_to_merge():
    range_min = _reader("table.range_min_ms_per_query").read(_ctx(LIVE))
    self_ms = _reader("table.merge_self_ms_per_query").read(_ctx(LIVE))
    merge = _reader("table.merge_ms_per_query").read(_ctx(LIVE))
    assert range_min == pytest.approx(30.0 / 500)
    assert self_ms == pytest.approx(10.0 / 500)
    assert range_min + self_ms == pytest.approx(merge)
    assert _reader("table.lf_walk_ms_per_query.frozen").read(
        _ctx(LIVE)) is None


def test_frozen_walks_and_what_is_left():
    walk = _reader("table.lf_walk_ms_per_query.frozen").read(
        _ctx(FROZEN, 100))
    assert walk == pytest.approx(15.5)
    assert _reader("table.merge_self_ms_per_query").read(
        _ctx(FROZEN, 100)) == pytest.approx(0.5)
    assert _reader("table.range_min_ms_per_query").read(
        _ctx(FROZEN, 100)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_span(name):
    """A program with ``merge`` but no child span (the parent of the
    spans) gives None, and so does an empty context."""
    assert _reader(name).read(_ctx({"table.merge": (40.0, 10)})) is None
    assert _reader(name).read(_ctx({})) is None


@pytest.mark.parametrize("name", READERS)
def test_none_without_patterns(name):
    counters = {**LIVE, **FROZEN}
    assert _reader(name).read(_ctx(counters, 0)) is None


@pytest.mark.parametrize("name", READERS)
def test_none_when_the_span_did_not_run_in_the_segment(name):
    """A span recorded only before the segment (a delta of 0 calls)
    reads None, as the other span readers do."""
    counters = {"table.merge": (0.0, 0), "table.range_min": (0.0, 0),
                "table.lf_walk": (0.0, 0)}
    assert _reader(name).read(_ctx(counters)) is None


@pytest.mark.parametrize("name,parts", [
    ("chr1-live.bulk500", ("table.range_min_ms_per_query",
                           "table.merge_self_ms_per_query")),
    ("chr1-frozen.bulk100", ("table.lf_walk_ms_per_query.frozen",))])
def test_traced_run_splits_merge(small_cell, name, parts):
    """A traced run on the CPU at a small size reads the new metrics in
    their cells; on the live cell its two parts add up to ``merge``.
    Every pattern has 9 bases, past the k-mer table's 8, on a text where
    about a fifth of them match: each batch of the untraced stretch has
    rows left to the slice minimum (live) or the LF walk (frozen)."""
    cell = small_cell(name, n_bases=1 << 16)
    cell.traffic.update(min_len=9, max_len=9)
    out = harness.run_cell(cell, 2**31 + 5, 2.0, True,
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    merge = m[next(k for k in m if k.startswith("table.merge_ms"))]
    assert set(parts) <= set(m)
    if len(parts) == 2:
        assert m[parts[0]] + m[parts[1]] == pytest.approx(merge)
    else:
        assert 0 < m[parts[0]] <= merge
