"""Whole runs on the CPU at a small size, the look for a card skipped:
a sound run is ``correct``, and a run with the timed path broken
underneath (an answer altered where it is produced: by the table's
scan, or by its pattern cache) is not."""
import time

import numpy as np
import pytest
import torch

from suffixbench import harness, spec
from suffixbench.tests.conftest import bench_with_probes

# the benchmark's cells, the probes and the cells held out of it
CELLS = tuple(w["name"] for w in bench_with_probes()["workloads"])


def _run(cell, seed=2**31 + 3, seconds=1.0, trace=False):
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name):
    cell = small_cell(name)
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    # every end-to-end metric of the cell but the card's memory reading
    assert set(out["metrics"]) == {m.name for m in cell.end_to_end} - {
        "serve_bytes_per_base"}
    assert any(k.startswith("queries_per_s") for k in out["metrics"])
    assert out["device"]["count"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_in_the_scan_is_caught(small_cell, monkeypatch,
                                                 name):
    from repro_torch.api.table import SuffixTable
    inner = SuffixTable.scan_batch

    def altered(self, patt, plen, top_k=0):
        out = inner(self, patt, plen, top_k=top_k)
        out.count[0] += 1
        return out

    monkeypatch.setattr(SuffixTable, "scan_batch", altered)
    out = _run(small_cell(name))
    assert not out["correct"]
    assert out["checks"]["wrong_count"]["value"] >= 1


@pytest.mark.parametrize("name", [c for c in CELLS if "users" in c])
def test_a_first_pos_altered_in_the_cache_is_caught(small_cell, monkeypatch,
                                                    name):
    """Short patterns only, so the pattern cache answers many of them."""
    from repro_torch.core.planner import TopKCache
    inner = TopKCache.get

    def altered(self, pattern, top_k):
        hit = inner(self, pattern, top_k)
        if hit is None:
            return None
        count, first_pos, row = hit
        return count, first_pos + 1, row

    cell = small_cell(name)
    cell.traffic.update(min_len=1, max_len=2)
    monkeypatch.setattr(TopKCache, "get", altered)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["wrong_first_pos"]["value"] >= 1


def test_traced_run_reads_its_layer_metrics(small_cell):
    out = _run(small_cell("chr1-live.users50"), seconds=2.0, trace=True)
    assert out["correct"]
    m = out["metrics"]
    assert {"client.wave_queries", "client.coalesce_wait_ms",
            "table.cache_hit_share", "table.merge_ms_per_query",
            "planner.dispatch_ms_per_query", "table.ingest_s",
            "device.idle_share"} <= set(m)
    # no kernel runs on the CPU: its roofline is left out, not 0
    assert "bounded_search_roofline" not in m
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_control_is_not_correct_at_a_small_size():
    """The control (first positions from the suffix order) in the
    program's place fails the check that the sound answers pass."""
    from suffixbench.reference.suffix_array import SuffixReference
    rng = np.random.default_rng(4)
    text = rng.integers(0, 4, 50_000).astype(np.uint8)
    plen = rng.integers(1, 101, 3000)
    codes = rng.integers(0, 4, (3000, 100)).astype(np.uint8)
    ref = SuffixReference(torch.as_tensor(text), max_len=128)
    c, f = ref.answer_rank_first(torch.as_tensor(codes),
                                 torch.as_tensor(plen))
    checks = harness.judge(ref, codes, plen, c, c > 0, f, 0)
    assert checks["wrong_first_pos"]["value"] > 0
    c, f = ref.answer(torch.as_tensor(codes), torch.as_tensor(plen))
    sound = harness.judge(ref, codes, plen, c, c > 0, f, 0)
    assert all(v["value"] == 0 for v in sound.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name,roof", [
    ("chr1-live.bulk500", "bounded_search_roofline"),
    ("chr1-frozen.bulk100", "fm_scan_roofline"),
    ("chr1-append.ycsb-d", "tier_scan_roofline")])
def test_traced_run_on_the_card(small_cell, cuda_device, name, roof):
    """On the card a traced run reads its kernel's roofline, a share in
    (0, 100], and a busy time inside its traced stretch."""
    out = harness.run_cell(small_cell(name, n_bases=1 << 20), 2**31 + 9,
                           4.0, True, cuda_device, time.perf_counter())
    assert out["correct"], out["checks"]
    assert 0 < out["metrics"][roof]["value"] <= 100
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["device"]["platform"] == "gpu"
