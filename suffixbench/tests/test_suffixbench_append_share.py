"""The writing cell whose inserts are tied to its reads by count
(``loops/append_share.py``) on the CPU at a small size: the share of
inserts holds whatever the rate, every read follows an append, a sound
run loses nothing and acks nothing unsynced, and the window's appends
are bounded by ``max_window_appends``."""
import copy
import time
import types

import pytest
import torch

from suffixbench import harness, spec
from suffixbench.tests.test_suffixbench_append import _FakeDB

CELL = "chr1-append.ycsb-d-5pct"


def _small(seals: bool = False, max_appends: int = 2000):
    cell = spec.resolve(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["n_bases"] = 4096
    cell.config["table_options"].update(
        memtable_limit=600 if seals else 1 << 20)
    cell.traffic.update(block_batches=2, pool_batches=2, warmup_batches=1,
                        uniform_per_length=1, reads_per_append=2,
                        load_reads=10, max_window_appends=max_appends)
    return cell


def _window(cell, seed=2**31 + 5, seconds=0.5):
    text = harness.make_text(4096, seed, torch.device("cpu"))
    db = _FakeDB()
    ctx = types.SimpleNamespace(
        db=db, table=None, table_name=harness.TABLE, seed=seed,
        config=cell.config, traffic=cell.traffic,
        device=torch.device("cpu"), n_bases=4096, text=text,
        seconds=seconds)
    load = cell.loop.Traffic(ctx)
    load.warm_up()
    _start, _end, requests = harness.run_window(load.callers(), seconds)
    return load, requests


def test_the_cell_ties_its_inserts_to_its_reads():
    cell = spec.resolve(CELL)
    assert cell.traffic["loop"] == "append_share"
    assert cell.traffic["insert_share"] == 0.05
    assert "append_period_ms" not in cell.traffic
    assert {m.name for m in cell.end_to_end} >= {"queries_per_s",
                                                 "setup_s"}


@pytest.mark.parametrize("seconds", [0.3, 0.8])
def test_the_share_of_inserts_holds_at_any_length_of_window(seconds):
    load, requests = _window(_small(), seconds=seconds)
    inserted = len(load.append_log) * load.per_append
    read = sum(r.n_patterns for r in requests)
    share = load.share
    owed = read * share / (1 - share)
    assert owed - load.per_append < inserted <= owed
    # every read follows at least one append: each sees more bases
    base = 4096 + load.n_load * load.read_len
    vis = [r.n_visible for r in requests]
    assert vis[0] > base and all(b > a for a, b in zip(vis, vis[1:]))
    assert load.appended().size == (load.n_load + inserted) * load.read_len


def test_a_window_past_its_bound_fails():
    with pytest.raises(RuntimeError, match="max_window_appends"):
        _window(_small(max_appends=3))


@pytest.mark.parametrize("seals", [False, True])
def test_a_sound_run_of_the_cell_loses_nothing(seals):
    out = harness.run_cell(_small(seals), 2**31 + 11, 1.0, False,
                           torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["unsynced_acks"] == {"value": 0, "limit": 0}
    assert out["checks"]["lost_appends"] == {"value": 0, "limit": 0}
