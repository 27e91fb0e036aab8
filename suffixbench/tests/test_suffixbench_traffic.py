"""The traffic is drawn from the seed alone, and the bulk batches hold
exactly the stratified lengths."""
import types

import numpy as np
import torch

from suffixbench import harness, spec
from suffixbench.roofline import unpack_words


def _ctx(cell, seed):
    return types.SimpleNamespace(seed=seed, traffic=cell.traffic,
                                 config=cell.config,
                                 device=torch.device("cpu"),
                                 db=None, table=None, table_name="chr1")


def test_text_is_seeded():
    a = harness.make_text(5000, 2**31 + 11, torch.device("cpu"))
    b = harness.make_text(5000, 2**31 + 11, torch.device("cpu"))
    c = harness.make_text(5000, 2**31 + 12, torch.device("cpu"))
    assert a.dtype == np.uint8 and a.max() <= 3
    assert (a == b).all() and (a != c).any()
    assert abs(np.bincount(a, minlength=4) / 5000 - 0.25).max() < 0.03


def test_user_streams_are_seeded_and_uniform(small_cell):
    cell = small_cell("chr1-live.users50")
    t1 = cell.loop.Traffic(_ctx(cell, 3**20))
    t2 = cell.loop.Traffic(_ctx(cell, 3**20))
    t3 = cell.loop.Traffic(_ctx(cell, 3**20 + 1))
    s1, s2, s3 = (t._streams(2) for t in (t1, t2, t3))
    first = [s1[c][i] for c in range(4) for i in range(1500)]
    assert first == [s2[c][i] for c in range(4) for i in range(1500)]
    assert first != [s3[c][i] for c in range(4) for i in range(1500)]
    lens = np.array([len(p) for p in first])
    assert lens.min() == 1 and lens.max() == 100
    # stratified: each caller's every 100 requests hold each length once
    for c in range(4):
        for b in range(0, 1500 - 99, 100):
            block = sorted(len(s1[c][i]) for i in range(b, b + 100))
            assert block == list(range(1, 101))
    assert set("".join(first)) == set("ACGT")
    # the callers' streams differ from each other and from the warm-up's
    assert [s1[0][i] for i in range(8)] != [s1[1][i] for i in range(8)]
    assert [t1._streams(1)[0][i] for i in range(8)] != \
        [s1[0][i] for i in range(8)]


def test_bulk_batches_are_seeded_and_stratified(small_cell):
    for name, per in (("chr1-live.bulk500", 5), ("chr1-frozen.bulk100", 1)):
        cell = small_cell(name)
        cell.traffic.update(block_batches=3, pool_batches=3)
        a = cell.loop.Traffic(_ctx(cell, 77)).batches
        b = cell.loop.Traffic(_ctx(cell, 77)).batches
        c = cell.loop.Traffic(_ctx(cell, 78)).batches
        for i in range(5):            # past the pool: a block more
            words, lens = a[i]
            assert words.dtype == np.uint32 and words.shape == (100 * per, 7)
            assert (np.bincount(lens, minlength=101)[1:] == per).all()
            assert (words == b[i][0]).all() and (lens == b[i][1]).all()
            assert not (words == c[i][0]).all()
            codes = unpack_words(words)
            # bases past each pattern's length are zero
            assert not (codes * (np.arange(112) >= lens[:, None])).any()
        assert not (a[0][1] == a[1][1]).all()       # shuffled per batch


def test_derived_seeds_are_distinct():
    seeds = {harness.derive(s, k) for s in (0, 1, 2**31 + 5, -3)
             for k in range(4)}
    assert len(seeds) == 16 and all(0 <= s < 2**63 for s in seeds)
