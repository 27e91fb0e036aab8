"""Pairing the recorded calls of a kernel with its launches in the trace,
where the trace has lost some of them."""
import types

import numpy as np
import pytest

from suffixbench import devtrace, roofline


def _trace(launch_ns, durs):
    starts = np.arange(len(durs), dtype=np.int64) * 1000 + 10**9
    return devtrace.DeviceTrace(
        window_s=1.0, busy_s=0.5,
        kernels={"void bounded_search_kernel<false>(int const*)": (
            starts, np.asarray(durs, np.int64),
            np.asarray(launch_ns, np.int64))},
        device_ops=[], idle_gaps=[])


def _calls(n):
    """``n`` calls of one pattern each, in (enter, exit) spans 100 ns
    long, 1000 ns apart."""
    words = np.zeros((1, 1), np.uint32)
    plen = np.ones(1, np.int32)
    spans = [(1000 * i, 1000 * i + 100) for i in range(n)]
    return [(words, plen)] * n, spans


def test_each_launch_is_tied_to_the_call_that_holds_it():
    _calls_, spans = _calls(4)
    launch = np.array([1050, 3010, -1, 2099, 5000, 3050])
    # 1050: call 1; 3010 and 3050 both in call 3, so neither; -1 lost;
    # 2099: call 2; 5000 in none
    assert roofline.pair_launches(spans, launch).tolist() == \
        [1, -1, -1, 2, -1, -1]


def test_a_launch_in_two_overlapping_calls_is_tied_to_neither():
    spans = [(0, 500), (100, 200), (600, 700)]
    assert roofline.pair_launches(spans, np.array([150, 400, 650])) \
        .tolist() == [-1, 0, 2]


@pytest.mark.parametrize("lost", [[], [1], [0, 3]])
def test_the_share_is_read_over_the_launches_the_trace_kept(lost):
    calls, spans = _calls(5)
    durs = np.array([100, 200, 300, 400, 500])
    keep = [i for i in range(5) if i not in lost]
    launch = np.array([1000 * i + 50 for i in keep])
    ctx = types.SimpleNamespace(
        launches={"bounded_search": calls},
        launch_spans={"bounded_search": spans},
        trace=_trace(launch, durs[keep]), reference=None)

    def traffic(_ref, _codes, _plen, _n_words):
        return int(roofline.MEM_BYTES_PER_S * 1e-7), 0     # 100 ns

    share = roofline.kernel_share(ctx, "bounded_search", traffic)
    assert share == pytest.approx(100.0 * 100 * len(keep)
                                  / durs[keep].sum())


def test_no_share_where_no_launch_is_tied_to_a_call():
    calls, spans = _calls(3)
    ctx = types.SimpleNamespace(
        launches={"bounded_search": calls},
        launch_spans={"bounded_search": spans},
        trace=_trace([-1, -1], [100, 200]), reference=None)
    assert roofline.kernel_share(ctx, "bounded_search",
                                 lambda *a: (1, 1)) is None
