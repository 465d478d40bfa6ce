"""Metric arithmetic: a rate over the whole window, a percentile over all
batches, spans a million pairs, and the reduction of a device trace."""

import importlib.util
import os

import pytest

import devtrace
import stats

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    def __init__(self, **kw):
        self.__dict__.update(kw)


BATCHES = [
    {"pairs": 1000, "wall_s": 0.5, "parse_ms": 100.0, "load_ms": 10.0,
     "kernel_ms": 2.0, "retrieve_ms": 3.0, "unit": 0},
    {"pairs": 1000, "wall_s": 0.7, "parse_ms": 120.0, "load_ms": 12.0,
     "kernel_ms": 2.0, "retrieve_ms": 5.0, "unit": 1},
]


def test_rate_is_all_work_over_all_time():
    # the window holds gaps between batches: they count
    assert stats.rate([1000, 1000], 1.5) == pytest.approx(2000 / 1.5)
    run = Run(batches=BATCHES, window_s=1.5)
    assert _reader("pairs_s")(run) == pytest.approx(2000 / 1.5)


def test_p95_over_all_batches():
    walls = list(range(1, 101))            # 1..100 ms
    assert stats.percentile(walls, 95) == 95
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                             11, 12, 13, 14, 15, 16, 17, 18, 19, 100],
                            95) == 19
    batches = [{"pairs": 1, "wall_s": w / 1e3} for w in walls]
    run = Run(batches=batches, window_s=5.05)
    assert _reader("batch_ms_p95")(run) == pytest.approx(95)
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spans_a_million_pairs():
    run = Run(batches=BATCHES, window_s=1.5)
    assert _reader("parse_ms_per_mpair")(run) == pytest.approx(220 / 2e-3)
    assert _reader("load_ms_per_mpair")(run) == pytest.approx(22 / 2e-3)
    assert _reader("kernel_ms_per_mpair")(run) == pytest.approx(4 / 2e-3)
    assert _reader("retrieve_ms_per_mpair")(run) == pytest.approx(8 / 2e-3)
    rest = (500 - 115) + (700 - 139)
    assert _reader("post_ms_per_mpair")(run) == pytest.approx(rest / 2e-3)
    # a batch without the span: nothing to read, not 0
    api = [dict(b, parse_ms=None) for b in BATCHES]
    assert _reader("parse_ms_per_mpair")(Run(batches=api)) is None
    assert _reader("post_ms_per_mpair")(Run(batches=api)) == \
        pytest.approx(((500 - 15) + (700 - 19)) / 2e-3)


def _ev(name, cat, ts, dur, **kw):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": kw.pop("pid", 1), "tid": kw.pop("tid", 1)}
    if kw:
        e["args"] = kw
    return e


def test_trace_busy_idle_and_labels():
    events = [
        _ev("window", "user_annotation", 1000, 1000),
        _ev("batch", "user_annotation", 1000, 999),
        _ev("cudaStreamSynchronize", "cuda_runtime", 1300, 200),
        _ev("k", "kernel", 900, 200, pid=0, tid=7, device=0),   # clipped
        _ev("k", "kernel", 1150, 100, pid=0, tid=7, device=0),
        _ev("Memcpy HtoD", "gpu_memcpy", 1200, 100, pid=0, tid=8,
            device=0),                                           # overlaps
        _ev("k", "kernel", 1500, 100, pid=1, tid=7, device=1),
        _ev("other", "cpu_op", 1300, 200, tid=2),  # another thread
    ]
    out = devtrace.reduce_trace(events)
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"][0] == pytest.approx(250e-6)   # 1000-1100, 1150-1300
    assert out["busy_s"][1] == pytest.approx(100e-6)
    assert out["device_s_by_name"]["k"] == pytest.approx(300e-6)
    assert out["device_s_by_name"]["Memcpy HtoD"] == pytest.approx(100e-6)
    gaps = dict(out["idle_gaps"])
    # card 0: 1100-1150 (batch), 1300-2000 (middle 1650: batch);
    # card 1: 1000-1500 (middle 1250: batch), 1600-2000 (batch)
    # 1300-1500 on card 0 has its middle at 1650 -> batch
    assert set(gaps) == {"batch"}
    assert gaps["batch"] == pytest.approx((50 + 700 + 500 + 400) * 1e-6 / 2)
    events.append(_ev("cudaDeviceSynchronize", "cuda_runtime", 1600, 390))
    gaps = dict(devtrace.reduce_trace(events)["idle_gaps"])
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(
        (700 + 400) * 1e-6 / 2)


def test_idle_share_reader():
    trace = {"window_s": 2.0, "busy_s": {0: 0.5}}
    assert _reader("device_idle_pct")(Run(trace=trace, chips=1)) == \
        pytest.approx(75.0)
    # a card that ran nothing counts as idle all through
    assert _reader("device_idle_pct")(Run(trace=trace, chips=2)) == \
        pytest.approx(87.5)
    assert _reader("device_idle_pct")(Run(trace=None, chips=1)) is None
