"""The port's timing helpers (aim_tpu_torch/tools/timing.py), on the
host-clock path, as tests/test_timing.py holds tools/_timing.py: ~0
anchors are rejected, the host opt-out times what it is given, and the
interleaved A/B protocol alternates its arms in one process.  CUDA events
time device work on the card (tests/test_torch_gpu.py)."""

import time

import numpy as np
import pytest
import torch

from aim_tpu_torch.tools import timing as T


def test_best_of_rejects_zero_anchor():
    with pytest.raises(T.SuspectTimingError):
        T.best_of(lambda: None, repeats=2)


def test_best_of_host_optout_and_value():
    t = T.best_of(lambda: time.sleep(0.002), repeats=2, min_anchor_s=0)
    assert 0.001 < t < 0.5


def test_best_of_warms_up_then_repeats():
    calls = []
    T.best_of(lambda: calls.append(1) or time.sleep(0.002), repeats=3,
              min_anchor_s=0)
    assert len(calls) == 4
    calls.clear()
    T.best_of(lambda: calls.append(1) or time.sleep(0.002), repeats=3,
              min_anchor_s=0, warmup=False)
    assert len(calls) == 3


def test_best_of_times_cpu_tensors_on_the_host_clock():
    x = torch.arange(256, dtype=torch.int32)
    t = T.best_of(lambda: torch.cumsum(x, 0), repeats=2,
                  device=torch.device("cpu"), min_anchor_s=0)
    assert t >= 0


def test_marginal_us_is_the_slope():
    assert T.marginal_us(lambda m: m * 2e-6, 10, 110) == pytest.approx(2.0)


def test_interleaved_ab_alternates():
    order = []

    def a():
        order.append("a")
        time.sleep(0.002)
        return np.zeros(1)

    def b():
        order.append("b")
        time.sleep(0.002)
        return np.zeros(1)

    ba, bb, ta, tb = T.interleaved_ab(a, b, rounds=3, min_anchor_s=1e-4)
    # warmup a,b then strict a/b alternation
    assert order == ["a", "b"] + ["a", "b"] * 3
    assert len(ta) == len(tb) == 3
    assert ba > 0 and bb > 0


def test_interleaved_ab_rejects_zero_anchor():
    z = np.zeros(1)
    with pytest.raises(T.SuspectTimingError):
        T.interleaved_ab(lambda: z, lambda: z, rounds=2)
