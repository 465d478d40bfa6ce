"""What decides `correct`: a sound rehearsal passes; the control (the
plain reference writing mismatches as `M`) and each fault planted in the
program under the harness fail.  All on the CPU at test sizes, through
the rest of a run: the pool, the warm batch, the window, the check."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import run

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def _run(capsys, cell, *extra, pairs=256, seed=2**31 + 17):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.2", "--trace", "0", "--pairs", str(pairs), *extra])
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    for k, v in line["checks"].items():
        assert f"check {k} {v['value']} limit {v['limit']}" in out.err
    return line


@pytest.mark.parametrize("cell", ["wfa100.file", "wfa100.batch20k"])
def test_sound_run_is_correct(capsys, cell):
    line = _run(capsys, cell, "--rehearse")
    assert line["correct"] is True
    assert all(v["value"] == 0 for v in line["checks"].values())


def test_sound_long_read_run_is_correct(capsys):
    line = _run(capsys, "wfa10k.file", "--rehearse", pairs=4)
    assert line["correct"] is True


@pytest.mark.parametrize("cell,pairs", [("wfa100.file", 512),
                                        ("wfa100.batch20k", 512),
                                        ("wfa10k.file", 16)])
def test_control_is_not_correct(capsys, cell, pairs):
    line = _run(capsys, cell, "--control", pairs=pairs)
    assert line["correct"] is False
    assert line["checks"]["cigar_diff"]["value"] > 0
    assert line["metrics"] == {}


def _alter_tokens(monkeypatch):
    from aim_tpu_torch import api
    real = api.align

    def align(*a, **k):
        res = real(*a, **k)
        res.scores[::7] += 1
        for i in range(0, len(res.scores), 5):
            b = res.begin[i]
            res.ops[i, b] = ord("X") if res.ops[i, b] == ord("M") \
                else ord("M")
        return res
    monkeypatch.setattr(api, "align", align)


def _drop_half_file(monkeypatch):
    from aim_tpu_torch import native
    real = native.emit_output

    def emit(path, idx, scores, ops, begin, end, backtrace):
        h = len(idx) // 2
        return real(path, idx[:h], scores[:h], ops[:h], begin[:h], end[:h],
                    backtrace)
    monkeypatch.setattr(native, "emit_output", emit)


def _drop_half_batch(monkeypatch):
    from aim_tpu_torch import api
    real = api.align

    def align(pats, txts, plens, tlens, *a, **k):
        h = len(plens) // 2
        res = real(pats[:h], txts[:h], plens[:h], tlens[:h], *a, **k)
        n = len(plens)
        res.scores = np.concatenate([res.scores,
                                     np.zeros(n - h, np.int32)])
        return res
    monkeypatch.setattr(api, "align", align)


def _no_write(monkeypatch):
    from aim_tpu_torch import native
    monkeypatch.setattr(native, "emit_output", lambda *a, **k: 0)


def _stale_result(monkeypatch):
    from aim_tpu_torch import api
    real = api.align
    first = []

    def align(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]
    monkeypatch.setattr(api, "align", align)


@pytest.mark.parametrize("cell,fault", [
    ("wfa100.file", _alter_tokens),
    ("wfa100.batch20k", _alter_tokens),
    ("wfa100.file", _drop_half_file),
    ("wfa100.batch20k", _drop_half_batch),
    ("wfa100.file", _no_write),
    ("wfa100.batch20k", _stale_result),
])
def test_fault_is_not_correct(capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = _run(capsys, cell, "--rehearse", pairs=512)
    assert line["correct"] is False


def _drop_exchange(monkeypatch):
    """The blocks of the other cards never come back: their records stay
    as allocated, zero."""
    from aim_tpu_torch import api
    real = api._gather

    def gather(parts):
        def zero(p):
            return ({k: np.zeros_like(v) for k, v in p.items()}
                    if isinstance(p, dict) else np.zeros_like(p))
        return real(parts[:1] + [zero(p) for p in parts[1:]])
    monkeypatch.setattr(api, "_gather", gather)


SHARDED = "wfa100.file.4gpu"


def _sharded_cell(monkeypatch):
    """The 4-card cell that PERF.md keeps for later (`file_1m_shard`'s
    traffic over 4 cards), added to the benchmark as a later entry would
    add it; rehearsed, its cards are 4 CPU devices."""
    real = run.load_cell

    def load_cell(name, root=ROOT):
        if name != SHARDED:
            return real(name, root)
        bench, cell, config, _ = real("wfa100.file", root)
        cell = dict(cell, name=SHARDED, traffic="file_1m_shard", chips=4)
        with open(os.path.join(BENCH, "traffic", "file_1m_shard.json")) as f:
            traffic = json.load(f)
        return (dict(bench, workloads=bench["workloads"] + [cell]), cell,
                config, traffic)
    monkeypatch.setattr(run, "load_cell", load_cell)


def test_sound_sharded_run_is_correct(capsys, monkeypatch):
    _sharded_cell(monkeypatch)
    line = _run(capsys, SHARDED, "--rehearse", pairs=512)
    assert line["correct"] is True


def test_exchange_left_out_is_not_correct(capsys, monkeypatch):
    _sharded_cell(monkeypatch)
    _drop_exchange(monkeypatch)
    line = _run(capsys, SHARDED, "--rehearse", pairs=512)
    assert line["correct"] is False


def test_fault_in_long_reads_is_not_correct(capsys, monkeypatch):
    _alter_tokens(monkeypatch)
    line = _run(capsys, "wfa10k.file", "--rehearse", pairs=4)
    assert line["correct"] is False


def test_no_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run exits with an error and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for extra in ([], ["--rehearse"]):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "wfa100.file",
             "--seed", "5", "--seconds", "1", "--trace", "0", *extra],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=120)
        assert out.returncode != 0
        assert out.stdout.strip() == ""


def test_no_card_no_result(capsys):
    """Without the cards a cell asks for, no result (here: no CUDA)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    rc = run.main(["--workload", "wfa100.file", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""


@pytest.mark.gpu
def test_one_cell_on_the_card():
    """A short run of the first cell on the card: correct, with its
    metrics and device block."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "wfa100.file",
         "--seed", "12345", "--seconds", "3", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert "k1_roofline" in line["metrics"]
