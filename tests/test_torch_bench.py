"""The port's bench (aim_tpu_torch/tools/bench.py) on the CPU.

The parent keeps bench.py's liveness contract (tests/test_bench_guard.py's
four cases, here with the parent's exit code: 1 wherever the line carries
"error"), never loads the kernels' modules nor CUDA, and a CPU run of the
measurement child on the plain versions prints every key of the line with
the port's scores equal to the oracle's; a score made to differ ends the
child.  Against the reference: bench.py's keys are all emitted but the
documented ones, and the long-read generators' first 256 pairs are
bench.py's byte for byte."""

import ast
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from aim_tpu_torch import cli as tcli
from aim_tpu_torch.config import derive_config
from aim_tpu_torch.tools import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "sample-l100-e1-2K")
# the CPU run's sizes: a few hundred pairs, short-read slopes over 16 pairs
# tiled, long-read slopes over 1 and 2 pairs
CPU_SIZES = dict(n_pairs=200, device="cpu", slope_base=16,
                 long_slope_pairs=(1, 2), nw_long_slope_pairs=(1, 2))


def _last_line(out: str) -> dict:
    return json.loads([l for l in out.splitlines() if l.startswith("{")][-1])


class _Done:
    returncode = 0
    stdout = ""
    stderr = ""


def test_bench_emits_error_json_when_child_hangs(monkeypatch, capsys):
    def timeout_run(*a, **kw):
        raise subprocess.TimeoutExpired(cmd=a[0], timeout=kw.get("timeout"))

    monkeypatch.setattr(bench.subprocess, "run", timeout_run)
    assert bench.main([]) == 1
    rec = _last_line(capsys.readouterr().out)
    assert rec["unit"] == "pairs/s" and rec["value"] == 0.0
    assert "measurement failed" in rec["error"] and "budget" in rec["error"]


def test_bench_emits_degraded_partial_when_child_killed(monkeypatch,
                                                        capsys):
    def fake_run(cmd, **kw):
        partial = cmd[cmd.index("--measure") + 1]
        with open(partial, "w") as f:
            f.write(json.dumps({"metric": bench.HEADLINE, "value": 123456.0,
                                "unit": "pairs/s", "vs_baseline": 0.03,
                                "cpu_1t_pairs_s": 4e6}))
        raise subprocess.TimeoutExpired(cmd=cmd, timeout=kw.get("timeout"))

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    assert bench.main(["--budget", "60"]) == 1
    rec = _last_line(capsys.readouterr().out)
    assert rec["value"] == 123456.0 and rec["cpu_1t_pairs_s"] == 4e6
    assert rec["degraded"] is True
    assert "exceeded 71s budget" in rec["error"]


def test_bench_passes_through_child_json(monkeypatch, capsys):
    payload = {"metric": bench.HEADLINE, "value": 99.0, "unit": "pairs/s",
               "vs_baseline": 1.0}
    seen = []

    def fake_run(cmd, **kw):
        seen.append((cmd, kw))
        r = _Done()
        r.stdout = "# a note\n" + json.dumps(payload) + "\n"
        return r

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    assert bench.main(["--pairs", "5000", "--device", "cpu"]) == 0
    assert _last_line(capsys.readouterr().out) == payload
    (cmd, kw), = seen
    assert cmd[1:4] == ["-m", "aim_tpu_torch.tools.bench", "--measure"]
    assert cmd[5:] == ["--budget", "420.0", "--pairs", "5000", "--device",
                       "cpu"]
    assert kw["timeout"] == 420.0 + 30.0 and kw["cwd"] == REPO


@pytest.mark.parametrize("with_partial", [True, False],
                         ids=["degraded", "nothing_measured"])
def test_bench_child_failure_exits_nonzero(monkeypatch, capsys,
                                           with_partial):
    """A child that fails (a build, a launch, a score that differs) exits
    non-zero: the parent prints what it measured with "error", and exits
    1, where bench.py exits 0."""
    def fake_run(cmd, **kw):
        if with_partial:
            with open(cmd[cmd.index("--measure") + 1], "w") as f:
                f.write(json.dumps({"metric": bench.HEADLINE,
                                    "value": 7.0, "unit": "pairs/s"}))
        r = _Done()
        r.returncode = 1
        r.stderr = "RuntimeError: K2 (nw): 1 score(s) differ"
        return r

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    assert bench.main([]) == 1
    captured = capsys.readouterr()
    rec = _last_line(captured.out)
    assert "rc=1" in rec["error"] and "differ" in rec["error"]
    assert "differ" in captured.err
    assert rec.get("degraded") is (True if with_partial else None)
    assert rec["value"] == (7.0 if with_partial else 0.0)


@pytest.mark.parametrize("budget", ["2"])
def test_bench_wall_clock_bounded_with_hanging_child(budget, capsys):
    # REAL wall clock: the child is a hanging sleep (the child_cmd hook);
    # the parent kills it past budget + grace and still prints a line
    t0 = time.perf_counter()
    rc = bench.main(["--budget", budget], child_cmd=["sleep", "600"])
    wall = time.perf_counter() - t0
    assert wall < 30, f"bench took {wall:.1f}s with a hanging child"
    rec = _last_line(capsys.readouterr().out)
    assert rec["value"] == 0.0 and "error" in rec and rc == 1


@pytest.mark.parametrize("argv", [["--pairs", "0"], ["--budget", "-1"]])
def test_bench_rejects_bad_arguments(argv, capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert e.value.code == 2 and "must be positive" in capsys.readouterr().err


def test_bench_parent_never_reaches_cuda(monkeypatch, capsys):
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **kw: _Done())
    assert bench.main([]) == 1     # the child printed no line
    assert not torch.cuda.is_initialized()
    monkeypatch.undo()
    # in a fresh process: the parent loads neither torch nor a kernel module
    code = ("import sys; from aim_tpu_torch.tools import bench; "
            "rc = bench.main(['--budget', '5'], child_cmd=[sys.executable, "
            "'-c', 'print(1)']); "
            "print(rc, sorted(m for m in sys.modules if m == 'torch' or "
            "m.startswith(('aim_tpu_torch.ops', 'aim_tpu_torch.api'))))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "1 []"


def test_bench_cpu_run_prints_every_key(tmp_path, capsys):
    """The measurement child on the plain versions: every key of the line,
    the scores held to the oracle's inside each stage (a difference
    raises), the partial file equal to the line."""
    partial = str(tmp_path / "partial.json")
    part = bench.measure(partial, 600, **CPU_SIZES)
    captured = capsys.readouterr()
    assert _last_line(captured.out) == part
    assert json.loads(open(partial).read()) == part
    assert [k for k in bench.KEYS if k not in part] == []
    assert "skipped" not in part and "error" not in part
    assert part["device"] == "cpu" and part["n_pairs"] == 200
    assert part["gpu"] is None and part["power_limit_w"] is None
    assert part["marginal_slope_pairs"] == [16 * 8, 16 * 48]
    assert part["nw_slope_pairs"] == [16 * 8, 16 * 32]
    assert part["longread_10kbp_slope_pairs"] == [1, 2]
    assert part["nw_long_4kbp_slope_pairs"] == [1, 2]
    assert part["nw_long_4kbp_flagged_pairs"] in (0, 1, 2)
    assert part["value"] > 0 and part["cpu_1t_pairs_s"] > 0
    # all three times of every best-of-3 on a "#" line
    notes = [l for l in captured.err.splitlines() if l.startswith("# ")]
    assert any(l.startswith("# build:") for l in notes)
    for label in ("api.align 200 pairs", "K1 768 pairs", "K5 2 pairs",
                  "K6 1 pairs", "oracle nw 4000 bp 1 pairs 1 thread"):
        line, = [l for l in notes if l.startswith(f"# {label}:")]
        assert line.count("'") == 6, line


def test_bench_command_on_the_cpu():
    """The command itself, parent and child processes, on the CPU: exit 0
    and a complete line relayed (the long-read slopes over
    CPU_LONG_SLOPE_PAIRS), the child's stderr passed on."""
    r = subprocess.run([sys.executable, "-m", "aim_tpu_torch.tools.bench",
                        "--device", "cpu", "--pairs", "100", "--budget",
                        "600"], capture_output=True, text=True, timeout=900,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = _last_line(r.stdout)
    assert [k for k in bench.KEYS if k not in rec] == []
    assert "skipped" not in rec and "error" not in rec
    assert rec["n_pairs"] == 100 and rec["device"] == "cpu"
    assert rec["marginal_slope_pairs"] == [800, 4800]
    assert rec["longread_10kbp_slope_pairs"] == list(
        bench.CPU_LONG_SLOPE_PAIRS)
    assert "# api.align 100 pairs: best" in r.stderr


@pytest.mark.parametrize("module,fn,stage", [
    ("wfa2", "wfa_forward2", "headline"),
    ("nw", "nw_forward", "K2 (nw)"),
])
def test_bench_score_difference_ends_child(tmp_path, monkeypatch, module,
                                           fn, stage):
    """A kernel whose first score is one off: its stage raises, so the
    child exits non-zero, with what it measured before in the partial
    file."""
    import importlib
    mod = importlib.import_module(f"aim_tpu_torch.ops.{module}")
    orig = getattr(mod, fn)

    def off_by_one(*a, cfg, **kw):
        rec = orig(*a, cfg=cfg, **kw).clone()
        if len(rec):
            rec[0, cfg.max_score + 3 if module == "wfa2" else 1] += 1
        return rec

    monkeypatch.setattr(mod, fn, off_by_one)
    partial = str(tmp_path / "partial.json")
    with pytest.raises(RuntimeError, match=re.escape(f"{stage}: 1 score")):
        bench.measure(partial, 600, **CPU_SIZES)
    part = json.loads(open(partial).read())
    assert part["cpu_1t_pairs_s"] > 0
    assert (part["value"] > 0) == (stage != "headline")
    assert "nw_marginal_us_per_pair" not in part


def _bench_py_keys():
    """The keys bench.py writes into its line: ``part[...] =``,
    ``part.setdefault(...)`` and the ``part = {...}`` literal."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Name) and node.value.id == "part" and \
                isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "setdefault" \
                and isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "part":
            keys.add(node.args[0].value)
        elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == "part"
                for t in node.targets):
            keys.update(k.value for k in node.value.keys)
    return keys


def test_bench_keys_cover_bench_py():
    ref = _bench_py_keys()
    assert len(ref) >= 25 and {"value", "skipped", "degraded"} <= ref
    assert set(bench.NOT_CARRIED) <= ref
    extra = {"skipped", "degraded", "error"}   # the parent's and the gate's
    assert ref - set(bench.KEYS) - set(bench.NOT_CARRIED) - extra == set()
    assert not set(bench.NOT_CARRIED) & set(bench.KEYS)
    assert set(bench.POSITIVE) <= set(bench.KEYS)


@pytest.mark.parametrize("seed,length,algo", [(7, 10000, "wfa"),
                                              (11, 4000, "nw")])
def test_long_pairs_first_256_are_bench_py(seed, length, algo):
    """bench.py's generator (bench.py:228-238 and 278-288) re-run inline."""
    cfg = derive_config(algo, length, 0.01, backtrace=True,
                        adaptive=algo == "wfa", variant="hbm")
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    nl, ll = 256, length
    lp = np.zeros((nl, cfg.read_size), np.uint8)
    lp[:, :ll] = bases[rng.integers(0, 4, (nl, ll))]
    lt = lp.copy()
    mut = rng.random((nl, ll)) < 0.01
    lt[:, :ll] = np.where(mut, bases[rng.integers(0, 4, (nl, ll))],
                          lt[:, :ll])
    lpl = np.full(nl, ll, np.int32)
    for n in (256, 300):
        p, t, pl, tl = bench.long_pairs(seed, length, n, cfg.read_size)
        assert p.shape == t.shape == (n, cfg.read_size)
        np.testing.assert_array_equal(p[:256], lp)
        np.testing.assert_array_equal(t[:256], lt)
        np.testing.assert_array_equal(pl[:256], lpl)
        np.testing.assert_array_equal(tl, np.full(n, ll, np.int32))
    # the pairs past bench.py's draw on from the same generator
    assert (p[256:, :ll] != t[256:, :ll]).mean() == pytest.approx(
        0.0075, abs=0.002)


def test_headline_config_is_the_clis():
    args = tcli.build_parser().parse_args(
        ["wfa", "-i", SAMPLE, "-n", "1", "-l", "100", "-e", "0.01", "-b",
         "-r"])
    cfg = tcli.config_from_args(args)
    assert bench.headline_config() == cfg
    assert (cfg.read_size, cfg.max_score) == (112, 5)


@pytest.mark.parametrize("info,sms,cap,want", [
    # K5 at 10 kbp on an 80 GB card: 7 blocks an SM, one pair a warp; the
    # memory cap holds three waves
    ({"blocks_per_sm": 7, "pairs_per_warp": 1}, 132, 13_030, (3696, 11088)),
    ({"blocks_per_sm": 7, "pairs_per_warp": 1}, 132, 10 ** 6, (3696, 14784)),
    # K6 at 4 kbp: 9 blocks an SM
    ({"blocks_per_sm": 9, "pairs_per_warp": 1}, 132, 10 ** 6, (4752, 19008)),
    ({"blocks_per_sm": 9, "pairs_per_warp": 2}, 2, 10 ** 6, (144, 576)),
])
def test_slope_sizes_are_whole_waves(info, sms, cap, want):
    assert bench.slope_sizes(info, sms, cap) == want


def test_slope_sizes_need_two_waves():
    with pytest.raises(RuntimeError, match="fewer than two waves"):
        bench.slope_sizes({"blocks_per_sm": 7, "pairs_per_warp": 1}, 132,
                          7391)
