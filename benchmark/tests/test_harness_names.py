"""BENCHMARK.json against the contract's shape: keys, names, units and
the files each name leads to; and a configuration, a mix and a metric
added by files and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) <= 64 * 1024


def test_configs():
    b = _bench()
    assert 1 <= len(b["configs"]) <= 24
    used = {w["config"] for w in b["workloads"]}
    files = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(b["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(BENCH, "reference",
                                           cfg["reference"] + ".py"))


def test_workloads():
    b = _bench()
    assert 1 <= len(b["workloads"]) <= 24
    names = [w["name"] for w in b["workloads"]]
    assert len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(names)
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(names) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))


def test_metrics():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    all_names = list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(set(all_names)) == len(all_names)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    layers = {}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        layers.setdefault(m.get("layer"), set())
    for cell in cells:
        mine = [m for m in b["end_to_end"]
                if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])
        for m in b["per_layer"]:
            if cell in m.get("workloads", cells):
                assert cell in e2e[m["moves"]].get("workloads", cells)


def test_files_under_paths_are_named_from_names():
    for dirpath, dirnames, filenames in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in filenames:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH.match(rel), rel


def test_added_by_files_alone(tmp_path):
    """A new configuration, mix and metric, and a cell that uses them, are
    new files and entries: the harness runs them unchanged."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = _bench()
    with open(os.path.join(BENCH, "configs",
                           "wfa_adaptive_l100_e1.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "wfa_adaptive_l150_e2"
    cfg["cli"] = ["wfa", "-l", "150", "-e", "0.02", "-b", "-r"]
    cfg.update(read_length=150, error=0.02, read_size=160, max_score=15)
    (root / "benchmark/configs/wfa_adaptive_l150_e2.json").write_text(
        json.dumps(cfg))
    (root / "benchmark/traffic/file_tiny.json").write_text(json.dumps(
        {"entry": "cli_file", "files": 3, "pairs_per_file": 300,
         "check_pairs_per_file": 300}))
    (root / "benchmark/metrics/batches_n.py").write_text(
        "def read(run):\n    return float(len(run.batches))\n")
    b["configs"].append({"name": cfg["name"], "source": cfg["source"],
                         "file": "benchmark/configs/wfa_adaptive_l150_e2.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "wfa150.tiny", "config": cfg["name"],
                           "traffic": "file_tiny", "chips": 1, "why": "t"})
    b["end_to_end"].append({"name": "batches_n", "unit": "batches",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["wfa150.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "wfa150.tiny",
         "--seed", "4294967311", "--seconds", "0.3", "--trace", "0",
         "--rehearse"], cwd=root, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["cpu_rehearsal.batches_n"]["value"] >= 1
    assert "cpu_rehearsal.pairs_s" in line["metrics"]


NW_REFERENCE = '''"""Plain NumPy Needleman-Wunsch score: global, minimising, linear gaps."""

import numpy as np


def run(pats, txts, plens, tlens, config, control=False):
    n, R = pats.shape
    x, g = config["mismatch"], config["gap"]
    rows = np.arange(n)
    prev = np.tile(np.arange(R + 1) * g, (n, 1))
    scores = np.where(tlens == 0, prev[rows, plens], 0)
    for h in range(1, R + 1):
        cur = np.empty_like(prev)
        cur[:, 0] = h * g
        diag = prev[:, :-1] + x * (pats != txts[:, h - 1:h])
        up = prev[:, 1:] + g
        for v in range(1, R + 1):
            cur[:, v] = np.minimum(np.minimum(diag[:, v - 1], up[:, v - 1]),
                                   cur[:, v - 1] + g)
        scores = np.where(tlens == h, cur[rows, plens], scores)
        prev = cur
    return scores.astype(np.int32) + int(control), None, None, None, None
'''


def test_another_family_added_by_files_alone(tmp_path):
    """A configuration of another family (NW, scores only) with a plain
    reference of its own, its mix and a cell, are new files and entries
    alone: neither drive.py nor roofline.py knows the family."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = _bench()
    cfg = {"name": "nw_l100_e1", "source": "https://github.com/safaad/aim",
           "cli": ["nw", "-l", "100", "-e", "0.01"], "algo": "nw",
           "read_length": 100, "error": 0.01, "read_size": 112,
           "mismatch": 3, "gap": 4, "backtrace": False,
           "reference": "nw_score", "reduced": []}
    (root / "benchmark/configs/nw_l100_e1.json").write_text(json.dumps(cfg))
    (root / "benchmark/reference/nw_score.py").write_text(NW_REFERENCE)
    (root / "benchmark/traffic/api_tiny.json").write_text(json.dumps(
        {"entry": "api_batch", "pool_batches": 3, "pairs_per_batch": 200,
         "check_batches": 3}))
    b["configs"].append({"name": cfg["name"], "source": cfg["source"],
                         "file": "benchmark/configs/nw_l100_e1.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "nw100.tiny", "config": cfg["name"],
                           "traffic": "api_tiny", "chips": 1, "why": "t"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    env = dict(os.environ, PYTHONPATH=ROOT)
    for control, want in ((False, True), (True, False)):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "nw100.tiny",
             "--seed", "4294967357", "--seconds", "0.3", "--trace", "0",
             "--rehearse" if not control else "--control"], cwd=root,
            env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is want, line["checks"]
    assert line["checks"]["score_diff"]["value"] > 0
