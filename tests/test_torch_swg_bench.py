"""The benchmark's SWG configuration (``swg_affine_l100_e1``, cell
``swg100.batch20k``) on the CPU: its plain reference
(``benchmark/reference/swg.py``) against the port's native oracle on every
aliasing case of the flat tape and both cell widths, the port's library
path against the reference, the cell rehearsed and its control, the
reference's frozen work counts, the K3 roofline reader's kernel name, and
the ladder's counters in a call's record.  The harness is imported by
path, as ``tests/test_torch_trace.py`` does.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from aim_tpu_torch import api as tapi
from aim_tpu_torch import native, spans
from aim_tpu_torch.config import derive_config
from aim_tpu_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
SAMPLE = os.path.join(REPO, "data", "sample-l100-e1-2K")
CELL = "swg100.batch20k"
SWG_JSON = os.path.join(BENCH, "configs", "swg_affine_l100_e1.json")


@pytest.fixture(scope="module")
def harness():
    """The harness's modules, imported from ``benchmark/``."""
    sys.path.insert(0, BENCH)
    try:
        import drive
        import gen
        import run
        from reference import emit, swg
        yield {"drive": drive, "gen": gen, "run": run, "emit": emit,
               "swg": swg}
    finally:
        sys.path.remove(BENCH)


@pytest.fixture(scope="module")
def config():
    with open(SWG_JSON) as f:
        return json.load(f)


def _oracle(pats, txts, plens, tlens, c):
    return native.swg_align(
        pats, txts, plens, tlens, match=c["match"],
        mismatch=c["mismatch"], gap_o=c["gap_opening"],
        gap_e=c["gap_extending"], max_score=c["max_score"],
        cell_width=c["cell_width"], backtrace=True)


def _segments(emit, ops, begin, end):
    return [emit.segment(ops[i], int(begin[i]), int(end[i]))
            for i in range(len(begin))]


def _assert_equal(emit, got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert _segments(emit, *got[1:4]) == _segments(emit, *want[1:4])


def _cut(pairs, seed, case):
    """The pairs with their lengths cut to one aliasing case of the flat
    tape: plen == tlen + 1, plen > tlen + 1, or plen < tlen."""
    pats, txts, plens, tlens = (a.copy() for a in pairs)
    rng = np.random.default_rng(seed)
    n, size = pats.shape
    if case == "alias_one":
        tlens = plens - 1
    elif case == "alias_many":
        tlens = plens - rng.integers(2, 40, n).astype(np.int32)
    else:
        plens = tlens - rng.integers(1, 40, n).astype(np.int32)
    col = np.arange(size)[None, :]
    pats[col >= plens[:, None]] = 0
    txts[col >= tlens[:, None]] = 0
    return pats, txts, plens.astype(np.int32), tlens.astype(np.int32)


def _random(n, size, seed):
    """Unrelated pairs of random lengths up to ``size``: their cells pass
    127, so the int8 tape wraps."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(1, size + 1, n).astype(np.int32)
    tlens = rng.integers(1, size + 1, n).astype(np.int32)
    bases = np.frombuffer(b"ACGT", np.uint8)
    col = np.arange(size)[None, :]
    pats = np.where(col < plens[:, None],
                    bases[rng.integers(0, 4, (n, size))], 0).astype(np.uint8)
    txts = np.where(col < tlens[:, None],
                    bases[rng.integers(0, 4, (n, size))], 0).astype(np.uint8)
    return pats, txts, plens, tlens


# ---- (a) the reference against the native oracle --------------------------

@pytest.mark.parametrize("width,max_score", [(1, 5), (2, 130)],
                         ids=["int8", "int16"])
@pytest.mark.parametrize("case", ["sample", "alias_one", "alias_many",
                                  "shorter", "wrapping"])
def test_reference_equals_native_oracle(harness, config, case, width,
                                        max_score):
    c = dict(config, cell_width=width, max_score=max_score)
    if case == "sample":
        pairs = native.parse_pairs(SAMPLE, 1000, c["read_size"])
    elif case == "wrapping":
        pairs = _random(24, 140, seed=11)
    else:
        base = harness["gen"].generate(
            300 if case == "alias_one" else 40, 100, 0.01, 2**33 + 3, 0,
            size=c["read_size"])
        pairs = _cut(base, 5, case)
    pats, txts, plens, tlens = pairs
    if case == "alias_one":
        assert (plens == tlens + 1).all()
    elif case == "alias_many":
        assert (plens > tlens + 1).all()
    elif case == "shorter":
        assert (plens < tlens).all()
    ref = harness["swg"].run(pats, txts, plens, tlens, c)
    _assert_equal(harness["emit"], ref, _oracle(pats, txts, plens, tlens, c))


def test_generated_pairs_alias_a_third(harness, config):
    """At one edit a pair, an insertion leaves plen == tlen + 1: the
    aliased column is the common case, not an edge."""
    _, _, plens, tlens = harness["gen"].generate(
        3000, 100, 0.01, 2**40 + 9, 0, size=config["read_size"])
    share = float(np.mean(plens == tlens + 1))
    assert 0.25 < share < 0.42
    assert (np.abs(plens - tlens) <= 1).all()


# ---- (b) the port's library path against the reference --------------------

def test_config_is_the_clis(harness, config):
    cfg = harness["drive"].cli_config(config)
    assert cfg == derive_config("swg", 100, 0.01, backtrace=True)
    assert (cfg.read_size, cfg.max_score) == (config["read_size"],
                                              config["max_score"])
    assert (cfg.match, cfg.mismatch, cfg.gap_o, cfg.gap_e) == (
        config["match"], config["mismatch"], config["gap_opening"],
        config["gap_extending"])
    assert cfg.cell_width == config["cell_width"] == 1
    assert kernels.forward_fn(cfg).name == "K3"
    # int8 cells keep SWG off the streamed tier: K3's ladder has no stage
    assert tapi._retry_stages(kernels.forward_fn(cfg)) == ()


def test_port_equals_reference(harness, config):
    cfg = harness["drive"].cli_config(config)
    pats, txts, plens, tlens = harness["gen"].generate(
        3000, 100, 0.01, 2**35 + 21, 0, size=config["read_size"])
    res = tapi.align(pats, txts, plens, tlens, cfg, device="cpu")
    ref = harness["swg"].run(pats, txts, plens, tlens, config)
    _assert_equal(harness["emit"], (res.scores, res.ops, res.begin, res.end),
                  ref)
    # (e) one edit a pair: K3 flags nothing, and the record says so
    assert res.spans.counts["flagged_pairs"] == 0
    assert res.spans.counts["retry_pairs"] == 0
    assert res.spans.counts["fallback_pairs"] == 0
    row = spans.calls()[-1]
    assert row["entry"] == "align" and row["pairs"] == 3000
    assert [row[c] for c in ("flagged_pairs", "retry_pairs",
                             "fallback_pairs")] == [0, 0, 0]


# ---- (c) the cell rehearsed, and its control -------------------------------

def _seed_checking_the_first_batch(gen, traffic):
    """A large seed whose window's first batch is one the check keeps, so a
    window of one batch is compared (drive.ApiBatch draws both)."""
    pool, k = traffic["pool_batches"], traffic["check_batches"]
    seed = 2**33 + 77
    while int(gen.rng(seed, 2).permutation(pool)[0]) not in set(
            gen.rng(seed, 1000).choice(pool, k, replace=False).tolist()):
        seed += 1
    return seed


def _run_cell(harness, *extra, pairs=2000):
    """``benchmark/run.py`` on the cell at ``pairs`` pairs a batch, in a
    process of its own (this one has loaded jax): its result line and
    stderr."""
    with open(os.path.join(BENCH, "traffic", "api_20k.json")) as f:
        seed = _seed_checking_the_first_batch(harness["gen"], json.load(f))
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", CELL,
         "--seed", str(seed), "--seconds", "0.2", "--trace", "0", "--pairs",
         str(pairs), *extra], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def test_rehearsal_is_correct(harness):
    line, err = _run_cell(harness, "--rehearse")
    assert line["correct"] is True and line["mode"] == "rehearse"
    assert all(v["value"] == 0 for v in line["checks"].values())
    assert line["attempted"] >= 2000
    assert float(re.search(r"check_s=([0-9.]+)", err).group(1)) > 0


def test_control_is_not_correct(harness):
    # 6 pairs a batch: the reference runs in the process, not on a pool
    # of processes a batch (drive.py), in the 8 batches the check keeps
    line, _ = _run_cell(harness, "--control", pairs=6)
    assert line["attempted"] == 8 * 6
    assert line["correct"] is False
    assert line["checks"]["cigar_diff"]["value"] > 0
    assert line["checks"]["score_diff"]["value"] == 0
    assert line["metrics"] == {}


# ---- (d) the frozen work counts --------------------------------------------

def test_work_is_a_hand_count(harness):
    swg = harness["swg"]
    p = np.array([3, 4, 5])
    t = np.array([3, 3, 5])
    s = np.array([0, 5, 9])
    # K = max(|t - p|, max(0, S - 4) // 1): 0, 1, 5 (the whole 5 x 5)
    cells = swg.band_cells(p, t, s, 4, 1)
    assert cells.tolist() == [3, 2 + 3 + 3, 25]
    # bytes: ceil(p/4) + ceil(t/4) + 4 + ceil(max(p, t)/4)
    assert swg.work(p, t, cells) == (7 + 7 + 10, 14 * (3 + 8 + 25))


def test_work_counts_the_band_of_the_score(harness, config):
    swg = harness["swg"]
    pats, txts, plens, tlens = harness["gen"].generate(
        200, 100, 0.01, 2**34 + 1, 0, size=config["read_size"])
    scores, *_, cells = swg.run(pats, txts, plens, tlens, config)
    for i in range(len(cells)):
        k = max(abs(int(tlens[i]) - int(plens[i])),
                max(0, int(scores[i]) - 4))
        want = sum(1 for h in range(1, tlens[i] + 1)
                   for v in range(1, plens[i] + 1) if abs(h - v) <= k)
        assert cells[i] == want


# ---- the K3 roofline reader ------------------------------------------------

def _kernel_names():
    names = {}
    csrc = os.path.join(REPO, "aim_tpu_torch", "csrc")
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                text = fh.read()
            for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                                 r"(\w+)\s*\(", text):
                names[m.group(1)] = f
    return names


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k3_reader_names_k3_alone(harness):
    kernel = _reader("k3_roofline").KERNEL
    names = _kernel_names()
    assert {"swg_kernel", "swg_seg_kernel", "fwd_kernel",
            "walk_kernel"} <= set(names)
    assert {n for n in names if kernel in n} == {"swg_kernel",
                                                "swg_seg_kernel"}
    assert {names[n] for n in names if kernel in n} == {"swg.cu"}


def test_k3_reader_reads_k3_time(harness, config):
    roofline = sys.modules["roofline"]
    mod = _reader("k3_roofline")
    work = (80_000, 14 * 4_000_000)

    class Entry:
        def work(self, unit):
            return work

    k3 = {"void (anonymous namespace)::swg_seg_kernel<16>("
          "aimband::SegParams)": 2e-4,
          "void (anonymous namespace)::swg_kernel<2>("
          "aimband::BandParams)": 1e-4}
    others = {"void (anonymous namespace)::fwd_kernel<1>("
              "(anonymous namespace)::LongParams)": 5.0,
              "void (anonymous namespace)::walk_kernel("
              "(anonymous namespace)::LongParams)": 5.0,
              "Memcpy DtoH (Device -> Pinned)": 1.0}
    card = next(iter(roofline.PEAKS))
    run = harness["run"].Run(
        trace={"device_s_by_name": dict(k3, **others)},
        batches=[{"unit": 0}, {"unit": 1}], entry=Entry(), card=card)
    want = 100 * roofline.bound_s(2 * work[0], 2 * work[1], card) / 3e-4
    assert mod.read(run) == pytest.approx(want)
    assert 0 < mod.read(run) <= 100
    run.trace = {"device_s_by_name": others}
    assert mod.read(run) is None


# ---- (e) the ladder's counters ---------------------------------------------

def test_counters_read_the_flagged_pairs(harness, config):
    """Pairs with plen > tlen + 1 are flagged by K3 and, with no wider
    band for int8 cells, computed by the oracle."""
    cfg = harness["drive"].cli_config(config)
    pats, txts, plens, tlens = harness["gen"].generate(
        64, 100, 0.01, 2**36 + 5, 0, size=config["read_size"])
    cut = _cut((pats[:7], txts[:7], plens[:7], tlens[:7]), 3, "alias_many")
    for a, b in zip((pats, txts, plens, tlens), cut):
        a[:7] = b
    res = tapi.align(pats, txts, plens, tlens, cfg, device="cpu")
    assert res.n_fallback == 7 and res.n_retry == 0
    assert res.spans.counts["flagged_pairs"] == 7
    assert res.spans.counts["fallback_pairs"] == 7
    assert res.spans.counts["retry_pairs"] == 0
    want = _oracle(pats, txts, plens, tlens, config)
    _assert_equal(harness["emit"], (res.scores, res.ops, res.begin, res.end),
                  want)


def test_counters_read_the_ladder(harness):
    """NW at 10 % edits: K2 flags, the streamed tier's wider bands certify
    some (retry), the oracle takes the rest (fallback)."""
    cfg = derive_config("nw", 100, 0.01, backtrace=True)
    pats, txts, plens, tlens = harness["gen"].generate(
        64, 100, 0.1, 2**33 + 13, 0, size=cfg.read_size)
    res = tapi.align(pats, txts, plens, tlens, cfg, device="cpu")
    c = res.spans.counts
    assert res.n_retry > 0 and res.n_fallback > 0
    assert c["retry_pairs"] == res.n_retry
    assert c["fallback_pairs"] == res.n_fallback
    assert c["flagged_pairs"] == res.n_retry + res.n_fallback
    assert spans.calls()[-1]["retry_pairs"] == res.n_retry
