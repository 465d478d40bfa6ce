"""The benchmark's GenASM configuration (``genasm_l100_e1``, cell
``genasm100.batch20k``) on the CPU: its plain reference
(``benchmark/reference/genasm.py``) against the port's GenASM oracle on
generated pairs and edge cases, and against the NW walker at unit costs
(the rule's external anchor), the port's library path against the
reference, the cell rehearsed and its control, the reference's frozen
work counts, the K4 roofline reader's kernel name, and the
``over_k_pairs`` counter.  The harness is imported by path, as
``tests/test_torch_trace.py`` does.
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
from aim_tpu_torch.ops import genasm, kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
CELL = "genasm100.batch20k"
GENASM_JSON = os.path.join(BENCH, "configs", "genasm_l100_e1.json")
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def harness():
    """The harness's modules, imported from ``benchmark/``."""
    sys.path.insert(0, BENCH)
    try:
        import drive
        import gen
        import run
        from reference import emit
        from reference import genasm as ref
        yield {"drive": drive, "gen": gen, "run": run, "emit": emit,
               "ref": ref}
    finally:
        sys.path.remove(BENCH)


@pytest.fixture(scope="module")
def config():
    with open(GENASM_JSON) as f:
        return json.load(f)


def _segments(emit, ops, begin, end):
    return [emit.segment(ops[i], int(begin[i]), int(end[i]))
            for i in range(len(begin))]


def _assert_equal(emit, got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert _segments(emit, *got[1:4]) == _segments(emit, *want[1:4])


def _rows(seqs, size):
    """Byte strings as ``[n, size]`` rows padded with 0, and their
    lengths."""
    rows = np.zeros((len(seqs), size), np.uint8)
    for i, s in enumerate(seqs):
        rows[i, :len(s)] = np.frombuffer(s, np.uint8)
    return rows, np.array([len(s) for s in seqs], np.int32)


def _pairs(pairs, size):
    pats, plens = _rows([p for p, _ in pairs], size)
    txts, tlens = _rows([t for _, t in pairs], size)
    return pats, txts, plens, tlens


def _substituted(rng, n, length, d):
    """``n`` random patterns of ``length`` bases, each text with ``d``
    substitutions at distinct positions."""
    out = []
    for _ in range(n):
        p = BASES[rng.integers(0, 4, length)]
        t = p.copy()
        at = rng.choice(length, d, replace=False)
        t[at] = BASES[(np.searchsorted(BASES, p[at])
                       + rng.integers(1, 4, d)) % 4]
        out.append((p.tobytes(), t.tobytes()))
    return out


def _case(name, size, seed):
    """The pairs of one edge case, at most ``size`` bases a sequence."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return BASES[rng.integers(0, 4, n)].tobytes()

    if name == "empty":
        return [(b"", b""), (b"", rand(1)), (rand(1), b""), (b"", rand(2)),
                (rand(2), b""), (b"", rand(3)), (rand(3), b""),
                (b"", rand(size)), (rand(size), b"")]
    if name == "longer_pattern":
        # plen > tlen: a text cut short, within and past k
        return [(p, p[:len(p) - c]) for p in (rand(int(rng.integers(4, size)))
                                              for _ in range(40))
                for c in (1, 2, 3)]
    if name == "longer_text":
        return [(p[c:], p) for p in (rand(int(rng.integers(4, size)))
                                     for _ in range(40)) for c in (1, 2, 3)]
    if name == "distance_k":
        return _substituted(rng, 60, size - 12, 2)
    if name == "distance_k_plus_1":
        return _substituted(rng, 60, size - 12, 3)
    if name == "all_mismatch":
        return [(b"A" * n, b"C" * n) for n in (1, 2, 3, 4, 17, size)] \
            + [(b"AC" * (n // 2), b"GT" * (n // 2)) for n in (2, 4, 40)]
    # two-letter sequences, full of runs of one base: the walk's ties
    def two(n):
        return BASES[2 * rng.integers(0, 2, n)].tobytes()

    return [(two(int(rng.integers(1, size))), two(int(rng.integers(1, size))))
            for _ in range(120)]


CASES = ["empty", "longer_pattern", "longer_text", "distance_k",
         "distance_k_plus_1", "all_mismatch", "ties"]


# ---- (a) the reference against the port's GenASM oracle -------------------

def test_reference_equals_oracle_on_generated_pairs(harness, config):
    pats, txts, plens, tlens = harness["gen"].generate(
        1500, 100, 0.01, 2**37 + 11, 0, size=config["read_size"])
    ref = harness["ref"].run(pats, txts, plens, tlens, config)
    want = native.genasm_align(pats, txts, plens, tlens,
                               max_score=config["max_score"], backtrace=True)
    _assert_equal(harness["emit"], ref, want)
    # one edit a pair: every distance is 1, and every pair is walked
    assert (ref[0] == 1).all()


@pytest.mark.parametrize("k", [2, 40])
@pytest.mark.parametrize("case", CASES)
def test_reference_equals_oracle_on_edge_cases(harness, case, k):
    size = 112
    pats, txts, plens, tlens = _pairs(_case(case, size, 7), size)
    ref = harness["ref"].align(pats, txts, plens, tlens, max_score=k)
    want = native.genasm_align(pats, txts, plens, tlens, max_score=k,
                               backtrace=True)
    _assert_equal(harness["emit"], ref, want)
    np.testing.assert_array_equal(ref[2], want[2])
    np.testing.assert_array_equal(ref[3], want[3])
    exact = native.genasm_align(pats, txts, plens, tlens, max_score=size,
                                backtrace=False)[0]
    if case == "distance_k" and k == 2:
        assert (exact == 2).any() and (ref[0] == 2).any()
    if case == "distance_k_plus_1" and k == 2:
        assert (exact == 3).any() and (ref[0] == 3).all()
    if case == "all_mismatch":
        # past k: k + 1 and no walk; within k: every op a mismatch
        np.testing.assert_array_equal(ref[0], np.minimum(exact, k + 1))
        for i in np.nonzero(exact <= k)[0]:
            seg = harness["emit"].segment(ref[1][i], int(ref[2][i]),
                                          int(ref[3][i]))
            assert seg == b"X" * int(plens[i])


def test_reference_score_only(harness, config):
    pats, txts, plens, tlens = _pairs(_case("ties", 112, 3), 112)
    c = dict(config, backtrace=False)
    scores, ops, begin, end, levels = harness["ref"].run(
        pats, txts, plens, tlens, c)
    assert ops is None and begin is None and end is None
    np.testing.assert_array_equal(scores, native.genasm_align(
        pats, txts, plens, tlens, max_score=2, backtrace=False)[0])
    assert (levels == 3).all()


def test_reference_blocks_agree(harness):
    pats, txts, plens, tlens = _pairs(_case("ties", 112, 5), 112)
    whole = harness["ref"].align(pats, txts, plens, tlens, max_score=5)
    cut = harness["ref"].align(pats, txts, plens, tlens, max_score=5,
                               block=7)
    _assert_equal(harness["emit"], cut, whole)


# ---- the external anchor: the NW walker at unit costs ---------------------

@pytest.mark.parametrize("case", ["generated"] + CASES)
def test_reference_equals_nw_within_k(harness, config, case):
    size = config["read_size"]
    if case == "generated":
        pairs = harness["gen"].generate(1000, 100, 0.01, 2**38 + 5, 0,
                                        size=size)
        k = config["max_score"]
    else:
        pairs = _pairs(_case(case, size, 9), size)
        k = 40
    ref = harness["ref"].align(*pairs, max_score=k)
    nw = native.nw_align(*pairs, mismatch=1, gap_i=1, gap_d=1,
                         backtrace=True)
    # the NW oracle's flat tape (row stride tlen + 1) is the proper table
    # for non-empty pairs with plen <= tlen + 1; past that it aliases
    plens, tlens = pairs[2], pairs[3]
    flat_ok = (plens >= 1) & (tlens >= 1) & (plens <= tlens + 1)
    within = np.nonzero((ref[0] <= k) & flat_ok)[0]
    assert len(within) or case == "empty"
    np.testing.assert_array_equal(ref[0][within], nw[0][within])
    emit = harness["emit"]
    assert [emit.segment(ref[1][i], int(ref[2][i]), int(ref[3][i]))
            for i in within] == \
        [emit.segment(nw[1][i], int(nw[2][i]), int(nw[3][i]))
         for i in within]


# ---- (b) the port's library path against the reference --------------------

def test_config_is_the_clis(harness, config):
    cfg = harness["drive"].cli_config(config)
    assert cfg == derive_config("genasm", 100, 0.01, backtrace=True)
    assert (cfg.read_size, cfg.max_score) == (config["read_size"],
                                              config["max_score"]) == (112, 2)
    assert (cfg.mismatch, cfg.gap_i, cfg.gap_d) == (
        config["mismatch"], config["gap_i"], config["gap_d"]) == (1, 1, 1)
    assert cfg.backtrace is config["backtrace"] is True
    assert cfg.variant == config["variant"]
    tier = kernels.forward_fn(cfg)
    assert tier.name == "K4" and tier.records == kernels.GENASM_RECORDS
    # the segmented path, 16 lanes and two pairs a warp, the history
    # windowed in shared memory; 116 record rows a pair
    assert genasm.seg_lanes(cfg) == 16 and genasm.pairs_per_warp(cfg) == 2
    assert genasm.hist_windowed(cfg) and genasm.hist_in_smem(cfg)
    assert tier.device_bytes_per_pair == 2 * 120 // 4 + 8 + 4 * 116


def test_port_equals_reference(harness, config):
    cfg = harness["drive"].cli_config(config)
    pats, txts, plens, tlens = harness["gen"].generate(
        3000, 100, 0.01, 2**35 + 23, 0, size=config["read_size"])
    res = tapi.align(pats, txts, plens, tlens, cfg, device="cpu")
    ref = harness["ref"].run(pats, txts, plens, tlens, config)
    _assert_equal(harness["emit"], (res.scores, res.ops, res.begin, res.end),
                  ref)
    c = res.spans.counts
    # 116 int32 rows a pair come down, and every pair is walked
    assert c["d2h_bytes"] == 3000 * (config["read_size"] + 4) * 4
    assert c["over_k_pairs"] == 0 and c["flagged_pairs"] == 0
    row = spans.calls()[-1]
    assert row["entry"] == "align" and row["pairs"] == 3000
    assert row["over_k_pairs"] == 0


def test_port_equals_reference_past_k(harness, config):
    """Pairs at 1 % and 5 % edits: those at five pass k = 2, and the port
    scores them k + 1 with no walk, as the reference does."""
    cfg = harness["drive"].cli_config(config)
    pats, txts, plens, tlens = (np.concatenate(a) for a in zip(*(
        harness["gen"].generate(200, 100, e, 2**36 + 3, 0,
                                size=config["read_size"])
        for e in (0.01, 0.05))))
    res = tapi.align(pats, txts, plens, tlens, cfg, device="cpu")
    ref = harness["ref"].run(pats, txts, plens, tlens, config)
    _assert_equal(harness["emit"], (res.scores, res.ops, res.begin, res.end),
                  ref)
    over = int((ref[0] > cfg.max_score).sum())
    assert 0 < over < 400
    assert res.spans.counts["over_k_pairs"] == over


# ---- (c) the cell rehearsed, and its control -------------------------------

def _seed_checking_the_first_batch(gen, traffic):
    """A large seed whose window's first batch is one the check keeps, so a
    window of one batch is compared (drive.ApiBatch draws both)."""
    pool, k = traffic["pool_batches"], traffic["check_batches"]
    seed = 2**34 + 91
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
    ref = harness["ref"]
    p = np.array([31, 32, 100, 0])
    t = np.array([30, 33, 101, 5])
    levels = np.full(4, 3)
    # words of plen + 1 bits: 1, 2, 4, 1
    ops = 6 * 3 * (30 * 1 + 33 * 2 + 101 * 4 + 5 * 1)
    # bytes: ceil(p/4) + ceil(t/4) + 4 + ceil(max(p, t)/4)
    n_bytes = (8 + 8 + 4 + 8) + (8 + 9 + 4 + 9) + (25 + 26 + 4 + 26) \
        + (0 + 2 + 4 + 2)
    assert ref.work(p, t, levels) == (n_bytes, ops)


def test_work_is_the_kernel_tables_count(harness, config):
    """The count of PERF.md's kernel table: 6 int32 ops a 32-bit word, a
    distance level and a text position (chip_smoke.py's CELL_OPS)."""
    pats, txts, plens, tlens = harness["gen"].generate(
        50, 100, 0.01, 2**34 + 7, 0, size=config["read_size"])
    *_, levels = harness["ref"].run(pats, txts, plens, tlens, config)
    assert (levels == config["max_score"] + 1).all()
    words = -(-(plens.astype(np.int64) + 1) // 32)
    want = 6 * (config["max_score"] + 1) * int(
        (tlens.astype(np.int64) * words).sum())
    assert harness["ref"].work(plens, tlens, levels)[1] == want


# ---- the K4 roofline reader ------------------------------------------------

def _kernel_names():
    names = {}
    csrc = os.path.join(REPO, "aim_tpu_torch", "csrc")
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                text = fh.read()
            for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__"
                                 r"\([^)]*\)\s*)?(\w+)\s*\(", text):
                names[m.group(1)] = f
    return names


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k4_reader_names_k4_alone(harness):
    kernel = _reader("k4_roofline").KERNEL
    names = _kernel_names()
    assert {"genasm_seg_kernel", "genasm_wide_kernel", "swg_seg_kernel",
            "nw_kernel", "wfa2_kernel", "fwd_kernel"} <= set(names)
    assert {n for n in names if kernel in n} == {"genasm_seg_kernel",
                                                "genasm_wide_kernel"}
    assert {names[n] for n in names if kernel in n} == {"genasm.cu"}


def test_k4_reader_reads_k4_time(harness):
    roofline = sys.modules["roofline"]
    mod = _reader("k4_roofline")
    work = (79 * 20_000, 6 * 3 * 4 * 100 * 20_000)

    class Entry:
        def work(self, unit):
            return work

    k4 = {"void (anonymous namespace)::genasm_seg_kernel<16>("
          "(anonymous namespace)::Params)": 3e-4,
          "void (anonymous namespace)::genasm_wide_kernel("
          "(anonymous namespace)::Params)": 1e-4}
    others = {"void (anonymous namespace)::swg_seg_kernel<16>("
              "aimband::SegParams)": 5.0,
              "void (anonymous namespace)::wfa2_kernel<16>("
              "(anonymous namespace)::Params)": 5.0,
              "void (anonymous namespace)::nw_seg_kernel<16>("
              "aimband::SegParams)": 5.0,
              "Memcpy DtoH (Device -> Pageable)": 1.0}
    card = next(iter(roofline.PEAKS))
    run = harness["run"].Run(
        trace={"device_s_by_name": dict(k4, **others)},
        batches=[{"unit": 0}, {"unit": 1}], entry=Entry(), card=card)
    want = 100 * roofline.bound_s(2 * work[0], 2 * work[1], card) / 4e-4
    assert mod.read(run) == pytest.approx(want)
    assert 0 < mod.read(run) <= 100
    run.trace = {"device_s_by_name": others}
    assert mod.read(run) is None


# ---- (e) the over_k_pairs counter ------------------------------------------

def test_over_k_pairs_reads_zero_on_the_cells_pool(harness, config):
    cfg = harness["drive"].cli_config(config)
    with open(os.path.join(BENCH, "traffic", "api_20k.json")) as f:
        assert json.load(f)["entry"] == "api_batch"
    pats, txts, plens, tlens = harness["gen"].generate(
        2000, config["read_length"], config["error"], 2**33 + 17, 0,
        size=config["read_size"])
    res = tapi.align(pats, txts, plens, tlens, cfg, device="cpu")
    assert res.spans.counts["over_k_pairs"] == 0
    assert (res.scores <= cfg.max_score).all()


@pytest.mark.parametrize("n_over", [1, 5, 64])
def test_over_k_pairs_reads_planted_pairs(harness, config, n_over):
    """``n_over`` pairs whose texts share nothing with their patterns,
    planted among pairs at one edit: the counter reads ``n_over``, in the
    call's record and in the ring."""
    cfg = harness["drive"].cli_config(config)
    pats, txts, plens, tlens = harness["gen"].generate(
        64 + n_over, 100, 0.01, 2**35 + n_over, 0, size=config["read_size"])
    at = np.random.default_rng(n_over).choice(len(plens), n_over,
                                              replace=False)
    txts[at] = np.where(txts[at] > 0, ord("A"), 0)
    pats[at] = np.where(pats[at] > 0, ord("C"), 0)
    res = tapi.align(pats, txts, plens, tlens, cfg, device="cpu")
    assert res.spans.counts["over_k_pairs"] == n_over
    assert spans.calls()[-1]["over_k_pairs"] == n_over
    np.testing.assert_array_equal(np.nonzero(res.scores > 2)[0], np.sort(at))


def test_over_k_pairs_counts_genasm_alone(harness):
    """A WFA call past its cap counts none: the counter is GenASM's."""
    cfg = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    pats, txts, plens, tlens = harness["gen"].generate(
        40, 100, 0.1, 2**33 + 5, 0, size=cfg.read_size)
    res = tapi.align(pats, txts, plens, tlens, cfg, device="cpu")
    assert (res.scores > cfg.max_score).any()
    assert res.spans.counts["over_k_pairs"] == 0
