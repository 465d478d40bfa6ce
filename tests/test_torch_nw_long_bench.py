"""The benchmark's long-read NW configuration (``nw_l4k_e1``, cell
``nw4k.file``) on the CPU: its plain reference
(``benchmark/reference/nw.py``) against the port's NW oracle on generated
pairs and on the flat tape's edge cases, its segmented tape against a
tape of one Python step a cell, the port's streamed tier (K6/K7, the
band-retry ladder and the host oracle) against the reference, the
configuration as the CLI resolves it, the frozen work counts, the
fallback and roofline readers, and the cell rehearsed with its control.
The harness is imported by path, as ``tests/test_torch_genasm_bench.py``
does.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from aim_tpu_torch import api as tapi
from aim_tpu_torch import native, spans
from aim_tpu_torch.config import derive_config
from aim_tpu_torch.ops import kernels, nw, nwswg_long

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
CELL = "nw4k.file"
NW_JSON = os.path.join(BENCH, "configs", "nw_l4k_e1.json")
BASES = np.frombuffer(b"ACGT", np.uint8)
COSTS = dict(mismatch=3, gap_i=4, gap_d=4)


@pytest.fixture(scope="module")
def harness():
    """The harness's modules, imported from ``benchmark/``."""
    sys.path.insert(0, BENCH)
    try:
        import drive
        import gen
        import roofline
        import run
        from reference import emit
        from reference import nw as ref
        yield {"drive": drive, "gen": gen, "roofline": roofline, "run": run,
               "emit": emit, "ref": ref}
    finally:
        sys.path.remove(BENCH)


@pytest.fixture(scope="module")
def config():
    with open(NW_JSON) as f:
        return json.load(f)


def _segments(emit, ops, begin, end):
    return [emit.segment(ops[i], int(begin[i]), int(end[i]))
            for i in range(len(begin))]


def _assert_equal(emit, got, want, backtrace=True):
    np.testing.assert_array_equal(got[0], want[0])
    if backtrace:
        assert _segments(emit, *got[1:4]) == _segments(emit, *want[1:4])


def _pairs(pairs, size):
    """Byte strings as ``[n, size]`` rows padded with 0, and lengths."""
    out = []
    for seqs in zip(*pairs):
        rows = np.zeros((len(seqs), size), np.uint8)
        for i, s in enumerate(seqs):
            rows[i, :len(s)] = np.frombuffer(s, np.uint8)
        out.append(rows)
    lens = [np.array([len(s) for s in seqs], np.int32)
            for seqs in zip(*pairs)]
    return out[0], out[1], lens[0], lens[1]


def _case(name, size, seed):
    """The pairs of one edge case, at most ``size`` bases a sequence."""
    rng = np.random.default_rng(seed)

    def rand(n):
        return BASES[rng.integers(0, 4, n)].tobytes()

    def lengths(n, lo, hi):
        return [int(x) for x in rng.integers(lo, hi, n)]

    if name == "empty":
        return [(b"", b""), (b"", rand(1)), (rand(1), b""), (b"", rand(5)),
                (rand(5), b""), (b"", rand(size)), (rand(size), b"")]
    if name == "plen_eq_tlen_plus_1":
        # the row's last cell is the next row's column 0
        return [(p, p[:len(p) - 1]) for p in map(rand, lengths(30, 2, size))] \
            + [(rand(t + 1), rand(t)) for t in lengths(30, 1, size - 1)]
    if name == "plen_gt_tlen_plus_1":
        return [(p, p[c:len(p) - c]) for p in map(rand, lengths(30, 8, size))
                for c in (1, 2)] \
            + [(rand(t + int(rng.integers(2, 6))), rand(t))
               for t in lengths(30, 1, size - 6)]
    if name == "plen_gt_2_tlen_plus_1":
        # a row overwrites past the next row: three segments and more
        return [(rand(p), rand(int(rng.integers(1, (p - 1) // 2))))
                for p in lengths(40, 6, size)]
    if name == "plen_lt_tlen":
        return [(rand(int(rng.integers(1, t))), rand(t))
                for t in lengths(40, 2, size)]
    if name == "all_mismatch":
        return [(b"A" * p, b"C" * t) for p, t in ((1, 1), (3, 3), (7, 2),
                                                  (2, 7), (size, size),
                                                  (size, 5), (9, size))]
    # two-letter sequences of any lengths: the walk's ties
    def two(n):
        return BASES[2 * rng.integers(0, 2, n)].tobytes()

    return [(two(int(rng.integers(0, size))), two(int(rng.integers(0, size))))
            for _ in range(80)]


CASES = ["empty", "plen_eq_tlen_plus_1", "plen_gt_tlen_plus_1",
         "plen_gt_2_tlen_plus_1", "plen_lt_tlen", "all_mismatch", "ties"]


# ---- the reference against the port's NW oracle ---------------------------

@pytest.mark.parametrize("backtrace", [True, False], ids=["bt", "score"])
def test_reference_equals_oracle_on_generated_pairs(harness, backtrace):
    """Pairs of 240 bp at 5 % edits: 12 edits a pair, so a third of them
    alias (plen > tlen + 1)."""
    size = harness["gen"].read_size(240, 0.05)
    pats, txts, plens, tlens = harness["gen"].generate(
        60, 240, 0.05, 2**37 + 19, 0, size=size)
    assert 10 <= int((plens > tlens + 1).sum()) <= 50
    ref = harness["ref"].align(pats, txts, plens, tlens, backtrace=backtrace,
                               **COSTS)
    want = native.nw_align(pats, txts, plens, tlens, backtrace=backtrace,
                           **COSTS)
    _assert_equal(harness["emit"], ref, want, backtrace)
    if not backtrace:
        assert ref[1] is None and ref[2] is None and ref[3] is None


@pytest.mark.parametrize("backtrace", [True, False], ids=["bt", "score"])
@pytest.mark.parametrize("case", CASES)
def test_reference_equals_oracle_on_edge_cases(harness, case, backtrace):
    size = 40
    pats, txts, plens, tlens = _pairs(_case(case, size, 7), size)
    ref = harness["ref"].align(pats, txts, plens, tlens, backtrace=backtrace,
                               **COSTS)
    want = native.nw_align(pats, txts, plens, tlens, backtrace=backtrace,
                           **COSTS)
    _assert_equal(harness["emit"], ref, want, backtrace)
    if backtrace:
        np.testing.assert_array_equal(ref[2], want[2])
        np.testing.assert_array_equal(ref[3], want[3])


@pytest.mark.parametrize("costs", [(5000, 3000), (20000, 9000), (1, 1)],
                         ids=["wrap", "wrap_twice", "unit"])
def test_reference_wraps_as_int16(harness, costs):
    """Costs whose sums leave int16: every such tape goes to the per-cell
    simulation, which wraps as the reference stores its cells."""
    size = 24
    x, g = costs
    pats, txts, plens, tlens = _pairs(_case("ties", size, 11), size)
    ref = harness["ref"].align(pats, txts, plens, tlens, mismatch=x, gap_i=g,
                               gap_d=g)
    want = native.nw_align(pats, txts, plens, tlens, mismatch=x, gap_i=g,
                           gap_d=g, backtrace=True)
    _assert_equal(harness["emit"], ref, want)
    if x > 1:
        assert (ref[0] < 0).any()


@pytest.mark.parametrize("case", CASES)
def test_segmented_tape_is_the_per_cell_tape(harness, case):
    """The whole final tape, the cells that later rows overwrote
    included, on tiny pairs, at the flat tape's stride and at a clean
    table's."""
    ref = harness["ref"]
    pats, txts, plens, tlens = _pairs(_case(case, 12, 5), 12)
    for i in range(len(plens)):
        p, t = int(plens[i]), int(tlens[i])
        for stride in (t + 1, max(p, t) + 1):
            seg, s1 = ref.segmented_tape(pats[i], txts[i], p, t, stride=stride,
                                         **COSTS)
            cell, s2 = ref.flat_tape_cells(pats[i].tolist(), txts[i].tolist(),
                                           p, t, stride=stride, **COSTS)
            np.testing.assert_array_equal(seg, cell)
            assert s1 == s2


def test_control_breaks_the_aliasing_pairs_alone(harness, config):
    """The control's clean table changes the aliasing pairs' scores and
    leaves every other pair's output as it is."""
    size = harness["gen"].read_size(240, 0.05)
    pats, txts, plens, tlens = harness["gen"].generate(
        60, 240, 0.05, 2**36 + 29, 0, size=size)
    c = dict(config, read_size=size)
    good = harness["ref"].run(pats, txts, plens, tlens, c)
    ctl = harness["ref"].run(pats, txts, plens, tlens, c, control=True)
    alias = plens > tlens + 1
    assert (good[0][alias] != ctl[0][alias]).any()
    np.testing.assert_array_equal(good[0][~alias], ctl[0][~alias])
    emit = harness["emit"]
    keep = np.nonzero(~alias)[0]
    assert [_segments(emit, *good[1:4])[i] for i in keep] == \
        [_segments(emit, *ctl[1:4])[i] for i in keep]


# ---- the configuration and the port's streamed tier -------------------------

def test_config_is_the_clis(harness, config):
    cfg = harness["drive"].cli_config(config)
    assert cfg == derive_config("nw", 4096, 0.01, backtrace=True,
                                variant="hbm")
    assert (cfg.read_size, cfg.max_score) == (config["read_size"],
                                              config["max_score"]) \
        == (4144, 328)
    assert (cfg.match, cfg.mismatch, cfg.gap_i, cfg.gap_d) == (
        config["match"], config["mismatch"], config["gap_i"],
        config["gap_d"]) == (0, 3, 4, 4)
    assert cfg.backtrace is config["backtrace"] is True
    assert cfg.variant == config["variant"] == "hbm"
    assert harness["gen"].read_size(config["read_length"],
                                    config["error"]) == cfg.read_size
    tier = kernels.forward_fn(cfg)
    # the streamed tier at one primary plane (C = 63), the ladder above
    assert tier.name == "K6" and tier.records == kernels.PACKED_RUNS
    assert tier.primary_planes == nwswg_long.route_planes(cfg) == 1
    assert nwswg_long.band_c(1) == 63
    assert tier.retry is nwswg_long.nwswg_forward_long
    assert tapi._retry_stages(tier) == (2, 4, 8)
    assert nwswg_long.runs_lanes_long(cfg) == 256
    assert tier.device_bytes_per_pair == 207_728


def test_smallest_streamed_read_size():
    """K2 serves NW up to READ_SIZE 1520; 1528 is the streamed tier's."""
    lo = derive_config("nw", 1496, 0.01, backtrace=True, variant="hbm")
    hi = derive_config("nw", 1376, 0.1, backtrace=True, variant="hbm")
    assert (lo.read_size, hi.read_size) == (1520, 1528)
    assert nw.vmem_fit_nw(lo) and kernels.forward_fn(lo).name == "K2"
    assert not nw.vmem_fit_nw(hi) and kernels.forward_fn(hi).name == "K6"


def test_port_equals_reference_through_the_streamed_tier(harness):
    """The streamed tier at its smallest read size, pairs at 22 % edits:
    K6 flags band-limited and aliasing pairs, the ladder certifies some of
    the first, the oracle takes the rest; the output is the reference's,
    and the counters say so."""
    cfg = derive_config("nw", 1376, 0.1, backtrace=True, variant="hbm")
    pats, txts, plens, tlens = harness["gen"].generate(
        48, 1376, 0.22, 2**33 + 5, 0, size=cfg.read_size)
    res = tapi.align(pats, txts, plens, tlens, cfg, device="cpu")
    ref = harness["ref"].align(pats, txts, plens, tlens,
                               mismatch=cfg.mismatch, gap_i=cfg.gap_i,
                               gap_d=cfg.gap_d)
    _assert_equal(harness["emit"], (res.scores, res.ops, res.begin, res.end),
                  ref)
    c = res.spans.counts
    alias = np.nonzero(plens > tlens + 1)[0]
    assert c["alias_pairs"] == len(alias) > 0
    assert c["retry_pairs"] == res.n_retry > 0
    assert c["flagged_pairs"] > c["alias_pairs"]
    assert c["flagged_pairs"] == c["retry_pairs"] + c["fallback_pairs"]
    assert c["fallback_pairs"] == res.n_fallback >= c["alias_pairs"]
    # every flagged pair that does not alias fits a band of the ladder
    assert c["fallback_pairs"] == c["alias_pairs"]
    cells = int(((plens[alias] + 1).astype(np.int64)
                 * (tlens[alias] + 1)).sum())
    assert c["fallback_cells"] == cells
    assert res.spans.seconds["retry"] > 0 and res.spans.seconds["fallback"] > 0
    row = spans.calls()[-1]
    assert row["alias_pairs"] == len(alias) and row["fallback_cells"] == cells


# ---- the frozen work counts ------------------------------------------------

def test_work_is_a_hand_count(harness):
    ref = harness["ref"]
    p = np.array([10, 10, 4, 0])
    t = np.array([10, 12, 4, 3])
    scores = np.array([3, 8, 9, 12])
    # K = max(|t - p|, S // 4): 0, 2, 2 (clipped to 4), 3
    cells = ref.band_cells(p, t, scores, 4, 4)
    # 10 on the diagonal; 12 rows against 10 columns at |h - v| <= 2;
    # 4 x 4 at |h - v| <= 2; no cell with no column
    assert cells.tolist() == [10, 3 + 4 + 5 + 5 * 5 + 4 + 3 + 2 + 1,
                              3 + 4 + 4 + 3, 0]
    ops = 8 * int(cells.sum())
    n_bytes = (3 + 3 + 4 + 3) + (3 + 3 + 4 + 3) + (1 + 1 + 4 + 1) \
        + (0 + 1 + 4 + 1)
    assert ref.work(p, t, cells) == (n_bytes, ops)


def test_work_reads_the_references_cells(harness, config):
    """`run`'s last output is what `work` counts: the band of each pair's
    exact score, 8 int32 ops a cell (PERF.md's kernel table)."""
    size = harness["gen"].read_size(240, 0.05)
    pats, txts, plens, tlens = harness["gen"].generate(
        20, 240, 0.05, 2**34 + 7, 0, size=size)
    *_, cells = harness["ref"].run(pats, txts, plens, tlens,
                                   dict(config, read_size=size))
    scores = native.nw_align(pats, txts, plens, tlens, backtrace=False,
                             **COSTS)[0]
    np.testing.assert_array_equal(
        cells, harness["ref"].band_cells(plens, tlens, scores, 4, 4))
    assert harness["ref"].work(plens, tlens, cells)[1] == 8 * int(cells.sum())


# ---- the readers ------------------------------------------------------------

def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K6 = "void (anonymous namespace)::fwd_kernel<4, false>((anonymous " \
    "namespace)::LongParams)"
K6_WIDE = "void (anonymous namespace)::fwd_kernel<8, false>((anonymous " \
    "namespace)::LongParams)"
K7 = "void (anonymous namespace)::walk_kernel<false, 2>((anonymous " \
    "namespace)::LongParams)"
OTHERS = {"void (anonymous namespace)::nw_seg_kernel<16>("
          "aimband::SegParams)": 5.0,
          "void (anonymous namespace)::wfa_long_kernel("
          "(anonymous namespace)::Params)": 5.0,
          "Memcpy DtoH (Device -> Pageable)": 1.0}


class _Entry:
    def __init__(self, work, lengths):
        self._work = work
        self.lengths = lengths

    def work(self, unit):
        return self._work


def test_kernel_readers_name_k6_and_k7_alone():
    import re
    names = {}
    csrc = os.path.join(REPO, "aim_tpu_torch", "csrc")
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                text = fh.read()
            for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__"
                                 r"\([^)]*\)\s*)*(\w+)\s*\(", text):
                names[m.group(1)] = f
    for metric, kernel in (("k6_roofline", "fwd_kernel"),
                           ("k7_roofline", "walk_kernel")):
        assert _reader(metric).KERNEL == kernel
        assert {n for n in names if kernel in n} == {kernel}
        assert names[kernel] == "nwswg_long.cu"


def test_k6_reader_reads_k6_time(harness):
    roofline = harness["roofline"]
    work = (3076 * 4096, 8 * 320_000 * 4096)
    card = next(iter(roofline.PEAKS))
    trace = {"device_s_by_name": dict({K6: 4e-3, K6_WIDE: 1e-3, K7: 2e-4},
                                      **OTHERS)}
    run = harness["run"].Run(trace=trace, batches=[{"unit": 0}, {"unit": 1}],
                             entry=_Entry(work, None), card=card)
    want = 100 * roofline.bound_s(2 * work[0], 2 * work[1], card) / 5e-3
    mod = _reader("k6_roofline")
    assert mod.read(run) == pytest.approx(want)
    assert 0 < mod.read(run) <= 100
    run.trace = {"device_s_by_name": dict(OTHERS)}
    assert mod.read(run) is None


def test_k7_reader_reads_the_walks_bytes(harness):
    roofline = harness["roofline"]
    lengths = [(np.full(4096, 4096), np.full(4096, 4100)),
               (np.full(4096, 4096), np.full(4096, 4090))]
    card = next(iter(roofline.PEAKS))
    trace = {"device_s_by_name": dict({K6: 4e-3, K7: 1.5e-4}, **OTHERS)}
    batches = [{"unit": 0}, {"unit": 1}, {"unit": 0}]
    # the reader takes no work from `work`: the walk has no ops counted
    run = harness["run"].Run(trace=trace, batches=batches,
                             entry=_Entry(None, lengths), card=card)
    n_bytes = sum(roofline.wfa_bytes(*lengths[b["unit"]]) for b in batches)
    assert n_bytes == 4096 * ((1024 + 1025 + 4 + 1025) * 2
                              + (1024 + 1023 + 4 + 1024))
    want = 100 * n_bytes / roofline.PEAKS[card]["bytes_s"] / 1.5e-4
    mod = _reader("k7_roofline")
    assert mod.read(run) == pytest.approx(want)
    assert 0 < mod.read(run) <= 100
    for trace in (None, {"device_s_by_name": dict({K6: 4e-3}, **OTHERS)}):
        run.trace = trace
        assert mod.read(run) is None
    run.trace, run.card = {"device_s_by_name": {K7: 1e-4}}, "cpu"
    assert mod.read(run) is None


def _log(pairs, **cols):
    rows = np.zeros(len(pairs) + 1, spans.DTYPE)
    rows["entry"] = "cli"
    rows["pairs"] = [999] + list(pairs)
    for k, v in cols.items():
        rows[k][1:] = v
    return rows


BATCHES = [{"pairs": 4096, "wall_s": 7.0}, {"pairs": 4096, "wall_s": 6.5}]


def test_fallback_readers_read_the_window_rows(harness, monkeypatch):
    log = _log([4096, 4096], fallback=[6.0, 5.5], retry=[1e-4, 2e-4],
               fallback_cells=[16_800_000 * 1600, 16_800_000 * 1650])
    monkeypatch.syspath_prepend(BENCH)
    monkeypatch.setattr(spans, "calls", lambda: log)
    run = harness["run"].Run(batches=BATCHES)
    ms = _reader("fallback_ms_per_mpair").read(run)
    assert ms == pytest.approx(11.5e3 / 8192e-6)
    ns = _reader("fallback_ns_per_cell").read(run)
    assert ns == pytest.approx(11.5e9 / (16_800_000 * 3250))


def test_fallback_readers_none_cases(harness, monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    ms = _reader("fallback_ms_per_mpair").read
    ns = _reader("fallback_ns_per_cell").read
    Run = harness["run"].Run
    run = Run(batches=BATCHES)
    # no pair reached the oracle: a span of 0 reads None, not 0
    monkeypatch.setattr(spans, "calls", lambda: _log([4096, 4096]))
    assert ms(run) is None and ns(run) is None
    # a log without the counter (a tree before it): the span still reads
    old = np.dtype([(n, spans.DTYPE.fields[n][0]) for n in spans.DTYPE.names
                    if n not in ("alias_pairs", "fallback_cells")])
    log = _log([4096, 4096], fallback=[6.0, 5.5])
    monkeypatch.setattr(spans, "calls", lambda: np.array(
        [tuple(r[n] for n in old.names) for r in log], old))
    assert ms(run) == pytest.approx(11.5e3 / 8192e-6)
    assert ns(run) is None
    # the log does not reach back past the window's first batch
    monkeypatch.setattr(spans, "calls", lambda: log[1:])
    assert ms(run) is None and ns(run) is None
    assert ms(Run(batches=[])) is None and ns(Run(batches=[])) is None


# ---- the cell rehearsed, and its control -------------------------------------

def _run_cell(*extra, pairs=8):
    """``benchmark/run.py`` on the cell at ``pairs`` pairs a file, in a
    process of its own: its result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", CELL,
         "--seed", "4294967311", "--seconds", "0.2", "--trace", "0",
         "--pairs", str(pairs), *extra], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_rehearsal_is_correct():
    line = _run_cell("--rehearse")
    assert line["correct"] is True and line["mode"] == "rehearse"
    assert all(v["value"] == 0 for v in line["checks"].values())
    assert line["attempted"] >= 8


def test_control_is_not_correct():
    # both files' 8 pairs, every one checked: the aliasing pairs differ
    line = _run_cell("--control")
    assert line["attempted"] == 2 * 8
    assert line["correct"] is False
    assert line["checks"]["score_diff"]["value"] > 0
    assert line["checks"]["missing"]["value"] == 0
    assert line["metrics"] == {}
