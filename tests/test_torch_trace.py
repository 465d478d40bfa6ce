"""The port's spans (``aim_tpu_torch.spans``) on the CPU: the stages a call
passes through, the phase fields derived from them, one record a call,
the bounded log, the profiler ranges, and the benchmark's readers of the
log (``benchmark/program_spans.py``, ``benchmark/metrics/``).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from aim_tpu_torch import api as tapi
from aim_tpu_torch import datagen, spans
from aim_tpu_torch.config import derive_config
from aim_tpu_torch.ops import wfa2
from aim_tpu_torch.ops.common import pack_seqs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "sample-l100-e1-2K")
BENCH = os.path.join(REPO, "benchmark")
N_SAMPLE = 1000
WFA = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
# the stages a WFA -b -r file call on one device passes through
FILE_STAGES = {"parse", "pack", "plan", "upload", "kernel", "retrieve",
               "decode", "emit"}


def _file_call(tmp_path, name="o", **kw):
    res = tapi.align_file(SAMPLE, str(tmp_path / name), N_SAMPLE, WFA,
                          device=kw.pop("device", "cpu"), verbose=False,
                          **kw)
    return res, res.spans


def test_align_file_fills_its_stages(tmp_path):
    _, rec = _file_call(tmp_path)
    assert rec.entry == "align_file" and rec.pairs == N_SAMPLE
    assert {s for s, v in rec.seconds.items() if v > 0} == FILE_STAGES
    from aim_tpu_torch import native
    p, t, pl, tl = native.parse_pairs(SAMPLE, N_SAMPLE, WFA.read_size)
    up_p, up_t, packed = pack_seqs(p, t, pl, tl, WFA.read_size)
    assert packed
    # K1's level rows with no op and no gap, of the pairs within smax
    steps = wfa2.wfa2_reference(
        *(torch.from_numpy(a) for a in (up_p, up_t, pl, tl)), cfg=WFA,
        packed=True).numpy()
    smax = WFA.max_score
    walked = steps[steps[:, smax + 3] <= smax, :smax + 1].view(np.uint32)
    assert rec.counts == {
        "chunks": 1,
        "h2d_bytes": up_p.nbytes + up_t.nbytes + pl.nbytes + tl.nbytes,
        # K1's step records: smax + 4 int32 rows a pair
        "d2h_bytes": N_SAMPLE * (WFA.max_score + 4) * 4,
        # 1,000 rows of 224 bytes: below the decode pass's thread minimum
        "decode_threads": 1,
        # 1,000 pairs of 224 bytes: below the pack pass's thread minimum
        "pack_threads": 1,
        # the sample's ~200 KB: below the parse pass's thread minimum
        "parse_threads": 1,
        # K1 flags no pair, so the ladder and the oracle take none
        "flagged_pairs": 0, "retry_pairs": 0, "fallback_pairs": 0,
        "alias_pairs": 0, "fallback_cells": 0,
        # a WFA call: the GenASM counter stays 0
        "over_k_pairs": 0,
        # the expander steps over every match-only level and clamps none
        "decode_skipped_rows": int(np.count_nonzero(
            (walked & 0xFFFFC000) == 0)),
        "decode_clamped_pairs": 0}


def test_phase_fields_are_their_stages(tmp_path, capsys):
    res = tapi.align_file(SAMPLE, str(tmp_path / "o"), N_SAMPLE, WFA,
                          device="cpu")
    sec = res.spans.seconds
    assert res.t_load == sec["upload"]
    assert res.t_kernel == sec["kernel"]
    assert res.t_retrieve == sec["retrieve"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"Parsed {N_SAMPLE} pairs in " \
                       f"{sec['parse'] * 1e3:.3f} ms"


def test_stages_sum_within_the_call(tmp_path):
    _, rec = _file_call(tmp_path)
    assert 0 < sum(rec.seconds.values()) <= rec.call_s
    row = spans.calls()[-1]
    assert row["entry"] == "align_file" and row["pairs"] == N_SAMPLE
    assert row["call_s"] == rec.call_s
    assert [row[s] for s in spans.STAGES] == list(rec.seconds.values())
    assert [row[c] for c in spans.COUNTERS] == list(rec.counts.values())


def test_nested_call_gives_one_record(tmp_path):
    before = len(spans.calls())
    res, rec = _file_call(tmp_path)
    log = spans.calls()
    if before < spans.CAPACITY:
        assert len(log) == before + 1
    assert log[-1]["entry"] == "align_file"
    p, t, pl, tl = datagen.generate_pairs(40, 100, 0.01,
                                          read_size=WFA.read_size, seed=5)
    alone = tapi.align(p, t, pl, tl, WFA, "cpu")
    assert alone.spans is not rec and alone.spans.entry == "align"
    assert spans.calls()[-1]["entry"] == "align"
    assert spans.calls()[-1]["pairs"] == 40


def test_raising_call_records_nothing():
    p, t, pl, tl = datagen.generate_pairs(8, 100, 0.01,
                                          read_size=WFA.read_size, seed=5)
    pl[0] = WFA.read_size + 1
    tapi.align(p[1:3], t[1:3], pl[1:3], tl[1:3], WFA, "cpu")
    before = spans.calls()
    with pytest.raises(ValueError):
        tapi.align(p, t, pl, tl, WFA, "cpu")
    after = spans.calls()
    assert len(after) == len(before) and after[-1] == before[-1]
    # the thread's record was closed: the next call opens its own
    res = tapi.align(p[1:], t[1:], pl[1:], tl[1:], WFA, "cpu")
    assert res.spans.entry == "align" and res.spans.pairs == 7
    assert spans.calls()[-1]["pairs"] == 7


def test_ring_stays_bounded():
    ring = spans.Ring(3)
    for k in range(5):
        ring.append(spans.Record("align", k))
    assert list(ring.rows()["pairs"]) == [2, 3, 4]
    assert spans.CAPACITY >= 16384
    for k in range(spans.CAPACITY + 2):
        with spans.call("align", k):
            pass
    log = spans.calls()
    assert len(log) == spans.CAPACITY
    assert list(log["pairs"][[0, -1]]) == [2, spans.CAPACITY + 1]


def test_profiler_trace_holds_each_stage_in_the_call(tmp_path):
    prof = tmp_path / "prof"
    _, rec = _file_call(tmp_path, profile_dir=str(prof))
    events = json.load(open(prof / "trace.json"))["traceEvents"]
    ranges = [e for e in events if e.get("ph") == "X"
              and e.get("name", "").startswith("aim.")]
    calls = [e for e in ranges if e["name"] == "aim.call"]
    assert len(calls) == 1
    c0, c1 = calls[0]["ts"], calls[0]["ts"] + calls[0]["dur"]
    seen = {e["name"][4:] for e in ranges if e["name"] != "aim.call"}
    assert seen == FILE_STAGES == {s for s, v in rec.seconds.items() if v}
    for e in ranges:
        assert c0 <= e["ts"] and e["ts"] + e["dur"] <= c1


def test_cli_call_holds_the_run(tmp_path, monkeypatch, capsys):
    """cli.main opens the run's record (one row, entry ``cli``); the
    --profile trace, started inside it by align_file, still shows
    ``aim.call`` holding every stage; the output file is align_file's."""
    from aim_tpu_torch import cli as tcli
    from aim_tpu_torch import parallel
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(parallel, "devices",
                        lambda n: [torch.device("cpu")] * n)
    before = len(spans.calls())
    prof = tmp_path / "prof"
    assert tcli.main(["wfa", "-i", SAMPLE, "-o", str(tmp_path / "cli"),
                      "-l", "100", "-e", "0.01", "-n", str(N_SAMPLE), "-b",
                      "-r", "--profile", str(prof)]) == 0
    log = spans.calls()
    assert len(log) == min(before + 1, spans.CAPACITY)
    row = log[-1]
    assert row["entry"] == "cli" and row["pairs"] == N_SAMPLE
    assert {s for s in spans.STAGES if row[s] > 0} == FILE_STAGES
    events = json.load(open(prof / "trace.json"))["traceEvents"]
    (call,) = [e for e in events if e.get("name") == "aim.call"]
    stages = [e for e in events if e.get("ph") == "X"
              and e.get("name", "").startswith("aim.") and e is not call]
    assert {e["name"][4:] for e in stages} == FILE_STAGES
    for e in stages:
        assert call["ts"] <= e["ts"] and \
            e["ts"] + e["dur"] <= call["ts"] + call["dur"]
    _file_call(tmp_path, "lib")
    assert (tmp_path / "cli").read_bytes() == (tmp_path / "lib").read_bytes()


def test_no_profiler_enters_no_range(tmp_path, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    res, rec = _file_call(tmp_path)
    assert {s for s, v in rec.seconds.items() if v > 0} == FILE_STAGES


@pytest.mark.parametrize("ndev", [1, 2], ids=["one-device", "two-shards"])
def test_long_file_call_has_no_sort_or_permute(tmp_path, ndev):
    """More than 128 short pairs under a read_size >= 1024 config: the file
    is the native oracle's on one device and over two shards, and the
    ``sort`` and ``permute`` stages read 0."""
    from aim_tpu_torch import native
    cfg = derive_config("wfa", 1000, 0.01, backtrace=True, adaptive=True,
                        variant="hbm")
    assert cfg.read_size >= 1024
    n = 200
    res = tapi.align_file(SAMPLE, str(tmp_path / "port"), n, cfg,
                          device=["cpu"] * ndev, verbose=False)
    assert res.spans.seconds["sort"] == res.spans.seconds["permute"] == 0
    assert spans.calls()[-1]["sort"] == spans.calls()[-1]["permute"] == 0
    p, t, pl, tl = native.parse_pairs(SAMPLE, n, cfg.read_size)
    sc, ops, b, e = native.wfa_align(
        p, t, pl, tl, mismatch=cfg.mismatch, gap_o=cfg.gap_o,
        gap_e=cfg.gap_e, max_score=cfg.max_score, adaptive=cfg.adaptive,
        backtrace=True)
    native.emit_output(str(tmp_path / "oracle"), np.arange(n, dtype=np.int32),
                       sc, ops, b, e, True)
    assert (tmp_path / "port").read_bytes() == \
        (tmp_path / "oracle").read_bytes()


def test_device_log_reads_retry_and_fallback(tmp_path):
    """NW at 10 % errors: K2 flags most pairs, the streamed tier's planes
    certify some (retry), the oracle takes the rest (fallback); the device
    log carries every stage and counter."""
    src = str(tmp_path / "pairs")
    datagen.write_pair_file(src, 64, 100, 0.1, seed=3)
    cfg = derive_config("nw", 100, 0.01, backtrace=True)
    log = tmp_path / "dev.log"
    res = tapi.align_file(src, str(tmp_path / "o"), 64, cfg, device="cpu",
                          verbose=False, device_log=str(log))
    assert res.n_retry > 0 and res.n_fallback > 0
    fields = dict(f.split("=", 1)
                  for f in log.read_text().split("|", 1)[1].split())
    for s in spans.STAGES:
        assert float(fields[f"{s}_s"]) == pytest.approx(
            res.spans.seconds[s], abs=1e-6)
    assert float(fields["retry_s"]) > 0 and float(fields["fallback_s"]) > 0
    for c in spans.COUNTERS:
        assert int(fields[c]) == res.spans.counts[c]


@pytest.mark.parametrize("error,over", [(0.01, False), (0.1, True)],
                         ids=["within_k", "past_k"])
def test_device_log_reads_over_k_pairs(tmp_path, error, over):
    """GenASM at k = 2 on one edit a pair walks every pair; at ten, most
    pass k: the device log and the ring carry the pairs scored k + 1."""
    src = str(tmp_path / "pairs")
    datagen.write_pair_file(src, 64, 100, error, seed=4)
    cfg = derive_config("genasm", 100, 0.01, backtrace=True)
    log = tmp_path / "dev.log"
    res = tapi.align_file(src, str(tmp_path / "o"), 64, cfg, device="cpu",
                          verbose=False, device_log=str(log))
    n_over = int((res.scores > cfg.max_score).sum())
    assert (n_over > 0) is over
    fields = dict(f.split("=", 1)
                  for f in log.read_text().split("|", 1)[1].split())
    assert int(fields["over_k_pairs"]) == n_over
    assert res.spans.counts["over_k_pairs"] == n_over
    assert spans.calls()[-1]["over_k_pairs"] == n_over
    for c in spans.COUNTERS:
        assert int(fields[c]) == res.spans.counts[c]


@pytest.mark.parametrize("n_alias", [1, 5], ids=["one", "five"])
def test_alias_pairs_and_fallback_cells_read_planted_pairs(tmp_path,
                                                          n_alias):
    """NW at 100 bp, one edit a pair, with ``n_alias`` texts cut so that
    plen > tlen + 1: K2 flags those pairs alone, the ladder skips them and
    the oracle fills their tables; the counters read their number and
    their cells, (plen + 1)(tlen + 1) a pair, in the call's record, the
    ring and the device log."""
    src = str(tmp_path / "pairs")
    datagen.write_pair_file(src, 64, 100, 0.01, seed=5)
    from aim_tpu_torch import native
    cfg = derive_config("nw", 100, 0.01, backtrace=True)
    pats, txts, plens, tlens = native.parse_pairs(src, 64, cfg.read_size)
    assert not (plens > tlens + 1).any()
    at = np.random.default_rng(n_alias).choice(64, n_alias, replace=False)
    tlens[at] = plens[at] - 2 - np.arange(n_alias) * 7
    for i in at:
        txts[i, tlens[i]:] = 0
    log = tmp_path / "dev.log"
    res = tapi.align(pats, txts, plens, tlens, cfg, device="cpu")
    tapi.write_device_log(str(log), cfg, res, 64, "cpu")
    cells = int(((plens[at] + 1) * (tlens[at] + 1)).sum())
    c = res.spans.counts
    assert c["alias_pairs"] == c["flagged_pairs"] == n_alias
    assert c["fallback_pairs"] == n_alias and c["retry_pairs"] == 0
    assert c["fallback_cells"] == cells
    assert spans.calls()[-1]["alias_pairs"] == n_alias
    assert spans.calls()[-1]["fallback_cells"] == cells
    fields = dict(f.split("=", 1)
                  for f in log.read_text().split("|", 1)[1].split())
    assert int(fields["alias_pairs"]) == n_alias
    assert int(fields["fallback_cells"]) == cells


# ---- the benchmark's readers of the log -----------------------------------

def _reader(name, monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _log(pairs, **cols):
    """A log of one warm row then one row a batch, stage and counter
    columns given per batch row."""
    rows = np.zeros(len(pairs) + 1, spans.DTYPE)
    rows["entry"] = "align_file"
    rows["pairs"] = [999] + list(pairs)
    for k, v in cols.items():
        rows[k][1:] = v
    return rows


BATCHES = [{"pairs": 2000, "wall_s": 0.5}, {"pairs": 2000, "wall_s": 0.7}]
LOG = _log([2000, 2000], sort=[0.01, 0.03], permute=[0.02, 0.02],
           pack=[0.004, 0.006], plan=[0.001, 0.003], decode=[0.1, 0.2],
           emit=[0.05, 0.07], upload=[0.01, 0.03], kernel=[0.002, 0.002],
           retrieve=[0.004, 0.004], parse=[0.1, 0.1],
           h2d_bytes=[10 ** 8, 3 * 10 ** 8], d2h_bytes=[10 ** 7, 10 ** 7])
SPANNED = 0.01 + 0.03 + 0.04 + 0.01 + 0.004 + 0.3 + 0.12 + 0.04 + 0.004 \
    + 0.008 + 0.2
EXPECT = {  # per 4,000 pairs: ms a 1M is ms / 4e-3
    "sort_ms_per_mpair": 40 / 4e-3,
    "permute_ms_per_mpair": 40 / 4e-3,
    "pack_ms_per_mpair": 10 / 4e-3,
    "plan_ms_per_mpair": 4 / 4e-3,
    "decode_ms_per_mpair": 300 / 4e-3,
    "emit_ms_per_mpair": 120 / 4e-3,
    "unspanned_ms_per_mpair": (1.2 - SPANNED) * 1e3 / 4e-3,
    "h2d_gb_s": 4e8 / 0.04 / 1e9,
    "d2h_gb_s": 2e7 / 0.008 / 1e9,
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_reads_the_window_rows(name, monkeypatch):
    read = _reader(name, monkeypatch)
    monkeypatch.setattr(spans, "calls", lambda: LOG)
    assert read(Run(batches=BATCHES)) == pytest.approx(EXPECT[name])
    # a longer log: only the window's last rows count
    longer = np.concatenate((LOG[:1], LOG[1:2], LOG))
    monkeypatch.setattr(spans, "calls", lambda: longer)
    assert read(Run(batches=BATCHES)) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_none_cases(name, monkeypatch):
    read = _reader(name, monkeypatch)
    monkeypatch.setattr(spans, "calls", lambda: LOG)
    assert read(Run(batches=[])) is None
    # the log does not reach back past the window's first batch
    monkeypatch.setattr(spans, "calls", lambda: LOG[1:])
    assert read(Run(batches=BATCHES)) is None
    # the rows' pairs are not the batches' pairs
    monkeypatch.setattr(spans, "calls", lambda: LOG)
    other = [dict(BATCHES[0], pairs=2001), BATCHES[1]]
    assert read(Run(batches=other)) is None
    # a program without the span log
    import aim_tpu_torch
    monkeypatch.delattr(aim_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "aim_tpu_torch.spans", None)
    assert read(Run(batches=BATCHES)) is None


def test_rate_readers_need_the_stage_time(monkeypatch):
    idle = LOG.copy()
    idle["upload"] = 0.0
    idle["retrieve"] = 0.0
    monkeypatch.setattr(spans, "calls", lambda: idle)
    for name in ("h2d_gb_s", "d2h_gb_s"):
        assert _reader(name, monkeypatch)(Run(batches=BATCHES)) is None
