"""The decode pass of ``aim_tpu_torch.api`` on the CPU: every chunk's step
records (WFA K1/K5, GenASM K4) or packed runs (NW/SWG K2/K3, the streamed
tier K6/K7, the GenASM long tier) decoded in one pass over the batch, on
row ranges across threads, straight into the call's rows.  It must write
the bytes the per-chunk path wrote (each chunk through the allocating
decoder, then copied into the batch's arrays), at any thread count and
chunk layout; the retry and fallback still overwrite their rows after
it; the ``decode_threads`` counter says how many threads it used.
Tolerance: exact.
"""

import numpy as np
import pytest

from aim_tpu_torch import api as tapi
from aim_tpu_torch import datagen, native, spans
from aim_tpu_torch.cli import build_parser, config_from_args
from aim_tpu_torch.config import AlignConfig, derive_config
from aim_tpu_torch.ops import kernels
from torch_cases import step_decode_case, step_stats

WFA = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)


def _cfg(argv):
    return config_from_args(build_parser().parse_args(
        argv[:1] + ["-i", "-", "-o", "-", "-n", "1"] + argv[1:]))


def _pairs(cfg, n, length, err, seed=3):
    return datagen.generate_pairs(n, length, err, read_size=cfg.read_size,
                                  seed=seed)


def _captured(monkeypatch, pats, txts, plens, tlens, cfg, device="cpu"):
    """What the call hands the decode pass: (grammar, chunks, plens, tlens)
    in the order the pass sees the pairs, and the blocks each chunk was
    gathered from."""
    seen = {"blocks": []}
    real, gather = tapi._decode_pass, tapi._gather

    def spy(grammar, chunks, cfg, plens, tlens, *rest):
        seen.update(grammar=grammar, chunks=chunks, plens=plens.copy(),
                    tlens=tlens.copy())
        return real(grammar, chunks, cfg, plens, tlens, *rest)

    def gather_spy(parts):
        seen["blocks"].append(len(parts))
        return gather(parts)

    monkeypatch.setattr(tapi, "_decode_pass", spy)
    monkeypatch.setattr(tapi, "_gather", gather_spy)
    tapi.align(pats, txts, plens, tlens, cfg, device)
    monkeypatch.setattr(tapi, "_decode_pass", real)
    monkeypatch.setattr(tapi, "_gather", gather)
    return seen


def _per_chunk(grammar, chunks, cfg, plens, tlens):
    """The per-chunk path the pass replaces: each chunk's records through
    the allocating decoder, copied into the batch's arrays."""
    n, max_ops = len(plens), 2 * cfg.read_size
    scores = np.zeros(n, np.int32)
    ops = np.zeros((n, max_ops), np.uint8)
    begin = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)
    for lo, rec in chunks:
        hi = lo + len(rec)
        if grammar == kernels.PACKED_RUNS:
            scores[lo:hi] = rec[:, 1]
            o, b, e = native.wfa_runs_to_ops(
                rec, scores[lo:hi], plens[lo:hi], tlens[lo:hi],
                max_score=1 << 30, max_ops=max_ops)
        else:
            levels = cfg.max_score if grammar == kernels.STEP_RECORDS \
                else cfg.read_size
            s, o, b, e = native.wfa_steps_to_ops(
                rec, plens[lo:hi], tlens[lo:hi], max_score=levels,
                max_ops=max_ops)
            scores[lo:hi] = s
        ops[lo:hi], begin[lo:hi], end[lo:hi] = o, b, e
    return scores, ops, begin, end


def _pass(seen, cfg, threads):
    n = len(seen["plens"])
    out = (np.zeros(n, np.int32), np.zeros((n, 2 * cfg.read_size), np.uint8),
           np.zeros(n, np.int32), np.zeros(n, np.int32))
    used = tapi._decode_pass(seen["grammar"], seen["chunks"], cfg,
                             seen["plens"], seen["tlens"], *out, threads)
    return out, used


def _assert_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# (CLI flags, pairs, read length, generated error, chunk pairs, devices)
FAMILIES = {
    # K1: five chunks, the last one ragged, and three shards a chunk
    "wfa100": (["wfa", "-l", "100", "-e", "0.01", "-b", "-r"], 300, 100,
               0.01, 64, 1),
    "wfa100-shards": (["wfa", "-l", "100", "-e", "0.01", "-b", "-r"], 300,
                      100, 0.01, 96, 3),
    # K5 at 10 kbp: a chunk of 8 and a ragged one of 2
    "wfa10k": (["wfa", "-l", "10000", "-e", "0.01", "-b", "-r", "--variant",
                "hbm"], 10, 10000, 0.01, 8, 1),
    # K4's step records, one level row a text position
    "genasm100": (["genasm", "-l", "100", "-e", "0.01", "-b"], 200, 100,
                  0.01, 64, 1),
    # K2 and K3 packed runs, K2 flagging most pairs at 10 % errors
    "nw100": (["nw", "-l", "100", "-e", "0.01", "-b"], 200, 100, 0.1, 64, 1),
    "swg100": (["swg", "-l", "100", "-e", "0.01", "-b"], 200, 100, 0.01, 64,
               1),
    # the streamed tier (K6/K7) and the GenASM long tier on it
    "nw1500": (["nw", "-l", "1500", "-e", "0.01", "-b", "--variant", "hbm"],
               20, 1500, 0.01, 8, 1),
    "genasm600": (["genasm", "-l", "600", "-e", "0.05", "-b"], 40, 600,
                  0.05, 16, 1),
}
GRAMMARS = {"wfa100": kernels.STEP_RECORDS, "wfa10k": kernels.STEP_RECORDS,
            "genasm100": kernels.GENASM_RECORDS}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pass_writes_the_per_chunk_bytes(family, monkeypatch):
    argv, n, length, err, bs, ndev = FAMILIES[family]
    cfg = _cfg(argv).replace(batch_pairs=bs)
    p, t, pl, tl = _pairs(cfg, n, length, err)
    seen = _captured(monkeypatch, p, t, pl, tl, cfg, ["cpu"] * ndev)
    assert seen["grammar"] == GRAMMARS.get(family.split("-")[0],
                                           kernels.PACKED_RUNS)
    assert len(seen["chunks"]) == -(-n // bs) > 1
    assert n % bs, "the last chunk is ragged"
    # a chunk gathered from one block a device; the ragged one's blocks
    # past its end are empty and launch nothing
    assert seen["blocks"][:-1] == [ndev] * (len(seen["chunks"]) - 1)
    want = _per_chunk(seen["grammar"], seen["chunks"], cfg, seen["plens"],
                      seen["tlens"])
    for threads in (1, 2, 3, 7):
        got, used = _pass(seen, cfg, threads)
        step = -(-n // threads)
        assert used == -(-n // step)
        _assert_equal(got, want)


def test_thread_minimum(monkeypatch):
    """Below the thread minimum the pass runs on one thread, above it on
    several; the output is the same either way."""
    monkeypatch.setattr(tapi.os, "cpu_count", lambda: 8)
    cfg = WFA.replace(batch_pairs=64)
    n = 300
    p, t, pl, tl = _pairs(cfg, n, 100, 0.01, seed=11)
    row = 2 * cfg.read_size
    assert n * row < 2 * tapi.DECODE_MIN_BYTES
    below = tapi.align(p, t, pl, tl, cfg, "cpu")
    assert below.spans.counts["decode_threads"] == 1
    monkeypatch.setattr(tapi, "DECODE_MIN_BYTES", 50 * row)
    above = tapi.align(p, t, pl, tl, cfg, "cpu")
    assert above.spans.counts["decode_threads"] == 6
    assert spans.calls()[-1]["decode_threads"] == 6
    _assert_equal((above.scores, above.ops, above.begin, above.end),
                  (below.scores, below.ops, below.begin, below.end))


def test_thread_rule(monkeypatch):
    monkeypatch.setattr(tapi.os, "cpu_count", lambda: 32)
    m = tapi.DECODE_MIN_BYTES
    assert tapi._decode_threads(0, 224) == 1
    assert tapi._decode_threads(2 * m // 224 - 1, 224) == 1
    assert tapi._decode_threads(2 * m // 224 + 1, 224) == 2
    assert tapi._decode_threads(10 ** 6, 20224) == 16
    monkeypatch.setattr(tapi.os, "cpu_count", lambda: 8)
    assert tapi._decode_threads(10 ** 6, 224) == min(8, 224 * 10 ** 6 // m)


def test_decoders_write_into_out_views():
    """``out=`` row blocks of larger arrays get the allocating call's
    bytes, are what the call returns, and leave other rows alone; a view
    of the wrong shape, dtype or order is refused."""
    cfg = WFA
    p, t, pl, tl = _pairs(cfg, 40, 100, 0.01)
    tier = kernels.forward_fn(cfg, packed_ok=False)
    args = tapi.to_device_batch(p, t, pl, tl, "cpu")
    steps = tier(*args, cfg=cfg, packed=False).numpy()
    max_ops = 2 * cfg.read_size
    want = native.wfa_steps_to_ops(steps, pl, tl, max_score=cfg.max_score,
                                   max_ops=max_ops)
    big = (np.full(60, 7, np.int32), np.full((60, max_ops), 9, np.uint8),
           np.full(60, 7, np.int32), np.full(60, 7, np.int32))
    view = tuple(a[10:50] for a in big)
    got = native.wfa_steps_to_ops(steps, pl, tl, max_score=cfg.max_score,
                                  max_ops=max_ops, out=view)
    assert all(g is v for g, v in zip(got, view))
    _assert_equal(view, want)
    assert all((a[:10] == a.flat[0]).all() and (a[50:] == a.flat[0]).all()
               for a in big)

    nw = derive_config("nw", 100, 0.01, backtrace=True)
    tier = kernels.forward_fn(nw, packed_ok=False)
    runs = tier(*tapi.to_device_batch(p, t, pl, tl, "cpu"), cfg=nw,
                packed=False).numpy()
    sc = runs[:, 1].astype(np.int32)
    want = native.wfa_runs_to_ops(runs, sc, pl, tl, max_score=1 << 30,
                                  max_ops=max_ops)
    view = tuple(a[5:45] for a in big[1:])
    got = native.wfa_runs_to_ops(runs, sc, pl, tl, max_score=1 << 30,
                                 max_ops=max_ops, out=view)
    assert all(g is v for g, v in zip(got, view))
    _assert_equal(view, want)

    bad = [view[:2],                                      # one short
           (view[0][:, :-1], *view[1:]),                  # narrow rows
           (view[0].astype(np.int8), *view[1:]),          # dtype
           (np.asfortranarray(view[0]), *view[1:]),       # order
           (view[0], view[1][::2], view[2])]              # strided
    for out in bad:
        with pytest.raises(ValueError):
            native.wfa_runs_to_ops(runs, sc, pl, tl, max_score=1 << 30,
                                   max_ops=max_ops, out=out)
    with pytest.raises(ValueError):
        native.wfa_steps_to_ops(steps, pl, tl, max_score=cfg.max_score,
                                max_ops=max_ops, out=view)


def test_retry_overwrites_the_pass(monkeypatch):
    """NW at 10 % errors on several threads: K2 flags most pairs; the
    ladder and the oracle rewrite their rows after the pass, so the
    result is the oracle's, though the pass wrote other bytes there."""
    monkeypatch.setattr(tapi.os, "cpu_count", lambda: 8)
    cfg = derive_config("nw", 100, 0.01, backtrace=True).replace(
        batch_pairs=32)
    n = 96
    monkeypatch.setattr(tapi, "DECODE_MIN_BYTES", 16 * 2 * cfg.read_size)
    p, t, pl, tl = _pairs(cfg, n, 100, 0.1)
    passed = {}
    real = tapi._decode_pass

    def spy(grammar, chunks, cfg, plens, tlens, scores, ops, begin, end,
            threads):
        used = real(grammar, chunks, cfg, plens, tlens, scores, ops, begin,
                    end, threads)
        passed["ops"], passed["begin"] = ops.copy(), begin.copy()
        return used

    monkeypatch.setattr(tapi, "_decode_pass", spy)
    res = tapi.align(p, t, pl, tl, cfg, "cpu")
    assert res.spans.counts["decode_threads"] == 6
    assert res.n_retry > 0 and res.n_fallback > 0
    osc, oops, ob, oe = tapi._oracle_align(p, t, pl, tl, cfg)
    _assert_equal((res.scores, res.ops, res.begin, res.end),
                  (osc, oops, ob, oe))
    rewritten = (passed["ops"] != res.ops).any(1) \
        | (passed["begin"] != res.begin)
    assert rewritten.sum() > 0


def test_decode_threads_zero_without_cigars():
    p, t, pl, tl = _pairs(WFA, 50, 100, 0.01)
    res = tapi.align(p, t, pl, tl, WFA.replace(backtrace=False), "cpu")
    assert res.spans.counts["decode_threads"] == 0
    assert res.spans.seconds["decode"] > 0
    res = tapi.align(p[:0], t[:0], pl[:0], tl[:0], WFA, "cpu")
    assert res.spans.counts["decode_threads"] == 0
    assert res.spans.seconds["decode"] == 0
    with_bt = tapi.align(p, t, pl, tl, WFA, "cpu")
    assert with_bt.spans.counts["decode_threads"] == 1
    np.testing.assert_array_equal(
        tapi.align(p, t, pl, tl, WFA.replace(backtrace=False),
                   "cpu").scores, with_bt.scores)


# ---- the step-record expander's counters ----------------------------------

def test_genasm_call_counts_skipped_rows(monkeypatch):
    """GenASM at 100 bp, k = 2, one edit a pair: one level row a text
    position, nearly all match-only.  The call's counters read the
    grammar's counts on the records the pass saw: at least 90 % of the
    level rows stepped over with no write, no pair clamped."""
    cfg = _cfg(FAMILIES["genasm100"][0]).replace(batch_pairs=64)
    R = cfg.read_size
    p, t, pl, tl = _pairs(cfg, 200, 100, 0.01)
    seen = _captured(monkeypatch, p, t, pl, tl, cfg)
    counts = spans.calls()[-1]
    rec = np.concatenate([r for _, r in seen["chunks"]])
    want = step_stats(rec, seen["plens"], seen["tlens"], R, 2 * R)
    assert counts["decode_skipped_rows"] == want["skipped_rows"]
    assert counts["decode_clamped_pairs"] == want["clamped_pairs"] == 0
    level_rows = int((rec[:, R + 3] <= R).sum()) * (R + 1)
    assert counts["decode_skipped_rows"] >= 0.9 * level_rows


@pytest.mark.parametrize("threads", [1, 3])
def test_pass_counts_clamped_pairs_exactly(threads):
    """Random step records, some overrunning their rows, in two chunks:
    the ranges' counts sum to the grammar's, clamped pairs exactly."""
    rec, pl, tl, levels, max_ops = step_decode_case("random_overrun")
    cfg = AlignConfig(algo="wfa", read_size=max_ops // 2, max_score=levels,
                      backtrace=True)
    n = len(pl)
    out = (np.zeros(n, np.int32), np.zeros((n, max_ops), np.uint8),
           np.zeros(n, np.int32), np.zeros(n, np.int32))
    chunks = [(0, rec[:150]), (150, rec[150:])]
    with spans.call("align", n) as call:
        used = tapi._decode_pass(kernels.STEP_RECORDS, chunks, cfg, pl, tl,
                                 *out, threads)
    assert used == threads
    want = step_stats(rec, pl, tl, levels, max_ops)
    assert want["clamped_pairs"] > 0
    assert call.counts["decode_clamped_pairs"] == want["clamped_pairs"]
    assert call.counts["decode_skipped_rows"] == want["skipped_rows"]
    _assert_equal(out, native.wfa_steps_to_ops(rec, pl, tl, max_score=levels,
                                               max_ops=max_ops))
