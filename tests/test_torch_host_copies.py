"""The port's own host modules against the JAX package's, which they copy:
``aim_tpu_torch.config`` (config derivation and the WRAM gate),
``aim_tpu_torch.cli`` (``build_parser`` / ``config_from_args``),
``aim_tpu_torch.datagen`` and ``aim_tpu_torch.native`` (the g++-built
oracle, parser, record decoders and emitter, built into the port's own
build directory).  Tolerance: exact (equal fields, equal arrays, equal
file bytes).
"""

import dataclasses
import itertools
import os

import numpy as np
import pytest

import aim_tpu.cli as jcli
import aim_tpu.config as jconfig
import aim_tpu.datagen as jdatagen
import aim_tpu.native as jnat
import aim_tpu_torch.native as tnat
from aim_tpu_torch import cli as tcli
from aim_tpu_torch import config as tconfig
from aim_tpu_torch import datagen as tdatagen
from torch_cases import STEP_DECODE_CASES, step_decode_case, step_stats
from util import pack, random_pairs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "sample-l100-e1-2K")


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_config_copy_matches_reference():
    assert [f.name for f in dataclasses.fields(tconfig.AlignConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.AlignConfig)]
    for name in ("ALGO_NW", "ALGO_SWG", "ALGO_WFA", "ALGO_GENASM"):
        assert getattr(tconfig, name) == getattr(jconfig, name)
    for x in (0, 1, 7, 8, 9, 100.5, 101, 4103.2):
        assert tconfig.launcher_pad8(x) == jconfig.launcher_pad8(x)
        assert tconfig.round_up_multiple_8(int(x)) == \
            jconfig.round_up_multiple_8(int(x))
    n = 0
    for algo, length, err, variant, bt, ad in itertools.product(
            ("nw", "swg", "wfa", "genasm"),
            (50, 100, 150, 1000, 4096, 10000, 16000),
            (0.0, 0.005, 0.01, 0.02, 0.05, 0.14),
            ("vmem", "hbm"), (False, True), (False, True)):
        kw = dict(backtrace=bt, variant=variant)
        if algo == "wfa":
            kw["adaptive"] = ad
        elif ad:
            continue
        t = tconfig.derive_config(algo, length, err, **kw)
        j = jconfig.derive_config(algo, length, err, **kw)
        assert _fields(t) == _fields(j), (algo, length, err, kw)
        assert tconfig.wram_feasible(t) == jconfig.wram_feasible(j)
        assert (t.cell_width, t.offset_null) == (j.cell_width, j.offset_null)
        n += 1
    assert n > 500


ARGVS = [
    ["wfa", "-l", "100", "-e", "0.01", "-b", "-r"],
    ["wfa", "-l", "10000", "-e", "0.01", "-b", "-r", "--variant", "hbm"],
    ["wfa", "-l", "100", "-e", "0.005", "-b", "--overflow-backtrace",
     "-x", "5", "-g", "2", "-a", "1"],
    ["nw", "-l", "100", "-e", "0.01", "-b"],
    ["nw", "-l", "4096", "-e", "0.01", "-b", "--variant", "hbm", "-t", "2"],
    ["swg", "-l", "4096", "-e", "0.01", "-b", "--variant", "hbm"],
    ["swg", "-l", "100", "-e", "0.01", "-m", "-1", "-x", "4", "-g", "6",
     "-a", "2"],
    ["genasm", "-l", "4096", "-e", "0.01", "-b"],
    ["genasm", "-l", "100", "-e", "0.01", "-d", "1", "-q"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "-".join(a[:3]))
def test_cli_config_copy_matches_reference(argv):
    argv = argv[:1] + ["-i", "pairs", "-n", "1000"] + argv[1:]
    t = tcli.build_parser().parse_args(argv)
    j = jcli.build_parser().parse_args(argv)
    assert vars(t) == vars(j)
    assert _fields(tcli.config_from_args(t)) == \
        _fields(jcli.config_from_args(j))


def test_cli_gen_subcommand_matches_reference(tmp_path):
    argv = ["gen", "-o", "", "-l", "150", "-e", "0.02", "-n", "50"]
    t = tcli.build_parser().parse_args(argv)
    j = jcli.build_parser().parse_args(argv)
    assert vars(t) == vars(j)
    out = tmp_path / "gen"
    assert tcli.main(["gen", "-o", str(out), "-l", "150", "-e", "0.02",
                      "-n", "50", "--seed", "4"]) == 0
    ref = tmp_path / "ref"
    jdatagen.write_pair_file(str(ref), 50, 150, 0.02, seed=4)
    assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("length,err,seed", [(100, 0.01, 0), (1000, 0.02, 3),
                                             (4096, 0.01, 1)])
def test_datagen_copy_matches_reference(tmp_path, length, err, seed):
    t = tdatagen.generate_pairs(64, length, err, seed=seed)
    j = jdatagen.generate_pairs(64, length, err, seed=seed)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    tf, jf = tmp_path / "t", tmp_path / "j"
    assert tdatagen.write_pair_file(str(tf), 64, length, err, seed=seed) == \
        jdatagen.write_pair_file(str(jf), 64, length, err, seed=seed)
    assert tf.read_bytes() == jf.read_bytes()


def test_native_builds_into_the_ports_build_dir():
    so = tnat.library_path()
    tnat.load()
    assert os.path.exists(so)
    assert os.path.dirname(so) == os.path.join(REPO, "aim_tpu_torch",
                                               "_build")
    assert not os.path.exists(os.path.join(REPO, "aim_tpu_torch", "native",
                                           "_liboracle.so"))
    assert tnat.load()._name != jnat.load()._name


def _batch(seed=11, n=96, R=120, alphabet="ACGT"):
    return pack(random_pairs(seed=seed, n=n, max_len=R - 8, balanced=False,
                             alphabet=alphabet), R)


def test_native_parser_and_packer_match_reference():
    for n, R in ((40, 112), (1000, 112), (7, 128)):
        t = tnat.parse_pairs(SAMPLE, n, R, threads=2)
        j = jnat.parse_pairs(SAMPLE, n, R, threads=2)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    assert tnat.count_pairs(SAMPLE, 10 ** 6) == jnat.count_pairs(SAMPLE,
                                                                 10 ** 6)
    for alphabet in ("ACGT", "ACGTN"):
        p, t, pl, tl = _batch(alphabet=alphabet)
        a = tnat.pack_seqs(p, t, pl, tl, 128)
        b = jnat.pack_seqs(p, t, pl, tl, 128)
        assert a[2] == b[2] == (alphabet == "ACGT")
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_native_oracles_and_emitter_match_reference(tmp_path):
    p, t, pl, tl = _batch()
    calls = [
        ("nw_align", dict(mismatch=3, gap_i=4, gap_d=4, backtrace=True)),
        ("nw_align", dict(mismatch=1, gap_i=2, gap_d=3, backtrace=False)),
        ("swg_align", dict(match=0, mismatch=3, gap_o=4, gap_e=1,
                           max_score=60, cell_width=2, backtrace=True)),
        ("swg_align", dict(match=0, mismatch=3, gap_o=4, gap_e=1,
                           max_score=20, cell_width=1, backtrace=True)),
        ("wfa_align", dict(mismatch=3, gap_o=4, gap_e=1, max_score=30,
                           adaptive=True, backtrace=True)),
        ("wfa_align", dict(mismatch=3, gap_o=4, gap_e=1, max_score=5,
                           adaptive=False, backtrace=True,
                           overflow_backtrace=True)),
        ("genasm_align", dict(max_score=12, backtrace=True)),
        ("genasm_align", dict(max_score=40, backtrace=False)),
    ]
    for name, kw in calls:
        a = getattr(tnat, name)(p, t, pl, tl, threads=2, **kw)
        b = getattr(jnat, name)(p, t, pl, tl, threads=2, **kw)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
        sc, ops, be, en = a
        bt = kw["backtrace"]
        idx = np.arange(len(sc), dtype=np.int32)
        tnat.emit_output(str(tmp_path / "t"), idx, sc, ops, be, en, bt)
        jnat.emit_output(str(tmp_path / "j"), idx, sc, ops, be, en, bt)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


@pytest.mark.parametrize("NRL", [256, 1024])
def test_native_run_decoders_match_reference(NRL):
    rng = np.random.default_rng(NRL)
    n = 64
    runs = np.zeros((n, NRL), np.int16)
    plens = np.zeros(n, np.int32)
    tlens = np.zeros(n, np.int32)
    for i in range(n):
        k = int(rng.integers(1, NRL - 3))
        ops = rng.integers(0, 4, k)
        lens = rng.integers(1, 40, k)
        rc = NRL - 1 - k
        runs[i, rc + 1:] = (ops << 12) | lens
        runs[i, 0] = (rc & 255) | (int(rng.integers(0, 2)) << 8) \
            | ((rc >> 8) << 10)
        runs[i, 1] = int(rng.integers(0, 500))
        plens[i] = int(lens[ops != 2].sum())
        tlens[i] = int(lens[ops != 3].sum())
    scores = runs[:, 1].astype(np.int32)
    max_ops = int(max(plens.max(), tlens.max())) * 2 + 8
    a = tnat.wfa_runs_to_ops(runs, scores, plens, tlens, max_score=1 << 30,
                             max_ops=max_ops)
    b = jnat.wfa_runs_to_ops(runs, scores, plens, tlens, max_score=1 << 30,
                             max_ops=max_ops)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", STEP_DECODE_CASES)
def test_native_step_decoder_matches_reference(name):
    """The port's right-to-left expander against the JAX package's, byte
    for byte: K1's and K4's records (GenASM's one level row a text
    position, over-k pairs included), K5-length strokes and gaps, and
    random records of which some overrun their rows (the clamped
    expansion); its stats as the grammar says."""
    rec, pl, tl, levels, max_ops = step_decode_case(name)
    stats = {}
    a = tnat.wfa_steps_to_ops(rec, pl, tl, max_score=levels, max_ops=max_ops,
                              stats=stats)
    b = jnat.wfa_steps_to_ops(rec, pl, tl, max_score=levels, max_ops=max_ops)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert stats == step_stats(rec, pl, tl, levels, max_ops)
    assert (stats["clamped_pairs"] > 0) is (name == "random_overrun")


def test_native_step_decoder_malformed_records():
    """The port's expander on garbage step records (oversized strokes,
    gaps past the row, huge final strokes, a score past smax): every
    write in bounds, the bytes of the JAX package's expander, and each
    overrunning pair (0-2; pair 3 is past smax and not walked) sent
    through the clamped expansion."""
    n, smax, R = 4, 5, 16
    recs = np.zeros((n, smax + 4), np.int32)
    pl = np.full(n, 10, np.int32)
    tl = np.full(n, 10, np.int32)
    recs[0, :smax + 1] = 0x3FFF
    recs[0, smax + 3] = 3
    recs[1, :smax + 1] = (0x7FF << 16) | (1 << 27) | (1 << 14)
    recs[1, smax + 3] = 2
    recs[2, smax + 1] = 0x3FFF | (3 << 14)
    recs[2, smax + 2] = 0x3FFF | (2 << 14)
    recs[3, smax + 3] = smax + 1
    stats = {}
    got = tnat.wfa_steps_to_ops(recs, pl, tl, max_score=smax, max_ops=2 * R,
                                stats=stats)
    want = jnat.wfa_steps_to_ops(recs, pl, tl, max_score=smax, max_ops=2 * R)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    sc, ops, b, e = got
    assert ops.shape == (n, 2 * R)
    assert (b >= 0).all() and (b <= 2 * R).all()
    assert (e == pl + tl).all()
    assert sc[3] == smax + 1
    assert ops[3, b[3]:e[3]].tobytes() == b"M"
    assert stats == {"skipped_rows": 0, "clamped_pairs": 3}
