"""The port's pair sharding on the CPU: ``aim_tpu_torch.parallel`` and
``api.align`` over a device list.

Mirrors ``tests/test_sharding.py`` with its inputs and seeds.  A list of
``["cpu"] * 4`` runs four shards through the kernels' plain versions (and
the dense tiers under ``backend="xla"``), as the JAX tests run an
8-device virtual CPU mesh.  Tolerance: exact (integer records,
byte-identical files).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import aim_tpu.native as nat
from aim_tpu.config import AlignConfig
from aim_tpu_torch import api as tapi
from aim_tpu_torch import cli as tcli
from aim_tpu_torch.ops import kernels
from aim_tpu_torch.parallel import mesh, runner
from aim_tpu_torch.tools import dryrun_multichip, scaling
from tests.util import pack, random_pairs, write_pair_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "sample-l100-e1-2K")
SHARDS = ["cpu"] * 4


@pytest.mark.parametrize("n_hosts", range(1, 9))
def test_shard_range_matches_reference(n_hosts):
    """Equal to aim_tpu's shard_range; the ranges cover every pair once,
    in file order."""
    from aim_tpu.parallel.mesh import shard_range
    for total in range(0, 1004):
        got = [mesh.shard_range(total, h, n_hosts) for h in range(n_hosts)]
        assert got == [shard_range(total, h, n_hosts)
                       for h in range(n_hosts)]
        covered = [i for lo, hi in got for i in range(lo, hi)]
        assert covered == list(range(total))


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_deal_order_matches_reference(ndev):
    from aim_tpu.api import _deal_order
    rng = np.random.default_rng(ndev)
    for n in (1, 7, 64, 100, 1000, 1003):
        for bs in (8 * ndev, 64 * ndev, 1024):
            order = rng.permutation(n)
            got = tapi._deal_order(order, n, bs, ndev)
            np.testing.assert_array_equal(got, _deal_order(order, n, bs,
                                                           ndev))
            np.testing.assert_array_equal(np.sort(got), np.arange(n))


def test_devices_and_device_lists(monkeypatch):
    """devices(n) lists the first n cards and raises past the host's; a
    device list naming a missing card raises before any work."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cuda = [torch.device("cuda", i) for i in range(3)]
    assert mesh.devices() == cuda and mesh.devices(2) == cuda[:2]
    for n in (0, 4):
        with pytest.raises(RuntimeError):
            mesh.devices(n)
    assert tapi._device_list(["cpu"] * 2) == [torch.device("cpu")] * 2
    assert tapi._device_list(cuda[2]) == [cuda[2]]
    with pytest.raises(RuntimeError):
        tapi._device_list(cuda + [torch.device("cuda", 3)])
    with pytest.raises(ValueError):
        tapi._device_list([])
    p, t, pl, tl = pack(random_pairs(seed=31, n=8, max_len=24), 24)
    cfg = AlignConfig(algo="wfa", read_size=24, max_score=12)
    with pytest.raises(RuntimeError):
        tapi.align(p, t, pl, tl, cfg, ["cpu", torch.device("cuda", 3)])


def test_plan_bs_aligns_to_devices():
    cfg = AlignConfig(algo="wfa", read_size=112, max_score=5,
                      batch_pairs=1000)
    assert tapi._plan_bs(cfg, 5000, SHARDS) == 1024
    assert tapi._plan_bs(cfg, 40, SHARDS) == 64
    assert tapi._plan_bs(cfg, 3, ["cpu"] * 3) == 24
    assert tapi._plan_bs(cfg, 40, "cpu") == 40


def _cfg_for(case):
    """(config, pairs, env) of a sharded case, from test_sharding.py's
    seeds where it has the family."""
    if case.startswith("wfa"):
        return AlignConfig(algo="wfa", read_size=24, max_score=12,
                           backtrace=True, adaptive=True,
                           batch_pairs=64), random_pairs(31, 100, 24), {}
    if case.startswith("nw"):
        return AlignConfig(algo="nw", read_size=40, max_score=10,
                           backtrace=True, gap_i=2, gap_d=3, mismatch=3,
                           batch_pairs=64), random_pairs(53, 100, 32), {}
    if case.startswith("swg"):
        return AlignConfig(algo="swg", read_size=40, max_score=26,
                           backtrace=True, match=0, mismatch=3, gap_o=4,
                           gap_e=1, batch_pairs=64), \
            random_pairs(59, 100, 32), {}
    if case.startswith("genasm"):
        return AlignConfig(algo="genasm", read_size=40, max_score=6,
                           backtrace=True, batch_pairs=64), \
            random_pairs(61, 100, 32), {}
    if case.startswith("long"):
        # 160 pairs > 128 at R 640: sorted, then dealt over the shards
        return AlignConfig(algo="wfa", read_size=640, max_score=40,
                           backtrace=True, adaptive=True, variant="hbm",
                           batch_pairs=64), \
            random_pairs(67, 160, 600), {"AIM_TPU_SORT": "1"}
    raise KeyError(case)


def _spy_forward(monkeypatch):
    """Record (rows, device) of every primary-tier call of api.align."""
    calls = []
    forward_fn = kernels.forward_fn

    def spied(cfg, packed_ok=True):
        tier = forward_fn(cfg, packed_ok)
        if tier.forward is None:
            return tier

        def fwd(*args, **kw):
            calls.append((args[0].shape[0], args[0].device))
            return tier.forward(*args, **kw)
        return dataclasses.replace(tier, forward=fwd)

    monkeypatch.setattr(tapi.kernels, "forward_fn", spied)
    return calls


def _oracle(p, t, pl, tl, cfg):
    if cfg.algo == "wfa":
        return nat.wfa_align(p, t, pl, tl, mismatch=cfg.mismatch,
                             gap_o=cfg.gap_o, gap_e=cfg.gap_e,
                             max_score=cfg.max_score, adaptive=cfg.adaptive,
                             backtrace=cfg.backtrace)
    return tapi._oracle_align(p, t, pl, tl, cfg)


def _file(path, scores, ops, begin, end, backtrace):
    nat.emit_output(str(path), np.arange(len(scores), dtype=np.int32),
                    scores, ops, begin, end, backtrace)
    return path.read_bytes()


@pytest.mark.parametrize("case", ["wfa", "wfa-xla", "nw", "nw-xla", "swg",
                                  "swg-xla", "genasm", "long-sorted"])
def test_sharded_align_equals_one_shard_and_oracle(tmp_path, monkeypatch,
                                                   case):
    """Four shards on the CPU: byte-equal to one shard and to the oracle;
    each chunk split into contiguous blocks of bs // 4 pairs, the tail's
    empty blocks launched nowhere."""
    cfg, pairs, env = _cfg_for(case)
    if case.endswith("xla"):
        cfg = cfg.replace(backend="xla")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    p, t, pl, tl = pack(pairs, cfg.read_size)
    n = len(pl)
    calls = _spy_forward(monkeypatch)
    one = tapi.align(p, t, pl, tl, cfg, device="cpu")
    assert calls and all(d == torch.device("cpu") for _, d in calls)
    n_one = len(calls)
    sharded = tapi.align(p, t, pl, tl, cfg, device=SHARDS)
    blocks = [rows for rows, _ in calls[n_one:]]
    bs = tapi._plan_bs(cfg, n, SHARDS)
    want = [b1 - b0 for lo in range(0, n, bs)
            for _, b0, b1 in tapi._blocks(lo, min(lo + bs, n), bs, SHARDS)]
    assert blocks == want and sum(blocks) == n
    assert max(blocks) <= bs // 4 and len(blocks) < 4 * len(range(0, n, bs))
    files = {k: _file(tmp_path / k, r.scores, r.ops, r.begin, r.end, True)
             for k, r in (("one", one), ("sharded", sharded))}
    files["oracle"] = _file(tmp_path / "oracle", *_oracle(p, t, pl, tl, cfg),
                            True)
    assert files["sharded"] == files["one"] == files["oracle"]
    assert (sharded.n_fallback, sharded.n_retry) == (one.n_fallback,
                                                     one.n_retry)


def test_sharded_k2_ladder(tmp_path, monkeypatch):
    """K2's ladder over four shards (nw -l 100 -e 0.01 -b on pairs at
    10 %): each retry takes one block's flagged pairs, on its device; the
    counts and the file equal one shard's and the oracle's."""
    from aim_tpu_torch import datagen
    from aim_tpu_torch.cli import build_parser, config_from_args
    src = str(tmp_path / "pairs")
    datagen.write_pair_file(src, 96, 100, 0.1, seed=3)
    cfg = config_from_args(build_parser().parse_args(
        ["nw", "-i", src, "-l", "100", "-e", "0.01", "-n", "96", "-b"]))
    cfg = cfg.replace(batch_pairs=64)
    retried = []
    retry_wide = tapi._retry_wide

    def spy(tier, cfg, cpats, ctxts, cplens, ctlens, sel, *a, **kw):
        # a: scores ops begin end lo max_ops device res [planes]
        retried.append((sel.min(), sel.max(), a[6]))
        return retry_wide(tier, cfg, cpats, ctxts, cplens, ctlens, sel, *a,
                          **kw)

    monkeypatch.setattr(tapi, "_retry_wide", spy)
    outs = {}
    for name, dev in (("one", "cpu"), ("sharded", SHARDS)):
        retried.clear()
        outs[name] = tapi.align_file(src, str(tmp_path / name), 96, cfg,
                                     device=dev, verbose=False)
    one, sharded = outs["one"], outs["sharded"]
    blk = tapi._plan_bs(cfg, 96, SHARDS) // 4
    assert retried and all(lo // blk == hi // blk and d == torch.device(
        "cpu") for lo, hi, d in retried)
    assert sharded.n_retry == one.n_retry > 0
    assert sharded.n_fallback == one.n_fallback > 0
    assert sharded.retry_by_planes == one.retry_by_planes
    p, t, pl, tl = nat.parse_pairs(src, 96, cfg.read_size)
    oracle = _file(tmp_path / "oracle", *tapi._oracle_align(p, t, pl, tl,
                                                            cfg), True)
    body = (tmp_path / "sharded").read_bytes()
    assert body == (tmp_path / "one").read_bytes() == oracle


def _write_pairs(tmp_path, seed, n, max_len):
    inp = str(tmp_path / "pairs.txt")
    write_pair_file(inp, random_pairs(seed=seed, n=n, max_len=max_len))
    return inp


def test_runner_single_process(tmp_path):
    inp = _write_pairs(tmp_path, 41, 24, 20)
    out = str(tmp_path / "out.txt")
    cfg = AlignConfig(algo="wfa", read_size=32, max_score=8, backtrace=True,
                      backend="xla")
    n, res = runner.align_file_multihost(inp, out, 24, cfg, device="cpu",
                                         verbose=False)
    assert n == 24 and len(res.scores) == 24
    lines = open(out).read().splitlines()
    assert len(lines) == 48 and lines[0].startswith("0, ")
    assert runner.initialize_distributed(num_processes=1) == (0, 1)


RUNNER_SCRIPT = """
import sys
import torch.distributed as dist
from aim_tpu_torch.config import AlignConfig
from aim_tpu_torch.parallel.runner import (align_file_multihost,
                                           initialize_distributed)
rank, world = initialize_distributed(sys.argv[3])
cfg = AlignConfig(algo="wfa", read_size=32, max_score=8, backtrace=True)
align_file_multihost(sys.argv[1], sys.argv[2], 90, cfg, rank, world,
                     device="cpu", verbose=False)
dist.destroy_process_group()
"""


def test_runner_four_processes(tmp_path):
    """Four processes (gloo, a file store): the joined file equals the
    one-process run, the oracle and aim_tpu's runner at one process
    (backend xla); no part file is left."""
    from aim_tpu.parallel.runner import align_file_multihost
    inp = _write_pairs(tmp_path, 43, 90, 20)
    cfg = AlignConfig(algo="wfa", read_size=32, max_score=8, backtrace=True)
    one, jx, out = (str(tmp_path / f) for f in ("one", "jax", "out"))
    runner.align_file_multihost(inp, one, 90, cfg, device="cpu",
                                verbose=False)
    align_file_multihost(inp, jx, 90, cfg.replace(backend="xla"),
                         verbose=False)
    store = tmp_path / "store"
    env = dict(os.environ, WORLD_SIZE="4",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen([sys.executable, "-c", RUNNER_SCRIPT, inp, out,
                               f"file://{store}"], cwd=REPO,
                              env=dict(env, RANK=str(r)))
             for r in range(4)]
    try:
        for pr in procs:
            assert pr.wait(timeout=120) == 0
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    p, t, pl, tl = nat.parse_pairs(inp, 90, 32)
    oracle = _file(tmp_path / "oracle", *_oracle(p, t, pl, tl, cfg), True)
    body = open(out, "rb").read()
    assert body == open(one, "rb").read() == open(jx, "rb").read() == oracle
    assert not [f for f in os.listdir(tmp_path) if ".part" in f]


@pytest.mark.parametrize("cards,d,n,quiet", [
    (4, None, 1000, False), (4, 2, 1000, False), (1, None, 1000, False),
    (4, 1, 1000, False), (8, 3, 999, False), (4, None, 1000, True)])
def test_cli_shards_over_cards(tmp_path, monkeypatch, capsys, cards, d, n,
                               quiet):
    """ndev is the card count capped by -d; over several cards the CLI
    prints the reference's two lines (as aim_tpu.cli does over its 8
    virtual devices) and passes the cards to align_file."""
    import aim_tpu.api
    from aim_tpu import cli as jcli
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(tapi, "align_file",
                        lambda *a, device, **kw: seen.append(device))
    monkeypatch.setattr(aim_tpu.api, "align_file",
                        lambda *a, **kw: seen.append(kw["device_sharding"]))
    argv = ["wfa", "-i", SAMPLE, "-o", str(tmp_path / "o"), "-l", "100",
            "-e", "0.01", "-n", str(n), "-b", "-r"] + \
        (["-d", str(d)] if d else []) + (["-q"] if quiet else [])
    want = min(cards, d or cards)
    assert tcli.main(argv) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(("Allocated", "NumReads"))]
    assert seen.pop() == [torch.device("cuda", i) for i in range(want)]
    if quiet or want == 1:
        assert lines == []
    else:
        assert lines == [f"Allocated {want} device(s)",
                         f"NumReads per device = "
                         f"{((n // want) + 7) // 8 * 8}"]
    if d and d <= cards:
        assert jcli.main(argv) == 0
        jlines = [ln for ln in capsys.readouterr().out.splitlines()
                  if ln.startswith(("Allocated", "NumReads"))]
        assert jlines == lines


def test_cli_rejects_more_cards_than_pairs(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    rc = tcli.main(["wfa", "-i", SAMPLE, "-o", str(tmp_path / "o"), "-l",
                    "100", "-e", "0.01", "-n", "4", "-b"])
    assert rc == 1
    assert "Allocated DPUs more than needed" in capsys.readouterr().out


def test_dryrun_multichip_cpu():
    reps = dryrun_multichip.dryrun(4, device="cpu", n_pairs=200,
                                   batch_pairs=64)
    assert [r["algo"] for r in reps] == list(dryrun_multichip.FAMILIES)
    assert all(r["equal_one_shard"] and r["equal_oracle"] for r in reps)
    assert [r["tier"] for r in reps] == ["K1", "K2", "K3", "K4"]


def test_scaling_rows_cpu(monkeypatch):
    """The scaling rows' arithmetic; shards sharing one device give the
    shared-card column, not an efficiency.  Both tools refuse to run
    without CUDA (a CPU time says nothing of the card)."""
    rows = scaling.rows(48, [[torch.device("cpu")],
                             [torch.device("cpu")] * 2], repeats=1)
    assert [r["devices"] for r in rows] == [1, 2]
    assert "vs_1dev_shared_card" in rows[1]
    assert all(r["pairs_per_s"] > 0 for r in rows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert scaling.main(["16"]) == 2 and dryrun_multichip.main(["2"]) == 2


def test_runner_main_one_process(tmp_path, monkeypatch):
    """``python -m aim_tpu_torch.parallel.runner`` takes the CLI's
    arguments; one process (no WORLD_SIZE) joins no group and writes the
    whole file, equal to align_file's."""
    from aim_tpu_torch.cli import build_parser, config_from_args
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(runner, "local_device",
                        lambda process_id: torch.device("cpu"))
    argv = ["wfa", "-i", SAMPLE, "-l", "100", "-e", "0.01", "-n", "64", "-b",
            "-r"]
    out, one = str(tmp_path / "out"), str(tmp_path / "one")
    assert runner.main(argv + ["-o", out, "-q"]) == 0
    cfg = config_from_args(build_parser().parse_args(argv))
    tapi.align_file(SAMPLE, one, 64, cfg, device="cpu", verbose=False)
    assert open(out, "rb").read() == open(one, "rb").read()
