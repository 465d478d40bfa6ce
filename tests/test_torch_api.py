"""The PyTorch port's pipeline (aim_tpu_torch.api / .cli) end to end.

On a host without a GPU the port runs its plain PyTorch kernel versions
on CPU tensors (``device="cpu"``); its output files must be
byte-identical to the native oracle's and to the JAX package's
(``aim_tpu.api.align_file`` on its XLA tier).  Tolerance: exact bytes.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import aim_tpu.native as nat
from aim_tpu.cli import build_parser, config_from_args
from aim_tpu.config import AlignConfig, derive_config
from aim_tpu_torch import api as tapi
from aim_tpu_torch import cli as tcli
from aim_tpu_torch.ops import genasm, kernels, wfa2, wfa_long

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "sample-l100-e1-2K")
N_SAMPLE = 1000


def _cfg(argv):
    return config_from_args(build_parser().parse_args(argv))


def _oracle_file(path, cfg, n, src=SAMPLE):
    p, t, pl, tl = nat.parse_pairs(src, n, cfg.read_size)
    if cfg.algo == "wfa":
        sc, ops, b, e = nat.wfa_align(
            p, t, pl, tl, mismatch=cfg.mismatch, gap_o=cfg.gap_o,
            gap_e=cfg.gap_e, max_score=cfg.max_score, adaptive=cfg.adaptive,
            backtrace=cfg.backtrace,
            overflow_backtrace=cfg.overflow_backtrace)
    elif cfg.algo == "genasm":
        sc, ops, b, e = nat.genasm_align(p, t, pl, tl,
                                         max_score=cfg.max_score,
                                         backtrace=cfg.backtrace)
    else:
        sc, ops, b, e = tapi._oracle_align(p, t, pl, tl, cfg)
    nat.emit_output(path, np.arange(len(sc), dtype=np.int32), sc, ops, b, e,
                    cfg.backtrace)
    return sc


@pytest.mark.parametrize("algo,err,flags", [
    pytest.param("wfa", "0.01", ["-b", "-r"], id="0.01-flags0"),
    pytest.param("wfa", "0.01", ["-b"], id="0.01-flags1"),
    pytest.param("wfa", "0.01", ["-r"], id="0.01-flags2"),
    pytest.param("wfa", "0.005", ["-b", "-r", "--overflow-backtrace"],
                 id="0.005-flags3"),
    pytest.param("nw", "0.01", ["-b"], id="nw-b"),
    pytest.param("nw", "0.01", [], id="nw"),
    pytest.param("swg", "0.01", ["-b"], id="swg-b"),
    pytest.param("swg", "0.01", [], id="swg"),
    pytest.param("genasm", "0.01", ["-b"], id="genasm-b"),
    pytest.param("genasm", "0.01", [], id="genasm"),
])
def test_align_file_cpu_matches_oracle_and_jax(tmp_path, algo, err, flags):
    from aim_tpu.api import align_file as jax_align_file
    argv = [algo, "-i", SAMPLE, "-o", "unused", "-l", "100", "-e", err,
            "-n", str(N_SAMPLE)] + flags
    cfg = _cfg(argv)
    got, jx, ref = (str(tmp_path / f) for f in ("port", "jax", "oracle"))
    res = tapi.align_file(SAMPLE, got, N_SAMPLE, cfg, device="cpu",
                          verbose=False)
    assert res.n_fallback == 0 and len(res.scores) == N_SAMPLE
    jax_align_file(SAMPLE, jx, N_SAMPLE, cfg.replace(backend="xla"),
                   verbose=False)
    osc = _oracle_file(ref, cfg, N_SAMPLE)
    np.testing.assert_array_equal(res.scores, osc)
    if cfg.overflow_backtrace:
        assert (osc > cfg.max_score).sum() > 100  # the pass has work
    body = open(got, "rb").read()
    assert body == open(ref, "rb").read()
    assert body == open(jx, "rb").read()


@pytest.mark.parametrize("argv,n,gen_err", [
    # 3 edits a pair against k = 2: most pairs overflow
    (["genasm", "-l", "100", "-e", "0.01", "-b"], 300, 0.03),
    (["genasm", "-l", "100", "-e", "0.01"], 300, 0.03),
    # 160 pairs > 128 at read_size >= 1024: the difficulty sort is on
    (["wfa", "-l", "1000", "-e", "0.01", "-b", "-r", "--variant", "hbm"],
     160, 0.01),
], ids=["genasm-b", "genasm", "wfa-l1000-hbm"])
def test_align_file_cpu_generated(tmp_path, argv, n, gen_err):
    """The GenASM tier (K4) and the WFA long-read tier (K5) file to file on
    generated pairs: cmp-equal to the oracle."""
    from aim_tpu import datagen
    src = str(tmp_path / "pairs")
    datagen.write_pair_file(src, n, int(argv[2]), gen_err, seed=3)
    cfg = _cfg(argv[:1] + ["-i", src, "-o", "unused", "-n", str(n)]
               + argv[1:])
    assert kernels.forward_fn(cfg).forward in (genasm.genasm_forward,
                                               wfa_long.wfa_forward_long)
    got, ref = str(tmp_path / "port"), str(tmp_path / "oracle")
    res = tapi.align_file(src, got, n, cfg, device="cpu", verbose=False)
    osc = _oracle_file(ref, cfg, n, src)
    assert res.n_fallback == 0
    np.testing.assert_array_equal(res.scores, osc)
    if cfg.algo == "genasm":
        assert (osc > cfg.max_score).sum() > 10  # overflow pairs too
    assert open(got, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("argv,n,gen_err,env,stages", [
    (["swg", "-l", "1000", "-e", "0.01", "-b", "--variant", "hbm"], 64, 0.01,
     {}, None),
    (["swg", "-l", "1000", "-e", "0.01", "--variant", "hbm"], 64, 0.01, {},
     None),
    (["genasm", "-l", "600", "-e", "0.05", "-b"], 64, 0.05, {}, None),
    (["genasm", "-l", "600", "-e", "0.05"], 64, 0.05, {}, None),
    (["nw", "-l", "1500", "-e", "0.01", "-b", "--variant", "hbm"], 32, 0.01,
     {}, None),
    # the primary at C = 63: flagged pairs climb the ladder
    (["swg", "-l", "1000", "-e", "0.03", "-b", "--variant", "hbm"], 48, 0.05,
     {"AIM_TPU_ROUTE": "0"}, {4}),
    # K2 flags most of these; the streamed tier's two planes certify some
    (["nw", "-l", "100", "-e", "0.01", "-b"], 64, 0.1, {}, {2}),
], ids=["swg-b", "swg", "genasm-b", "genasm", "nw-b", "swg-b-route0",
        "nw-k2-ladder"])
def test_align_file_cpu_long_tiers(tmp_path, monkeypatch, argv, n, gen_err,
                                   env, stages):
    """The streamed NW/SWG tier (K6/K7), the GenASM long tier and the
    band-retry ladder file to file on generated pairs: cmp-equal to the
    oracle."""
    from aim_tpu_torch import datagen
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    src = str(tmp_path / "pairs")
    datagen.write_pair_file(src, n, int(argv[2]), gen_err, seed=3)
    cfg = _cfg(argv[:1] + ["-i", src, "-o", "unused", "-n", str(n)]
               + argv[1:])
    tier = kernels.forward_fn(cfg)
    if argv[2] != "100":
        assert tier.records == kernels.PACKED_RUNS and tier.retry is not None
    got, ref = str(tmp_path / "port"), str(tmp_path / "oracle")
    res = tapi.align_file(src, got, n, cfg, device="cpu", verbose=False)
    osc = _oracle_file(ref, cfg, n, src)
    np.testing.assert_array_equal(res.scores, osc)
    assert open(got, "rb").read() == open(ref, "rb").read()
    assert res.n_retry == sum(res.retry_by_planes.values())
    if stages is not None:
        assert set(res.retry_by_planes) == stages
        assert min(res.retry_by_planes.values()) > 0


def test_difficulty_sort_as_reference(monkeypatch):
    """The sort order is the reference's; output order is the input's
    whether the sort runs or not; it runs for long reads past 128 pairs,
    and AIM_TPU_SORT forces it either way."""
    from aim_tpu import datagen
    from aim_tpu.api import _difficulty_order
    cfg = derive_config("wfa", 1000, 0.02, backtrace=True, adaptive=True,
                        variant="hbm")
    p, t, pl, tl = datagen.generate_pairs(150, 1000, 0.02,
                                          read_size=cfg.read_size, seed=8)
    order = tapi._difficulty_order(p, t, pl, tl)
    np.testing.assert_array_equal(order, _difficulty_order(p, t, pl, tl))
    assert (order != np.arange(len(pl))).any()
    calls = []
    impl = tapi._align_impl

    def spy(pats, *a, **kw):
        calls.append(pats.copy())
        return impl(pats, *a, **kw)

    monkeypatch.setattr(tapi, "_align_impl", spy)
    outs = {}
    for env in ("", "0", "1"):
        monkeypatch.setenv("AIM_TPU_SORT", env)
        outs[env] = tapi.align(p, t, pl, tl, cfg, device="cpu")
    np.testing.assert_array_equal(calls[0], p[order])   # default: on
    np.testing.assert_array_equal(calls[1], p)          # forced off
    np.testing.assert_array_equal(calls[2], p[order])   # forced on
    for res in outs.values():
        np.testing.assert_array_equal(res.scores, outs["0"].scores)
        np.testing.assert_array_equal(res.ops, outs["0"].ops)
        np.testing.assert_array_equal(res.begin, outs["0"].begin)
    # short reads: off by default
    monkeypatch.setenv("AIM_TPU_SORT", "")
    sp, st, spl, stl = nat.parse_pairs(SAMPLE, 200, 112)
    tapi.align(sp, st, spl, stl, derive_config("wfa", 100, 0.01),
               device="cpu")
    np.testing.assert_array_equal(calls[-1], sp)


def test_align_small_chunks_equal_one_chunk():
    """Chunking is invisible in the output (records are per pair)."""
    cfg = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    p, t, pl, tl = nat.parse_pairs(SAMPLE, 300, cfg.read_size)
    one = tapi.align(p, t, pl, tl, cfg, device="cpu")
    many = tapi.align(p, t, pl, tl, cfg.replace(batch_pairs=64),
                      device="cpu")
    np.testing.assert_array_equal(one.scores, many.scores)
    np.testing.assert_array_equal(one.ops, many.ops)
    np.testing.assert_array_equal(one.begin, many.begin)


def test_plan_bs_and_memory_cap():
    cfg = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    cpu = torch.device("cpu")
    assert tapi._plan_bs(cfg, 1000, cpu) == 1000
    assert tapi._plan_bs(cfg, 10 ** 6, cpu) == cfg.batch_pairs
    assert tapi._plan_bs(cfg, 3, cpu) == 8
    big = cfg.replace(max_score=79)
    assert not wfa2.hist_in_smem(big) and wfa2.hist_in_smem(cfg)
    assert tapi._memory_batch_cap(big, cpu, 1 << 30) < \
        tapi._memory_batch_cap(cfg, cpu, 1 << 30)


def test_device_log(tmp_path):
    cfg = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    path = tmp_path / "dev.log"
    res = tapi.align_file(SAMPLE, str(tmp_path / "o"), 50, cfg,
                          device="cpu", verbose=False, device_log=str(path))
    line = path.read_text()
    assert line.startswith("CPU: cpu | algo=wfa max_score=5 read_size=112")
    assert "pairs=50" in line and "fallback=0" in line
    assert res.n_fallback == 0


def test_device_log_lists_each_device(tmp_path):
    """A device list: one line a device, as aim_tpu/api.py:833-846 writes
    one a mesh device."""
    cfg = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    path = tmp_path / "dev.log"
    tapi.align_file(SAMPLE, str(tmp_path / "o"), 50, cfg,
                    device=["cpu"] * 3, verbose=False, device_log=str(path))
    lines = path.read_text().splitlines()
    assert len(lines) == 3 and len(set(lines)) == 1
    assert lines[0].startswith("CPU: cpu | algo=wfa max_score=5")
    assert "pairs=50" in lines[0] and "fallback=0" in lines[0]


@pytest.mark.parametrize("planes", [None, ""], ids=["retry", "fallback"])
def test_align_file_prints_retry_and_fallback(tmp_path, monkeypatch, capsys,
                                              planes):
    """The stdout lines of aim_tpu/api.py:902-905, after the phase lines,
    each only when its count is nonzero: K2 flags most pairs at 10 %
    errors, the streamed tier's two planes certify some, the oracle takes
    the rest; with the ladder off (AIM_TPU_RETRY_PLANES="") the oracle
    takes every flagged pair."""
    from aim_tpu_torch import datagen
    if planes is not None:
        monkeypatch.setenv("AIM_TPU_RETRY_PLANES", planes)
    n = 256
    src = str(tmp_path / "pairs")
    datagen.write_pair_file(src, n, 100, 0.1, seed=3)
    cfg = _cfg(["nw", "-i", src, "-o", "unused", "-l", "100", "-e", "0.01",
                "-n", str(n), "-b"])
    got, ref = str(tmp_path / "port"), str(tmp_path / "oracle")
    res = tapi.align_file(src, got, n, cfg, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[:5] == [lines[0]] + [f"{k}: {v * 1e3:f} ms" for k, v in (
        ("CPU-GPU", res.t_load), ("GPU Kernel", res.t_kernel),
        ("GPU-CPU", res.t_retrieve))] + [lines[4]]
    assert lines[4].startswith("pairs/s (device phases)")
    counts = [f"wide-band device retry pairs: {res.n_retry}"] * bool(
        res.n_retry) + [f"host-oracle fallback pairs: {res.n_fallback}"]
    assert lines[5:] == counts
    assert res.n_fallback > 0 and (res.n_retry > 0) == (planes is None)
    osc = _oracle_file(ref, cfg, n, src)
    np.testing.assert_array_equal(res.scores, osc)
    assert open(got, "rb").read() == open(ref, "rb").read()


def test_cli_requires_cuda(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o"
    rc = tcli.main(["wfa", "-i", SAMPLE, "-o", str(out), "-l", "100", "-e",
                    "0.01", "-n", "100", "-b", "-r"])
    assert rc == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("argv,tier", [
    # NW past the streamed tier's 16352: the dense tier (id kept from when
    # the NW short-read tier itself was unported)
    pytest.param(["nw", "-l", "20000", "-e", "0.01", "--variant", "hbm"],
                 "dense", id="argv0-ROADMAP Queue 1 item 3"),
    # GenASM past the long tier's k <= 508: the host tier (id kept from when
    # the GenASM short-read tier itself was unported)
    pytest.param(["genasm", "-l", "2000", "-e", "0.3"], "host",
                 id="argv1-ROADMAP Queue 1 item 4"),
    # WFA past the long-read tier's smax 1023: the dense tier (id kept from
    # when the long-read tier itself was unported)
    pytest.param(["wfa", "-l", "10000", "-e", "0.021", "--variant", "hbm"],
                 "dense", id="argv2-ROADMAP Queue 1 item 6"),
    pytest.param(["wfa", "-l", "100", "-e", "0.01", "--backend", "xla"],
                 "dense", id="argv3-ROADMAP Queue 1 item 5"),
    pytest.param(["wfa", "-l", "100", "-e", "0.01", "--energy"], "K1",
                 id="argv4-ROADMAP Queue 1 item 10"),
    pytest.param(["wfa", "-l", "100", "-e", "0.01", "--profile", "p"], "K1",
                 id="argv5-ROADMAP Queue 1 item 10"),
    # a negative match cost voids K3's band argument: the dense tier
    pytest.param(["swg", "-l", "100", "-e", "0.01", "-m", "-1"], "dense",
                 id="argv6-ROADMAP Queue 1 item 5"),
])
def test_cli_rejects_unported(tmp_path, monkeypatch, capsys, argv, tier):
    """The configs and flags the CLI once refused (exit 2) now pass its
    dispatch: without a GPU the run stops only at the CUDA check (rc 1),
    and the config's tier is the exact one wherever no kernel admits it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = argv[:1] + ["-i", SAMPLE, "-o", str(tmp_path / "o"), "-n", "100",
                       "-b"] + argv[1:]
    assert tcli.main(argv) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    cfg = tcli.config_from_args(tcli.build_parser().parse_args(argv))
    assert kernels.forward_fn(cfg).name == tier
    assert not (tmp_path / "o").exists()


def test_cli_reference_messages(capsys):
    assert tcli.main(["wfa", "-i", SAMPLE, "-l", "0", "-e", "0.01",
                      "-n", "5"]) == -1
    assert "Undefined input read length" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tcli.main(["wfa", "-i", SAMPLE, "-l", "100", "-e", "0.01", "-n",
                   "4", "-x", "0"])


@pytest.mark.parametrize("cfg", [
    # past the streamed tier's 16352
    derive_config("nw", 20000, 0.01, backtrace=True, variant="hbm"),
    derive_config("swg", 100, 0.01, match=-1, backtrace=True),
    # id kept from when 1 kbp WFA was unported: now past smax 1023
    derive_config("wfa", 10000, 0.021, backtrace=True, adaptive=True,
                  variant="hbm"),
    # K1's gate rejects it and K5 takes it: past the GenASM long tier's
    # k <= 508 instead
    AlignConfig(algo="genasm", read_size=112, max_score=509),
], ids=["nw", "swg", "wfa_l1000", "wfa_smax80"])
def test_unported_config_raises(cfg):
    """The configs that once raised NotImplementedError: the exact tier
    serves them (dense; GenASM's host tier), as JAX's Pallas dispatch
    returns none for them.  Short reads run here on a few sample pairs and
    equal the oracle; NW at 20 kbp, a 20k-row Python loop on the CPU, runs
    on the card (chip_smoke.py)."""
    from aim_tpu.ops import pallas_kernels
    assert pallas_kernels.forward_fn(cfg) is None
    tier = kernels.forward_fn(cfg)
    assert tier.name == ("host" if cfg.algo == "genasm" else "dense")
    assert tier.retry is None
    if cfg.read_size > 16352:
        return
    n = 4 if cfg.read_size > 1000 else 8
    p, t, pl, tl = nat.parse_pairs(SAMPLE, n, cfg.read_size)
    res = tapi.align(p, t, pl, tl, cfg, device="cpu")
    if cfg.algo == "wfa":
        osc = nat.wfa_align(p, t, pl, tl, mismatch=cfg.mismatch,
                            gap_o=cfg.gap_o, gap_e=cfg.gap_e,
                            max_score=cfg.max_score, adaptive=cfg.adaptive,
                            backtrace=False)[0]
    else:
        osc = tapi._oracle_align(p, t, pl, tl, cfg)[0]
    np.testing.assert_array_equal(res.scores, osc)


def _forbidden(mod: str) -> bool:
    """jax, any module of the JAX package (aim_tpu, aim_tpu.*), which the
    port keeps its own copies of, and the JAX side's tools/ (the port's are
    aim_tpu_torch.tools)."""
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "aim_tpu", "tools")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            for a in node.names:
                yield f"{node.module}.{a.name}"


PORT_FILES = [os.path.join(r, f)
              for r, _, fs in os.walk(os.path.join(REPO, "aim_tpu_torch"))
              for f in fs if f.endswith(".py")]


def test_port_has_no_jax_imports_ast():
    files = PORT_FILES + [os.path.join(REPO, f) for f in (
        "chip_smoke.py", "tests/test_torch_gpu.py", "tests/torch_cases.py")]
    assert len(files) >= 16
    for sub in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/runner.py", "tools/dryrun_multichip.py",
                "tools/scaling.py", "tools/bench.py"):
        assert os.path.join(REPO, "aim_tpu_torch", sub) in files, sub
    for path in files:
        for mod in _imports(path):
            assert not _forbidden(mod), (path, mod)
    assert not _forbidden("aim_tpu_torch.native") and _forbidden("aim_tpu")
    assert _forbidden("aim_tpu.native") and _forbidden("jax.numpy")
    assert _forbidden("tools.fuzz_kernels")
    assert not _forbidden("aim_tpu_torch.tools.fuzz_kernels")


def test_port_import_loads_no_jax():
    mods = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
        .removesuffix(".__init__") for p in PORT_FILES)
    assert {"aim_tpu_torch.ops.nwswg_long", "aim_tpu_torch.ops.probes",
            "aim_tpu_torch.tools.fuzz_kernels", "aim_tpu_torch.parallel",
            "aim_tpu_torch.parallel.mesh", "aim_tpu_torch.parallel.runner",
            "aim_tpu_torch.tools.dryrun_multichip",
            "aim_tpu_torch.tools.scaling",
            "aim_tpu_torch.tools.bench"} <= set(mods)
    code = ("import sys; pre = [m for m in sys.modules if m.split('.')[0] "
            "in ('jax', 'jaxlib', 'aim_tpu', 'tools')]\n"
            f"import importlib\nfor m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'aim_tpu', 'tools')]\n"
            "print('PRELOADED' if pre else 'BAD' if bad else 'CLEAN', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    if r.stdout.startswith("PRELOADED"):
        pytest.skip("this interpreter imports jax at startup")
    assert r.stdout.startswith("CLEAN"), r.stdout
