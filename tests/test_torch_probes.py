"""The plain versions of the CUDA probes (aim_tpu_torch/ops/probes.py, M1
and M2) against the TPU probes of tools/microbench_mosaic.py, run in
interpret mode (``pl.pallas_call`` patched with ``interpret=True`` inside
the test; nothing in tools/ changes).  Inputs and outputs must be
byte-equal at 3 and 17 reps (tolerance: exact, they are integers).  The
CUDA kernels themselves are held to these plain versions under the CPU
warp shim (tests/test_torch_csrc_shim.py) and on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import functools

import numpy as np
import pytest
import torch

from aim_tpu_torch.ops import probes


@pytest.fixture
def mosaic(monkeypatch):
    import tools.microbench_mosaic as mm
    monkeypatch.setattr(mm.pl, "pallas_call",
                        functools.partial(mm.pl.pallas_call, interpret=True))
    return mm


@pytest.mark.parametrize("reps", [3, 17])
@pytest.mark.parametrize("name", list(probes.PROBES))
def test_plain_probe_matches_pallas_probe(mosaic, name, reps):
    pr = probes.PROBES[name]
    fn, args = mosaic.PROBES[pr.tpu_name](reps)
    ins = probes.inputs(name)
    assert len(ins) == len(args)
    for a, b in zip(args, ins):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    want = np.asarray(fn(*args))
    probes.reset_launch_count()
    got = probes.run(name, reps, *ins)
    assert sum(probes.launch_counts.values()) == 0   # CPU: the plain version
    assert got.dtype == pr.dtype and tuple(got.shape) == pr.out_shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_probes_are_the_reference_probes():
    """One probe a TPU probe: the twelve M1 bodies and M2, in csrc order."""
    import tools.microbench_mosaic as mm
    assert sorted(p.tpu_name for p in probes.PROBES.values()) == \
        sorted(mm.PROBES)
    assert [p.index for p in probes.PROBES.values()] == list(range(13))
    assert [p.tpu_id for p in probes.PROBES.values()].count("M2") == 1


@pytest.mark.parametrize("bad", ["shape", "dtype", "devices", "reps"])
def test_probe_wrapper_rejects_bad_inputs(bad):
    args = list(probes.inputs("gather_lanes"))
    reps = 3
    if bad == "shape":
        args[0] = args[0][:8].contiguous()
    elif bad == "dtype":
        args[1] = args[1].long()
    elif bad == "devices":
        args[1] = args[1].to("meta")
    else:
        reps = -1
    with pytest.raises(ValueError):
        probes.run("gather_lanes", reps, *args)


def test_probe_bound_counts_operations():
    from aim_tpu_torch.tools import microbench
    ns = microbench.bound_ns_per_rep("i32_min_128x128")
    assert ns == pytest.approx(128 * 128 * 4 / microbench.INT32_OPS_S * 1e9)
    assert microbench.bound_ns_per_rep("onehot_reduce_rp") < ns
    with pytest.raises(ValueError):
        microbench.measure("popcount", torch.device("cpu"))
