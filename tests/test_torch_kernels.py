"""The port's dispatch (aim_tpu_torch/ops/kernels.py) against the JAX
package's (aim_tpu/ops/pallas_kernels.py).

Over a grid of configs -- every algorithm, 100 bp to 16 kbp, batches that
2-bit pack and batches that do not -- the port serves a config with the
kernel that ports the one JAX picks, and raises NotImplementedError naming
the ROADMAP item of every tier it has not ported yet.  Tolerance: exact.
"""

import re

import pytest

from aim_tpu.config import AlignConfig, derive_config
from aim_tpu.ops import pallas_kernels
from aim_tpu_torch.ops import genasm, kernels, nw, swg, wfa2, wfa_long

# the JAX function a tier's closure calls -> the port's kernel, or the
# ROADMAP item that will port it
JAX_TIERS = {
    "wfa_forward_pallas2": "K1",
    "wfa_forward_pallas_long": "K5",
    "wfa_forward_pallas_long_bytes": "K5",
    "genasm_forward_pallas": "K4",
    "genasm_forward_pallas_long": "item 7",
    "nw_forward_pallas": "K2",
    "swg_forward_pallas": "K3",
    "nwswg_forward_pallas_long": "item 7",
}
PORT_KERNELS = {wfa2.wfa_forward2: "K1", nw.nw_forward: "K2",
                swg.swg_forward: "K3", genasm.genasm_forward: "K4",
                wfa_long.wfa_forward_long: "K5"}
LENGTHS = (100, 150, 250, 500, 1000, 2000, 5000, 10000, 16000)
ERRORS = (0.005, 0.01, 0.02, 0.05)


def jax_tier(cfg, packed_ok):
    fn = pallas_kernels.forward_fn(cfg, packed_ok=packed_ok)
    if fn is None:
        return "item 5"  # the exact XLA / host tier
    names = [n for n in fn.__code__.co_freevars + fn.__code__.co_names
             if n in JAX_TIERS]
    assert len(names) == 1, names
    return JAX_TIERS[names[0]]


def port_tier(cfg, packed_ok):
    try:
        tier = kernels.forward_fn(cfg, packed_ok=packed_ok)
    except NotImplementedError as e:
        items = re.findall(r"ROADMAP Queue 1 (item \d+)", str(e))
        assert len(items) == 1, str(e)
        return items[0]
    return PORT_KERNELS[tier.forward]


def grid(algo):
    for length in LENGTHS:
        for err in ERRORS:
            for variant in ("vmem", "hbm"):
                kw = dict(backtrace=True, variant=variant)
                if algo == "wfa":
                    kw["adaptive"] = True
                yield derive_config(algo, length, err, **kw)


EDGES = {
    "wfa": [derive_config("wfa", 10000, 0.01, variant="hbm").replace(
        max_score=s) for s in (1023, 1024)]
    + [AlignConfig(algo="wfa", read_size=112, max_score=s)
       for s in (79, 80)],
    "genasm": [derive_config("genasm", 100, 0.01).replace(max_score=k)
               for k in (26, 27, 508, 509)]
    + [AlignConfig(algo="genasm", read_size=R, max_score=0)
       for R in (792, 800, 16352, 16360)],
    "nw": [AlignConfig(algo="nw", read_size=R, max_score=60)
           for R in (1120, 2048, 16352, 16360)],
    "swg": [derive_config("swg", 100, 0.01, match=-1),
            derive_config("swg", 100, 0.01).replace(max_score=9)],
}


@pytest.mark.parametrize("algo", ["wfa", "genasm", "nw", "swg"])
def test_forward_fn_routes_as_reference(algo):
    seen = set()
    for cfg in list(grid(algo)) + EDGES[algo]:
        for packed_ok in (True, False):
            want = jax_tier(cfg, packed_ok)
            assert port_tier(cfg, packed_ok) == want, (cfg, packed_ok)
            seen.add(want)
    # the grid reaches every tier of the family
    expect = {"wfa": {"K1", "K5", "item 5"},
              "genasm": {"K4", "item 7", "item 5"},
              "nw": {"K2", "item 7", "item 5"},
              "swg": {"K3", "item 7", "item 5"}}[algo]
    assert seen == expect, seen


def test_tier_record_grammar_and_bytes():
    main = derive_config("genasm", 100, 0.01, backtrace=True)
    tier = kernels.forward_fn(main)
    assert tier.records == kernels.GENASM_RECORDS
    assert tier.device_bytes_per_pair == genasm.device_bytes_per_pair(main)
    long_ = derive_config("wfa", 10000, 0.01, backtrace=True, adaptive=True,
                          variant="hbm")
    tier = kernels.forward_fn(long_, packed_ok=False)
    assert tier.forward is wfa_long.wfa_forward_long
    assert tier.records == kernels.STEP_RECORDS
    assert tier.device_bytes_per_pair > wfa_long.hist_bytes_per_pair(long_)
    # the long-tier history caps a chunk far below batch_pairs
    assert (40 << 30) // tier.device_bytes_per_pair < long_.batch_pairs
