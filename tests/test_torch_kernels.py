"""The port's dispatch (aim_tpu_torch/ops/kernels.py) against the JAX
package's (aim_tpu/ops/pallas_kernels.py).

Over a grid of configs -- every algorithm, 100 bp to 16 kbp, batches that
2-bit pack and batches that do not -- the port serves a config with the
kernel that ports the one JAX picks, with the same band-retry ladder
(whether the tier has one, which, and its primary plane count), and
exactly where JAX's Pallas dispatch returns none with the exact tier JAX
falls back to: the dense tier (JAX's XLA tier) or, for GenASM, the host
tier.  Under backend="xla" every config takes the exact tier.  Tolerance:
exact.
"""

import pytest

from aim_tpu.config import AlignConfig, derive_config
from aim_tpu.ops import pallas_kernels
from aim_tpu_torch.ops import (genasm, genasm_long, kernels, nw, nw_xla,
                               nwswg_long, swg, swg_xla, wfa2, wfa_long,
                               wfa_xla)

# the JAX function a tier's closure calls -> the port's kernel
JAX_TIERS = {
    "wfa_forward_pallas2": "K1",
    "wfa_forward_pallas_long": "K5",
    "wfa_forward_pallas_long_bytes": "K5",
    "genasm_forward_pallas": "K4",
    "genasm_forward_pallas_long": "K6",
    "nw_forward_pallas": "K2",
    "swg_forward_pallas": "K3",
    "nwswg_forward_pallas_long": "K6",
}
PORT_KERNELS = {wfa2.wfa_forward2: "K1", nw.nw_forward: "K2",
                swg.swg_forward: "K3", genasm.genasm_forward: "K4",
                wfa_long.wfa_forward_long: "K5",
                nwswg_long.nwswg_forward_long: "K6",
                genasm_long.genasm_forward_long: "K6"}
# the JAX wide-band retry a tier carries -> the port's
RETRIES = {"_nwswg_wide_retry": nwswg_long.nwswg_forward_long,
           "genasm_retry": genasm_long.genasm_forward_long}
LENGTHS = (100, 150, 250, 500, 1000, 2000, 5000, 10000, 16000)
ERRORS = (0.005, 0.01, 0.02, 0.05)


def jax_tier(cfg, packed_ok):
    """(kernel or ROADMAP item, retry, primary planes) of JAX's tier."""
    fn = pallas_kernels.forward_fn(cfg, packed_ok=packed_ok)
    if fn is None:
        # JAX's exact XLA tier, or GenASM's host tier (aim_tpu/api.py:146-157)
        return ("host" if cfg.algo == "genasm" else "dense"), None, None
    names = [n for n in fn.__code__.co_freevars + fn.__code__.co_names
             if n in JAX_TIERS]
    assert len(names) == 1, names
    retry = getattr(fn, "retry_fn", None)
    return (JAX_TIERS[names[0]],
            RETRIES[retry.__name__] if retry is not None else None,
            getattr(fn, "primary_planes", 1))


EXACT = {"dense": (nw_xla.nw_forward, swg_xla.swg_forward,
                   wfa_xla.wfa_forward), "host": (None,)}


def port_tier(cfg, packed_ok):
    tier = kernels.forward_fn(cfg, packed_ok=packed_ok)
    if tier.name in EXACT:
        assert tier.forward in EXACT[tier.name], tier
        assert tier.retry is None and tier.records in (
            kernels.DENSE_RECORDS + (kernels.HOST,))
        return tier.name, None, None
    fwd = getattr(tier.forward, "func", tier.forward)
    if fwd is not tier.forward:  # the streamed tier at its routed planes
        assert tier.forward.keywords == {"planes": tier.primary_planes}
    assert tier.name == PORT_KERNELS[fwd]
    return PORT_KERNELS[fwd], tier.retry, tier.primary_planes


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
    seen, retried = set(), set()
    for cfg in list(grid(algo)) + EDGES[algo]:
        for packed_ok in (True, False):
            want = jax_tier(cfg, packed_ok)
            assert port_tier(cfg, packed_ok) == want, (cfg, packed_ok)
            seen.add(want[0])
            retried.add((want[0], want[1] is not None, want[2]))
    # the grid reaches every tier of the family, with and without a ladder
    expect = {"wfa": {"K1", "K5", "dense"},
              "genasm": {"K4", "K6", "host"},
              "nw": {"K2", "K6", "dense"},
              "swg": {"K3", "K6", "dense"}}[algo]
    assert seen == expect, seen
    if algo in ("nw", "swg"):
        assert {("K6", True, 1), ("K6", True, 2)} <= retried, retried
        assert (("K2" if algo == "nw" else "K3"), True, 1) in retried
    if algo == "swg":
        assert ("K3", False, 1) in retried  # int8 cells: no ladder
    if algo == "genasm":
        assert {("K6", True, 1), ("K6", True, 2), ("K4", False, 1)} \
            <= retried, retried


@pytest.mark.parametrize("algo", ["wfa", "genasm", "nw", "swg"])
def test_backend_xla_takes_the_exact_tier(algo):
    """--backend xla: every config of the grid on the exact tier, whatever
    kernel admits it (JAX's api.py:80-157 skips the Pallas dispatch)."""
    for cfg in list(grid(algo)) + EDGES[algo]:
        for packed_ok in (True, False):
            tier = kernels.forward_fn(cfg.replace(backend="xla"), packed_ok)
            assert tier.name == ("host" if algo == "genasm" else "dense")
            assert tier.records == {"wfa": kernels.DENSE_WFA,
                                    "nw": kernels.DENSE_NW,
                                    "swg": kernels.DENSE_SWG,
                                    "genasm": kernels.HOST}[algo]


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
    assert tier.retry is None and tier.retry_bytes_per_pair is None
    # the ladder's footprint is its retry tier's at each plane count
    for cfg in (derive_config("nw", 100, 0.01, backtrace=True),
                derive_config("swg", 4096, 0.01, backtrace=True,
                              variant="hbm")):
        tier = kernels.forward_fn(cfg)
        for planes in (2, 4, 8):
            assert tier.retry_bytes_per_pair(planes) == \
                nwswg_long.device_bytes_per_pair(cfg, planes)
    g = derive_config("genasm", 4096, 0.01, backtrace=True)
    tier = kernels.forward_fn(g)
    assert tier.retry_bytes_per_pair(4) == genasm_long.bytes_per_pair(g, 4)
