"""The port's fuzz harness (aim_tpu_torch/tools/fuzz_kernels.py) against
tools/fuzz_kernels.py: its CONFIGS (all 31 rows) and its copies of
tests/util.py's random_pairs and pack equal the reference's; a few small
rows through the port on the CPU give 0 bad pairs against the oracle; and
each row's tier is the one JAX's routing picks for the same batch."""

import functools

import numpy as np
import pytest

import tools.fuzz_kernels as jfuzz
from aim_tpu.ops.common import pack_seqs as jpack_seqs
from aim_tpu_torch.tools import fuzz_kernels as F
from test_torch_kernels import jax_tier
from util import pack, random_pairs


def test_configs_and_generators_equal_the_reference():
    assert F.CONFIGS == jfuzz.CONFIGS
    assert len(F.CONFIGS) == 31
    for seed, n, L, bal, alpha in ((101, 64, 40, False, "ACGT"),
                                   (7, 50, 88, True, "ACGTN")):
        got = F.random_pairs(seed=seed, n=n, max_len=L, balanced=bal,
                             alphabet=alpha)
        assert got == random_pairs(seed=seed, n=n, max_len=L, balanced=bal,
                                   alphabet=alpha)
        for a, b in zip(F.pack(got, L + 8), pack(got, L + 8)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("row", range(31))
def test_row_tier_is_the_reference_routing(row):
    cfg, (p, t, pl, tl) = F.row_batch(F.CONFIGS[row], 101)
    packed = jpack_seqs(p, t, pl, tl, cfg.read_size)[2]
    assert F.tier_of(cfg, p, t, pl, tl) == jax_tier(cfg, packed)[0]


# a K1, a K2, a K4 and the dense SWG rows, cut to 96 pairs
@pytest.mark.parametrize("row", [0, 3, 5, 6, 14, 26])
def test_small_rows_on_cpu_have_no_bad_pairs(row):
    cut = F.CONFIGS[row][:4] + (96,) + F.CONFIGS[row][5:]
    bad, rep = F.run_one(cut, 101, device="cpu")
    assert bad == 0 and rep["pairs"] == 96, rep
    if row in (3, 5, 26):
        assert rep["tier"] == "dense" and rep["fallback"] > 0


def test_main_prints_total_bad(capsys, monkeypatch):
    monkeypatch.setattr(F, "CONFIGS", [F.CONFIGS[14][:4] + (32,)])
    monkeypatch.setattr(F, "fuzz", functools.partial(F.fuzz, device="cpu"))
    assert F.main(["101", "1"]) == 0
    out = capsys.readouterr().out
    assert "tier=K4" in out and out.strip().endswith("TOTAL BAD: 0")
