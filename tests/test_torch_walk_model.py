"""The scalar model of K7's walk (aim_tpu_torch/tools/walk_model.py) gives
the plain version's records (exact: integer records), window kept across
rounds or not, so its round and byte counts are those of a walk that is
right."""

import numpy as np
import pytest

from aim_tpu_torch.ops import common, nwswg_long
from aim_tpu_torch.tools import walk_model
from torch_cases import nwswg_long_case


@pytest.mark.parametrize("keep_window", [True, False],
                         ids=["kept", "reloaded"])
@pytest.mark.parametrize("name", ["nw_multiblock", "swg_multiblock",
                                  "k7_bounds_nw_p1", "k7_bounds_swg_p2"])
def test_walk_model_matches_plain_version(name, keep_window):
    cfg, p, t, pl, tl, planes = nwswg_long_case(name)
    args = common.to_device_batch(p, t, pl, tl, "cpu")
    meta, codes, ism = nwswg_long.nwswg_long_fwd_reference(
        *args, cfg=cfg, planes=planes)
    stats = {}
    want = nwswg_long.nwswg_long_walk_reference(
        codes, ism, meta, args[2], args[3], cfg=cfg, planes=planes,
        stats=stats)
    rec, counts = walk_model.walk_batch(meta, codes, ism, pl, tl, cfg,
                                        planes, keep_window=keep_window)
    np.testing.assert_array_equal(rec, want.numpy())
    # a round is a step that reads the code row, or a window reload
    # after an NW D-run; pieces are the other steps
    assert counts["pieces"] <= stats["steps"] <= \
        counts["rounds"] + counts["pieces"]
