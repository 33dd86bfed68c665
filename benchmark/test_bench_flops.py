"""The FLOPs that ``mfu_pct`` and ``step_mfu_pct`` count, at the published
sizes, on the meta device (CPU, ~8 s)."""
from __future__ import annotations

import pytest

from benchmark import flops
from benchmark.augdepth_probe import augdepth
from benchmark.run import ROOT, load_json


def _config(name: str) -> dict:
    return load_json(ROOT / "benchmark" / "configs" / f"{name}.json")


@pytest.mark.parametrize("name,batch,train,total,conv", [
    # the counts of the harness as it first counted them
    ("vfdepth_ddad_fusion", 2, True, 5280686190164.0, 5145950244864.0),
    ("vfdepth_ddad_fusion", 1, False, 892652605486.0, 869218924544.0),
    ("vfdepth_ddad_fsm", 2, True, 2492035957176.0, 2490054082560.0),
])
def test_the_cells_counts_stay(name, batch, train, total, conv):
    assert flops.count(_config(name), batch, train) == {"total": total,
                                                        "conv": conv}


def test_depth_synthesis_counts_the_second_decode():
    cfg = _config("vfdepth_ddad_fusion")
    base = flops.count(cfg, 2, True)
    aug = flops.count(augdepth(cfg), 2, True)
    # The second decode's convolutions, over b x cams = 12 images, each
    # 2 * 12 * cout * h * w * cin * k * k a forward:
    #   reduce_dim_0  50 bins x 64 -> 256, 3x3 at 48x80   679,477,248,000
    #   reduce_dim_1  256 -> 128, 3x3 at 48x80             27,179,089,920
    #   upconv_2_0    128 -> 64 at 48x80                    6,794,772,480
    #   upconv_2_1    64 -> 64 at 96x160                   13,589,544,960
    #   upconv_1_0    64 -> 32 at 96x160                    6,794,772,480
    #   upconv_1_1    32 -> 32 at 192x320                  13,589,544,960
    #   upconv_0_0    32 -> 16 at 192x320                   6,794,772,480
    #   upconv_0_1    16 -> 16 at 384x640                  13,589,544,960
    #   dispconv_0    16 -> 1 at 384x640                      849,346,560
    # = 768,658,636,800 forward. The backward takes each conv's input
    # gradient (the frustum sample's volume trains) and its weight
    # gradient, twice the forward: three times it in all.
    convs = [(3200, 256, 48, 80), (256, 128, 48, 80), (128, 64, 48, 80),
             (64, 64, 96, 160), (64, 32, 96, 160), (32, 32, 192, 320),
             (32, 16, 192, 320), (16, 16, 384, 640), (16, 1, 384, 640)]
    forward = sum(2 * 12 * cout * h * w * cin * 9
                  for cin, cout, h, w in convs)
    assert forward == 768_658_636_800
    assert aug["conv"] - base["conv"] == 3 * forward
    # the rest (the frustum's and the warps' projections, the depth's
    # resize) is small beside it
    rest = (aug["total"] - base["total"]) - 3 * forward
    assert 0 < rest < 0.01 * forward
