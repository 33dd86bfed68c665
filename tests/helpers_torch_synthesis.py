"""The tiny depth-synthesis config and JAX's rotated-view draw, shared by
the port's depth-synthesis tests (``tests/test_torch_synthesis_*.py``)."""
import numpy as np
import jax

from vfdepth_tpu import presets as jax_presets
from vfdepth_tpu_torch import presets

# a pose-head bias of 0.4-0.6 m (helpers_torch_step.with_motion): ~2 px of
# parallax at the ~16 m depths of aug_configs; the helper's default 0.02-0.03
# m moves a pixel by ~0.1 px, the temporal warps stay near the identity, and
# the 7 auto-mask pixels that tie differently on the two sides move the depth
# net's gradients by 1.7e-2 (1.0e-3 with this motion; 2.1e-5 at the default
# with the auto-mask pinned, test_torch_synthesis_model.py's pinned step)
MOTION = (40.0, 20.0, 60.0)


def aug_configs(**over):
    """``presets.tiny_config(aug_depth=True)`` for (JAX, the port), with
    ``focal_length_scale`` 10 (metric depths ~15-25 m, inside [min_depth,
    max_depth], so the consistency loss sees real pixels) and
    ``tpu.warp_window`` off on both sides (the synthesis tests hold dense
    warps; tests/test_torch_warp_window.py holds the windows)."""
    cfgs = (jax_presets.tiny_config(aug_depth=True, **over),
            presets.tiny_config(aug_depth=True, **over))
    for cfg in cfgs:
        cfg.set("focal_length_scale", 10)
        cfg.set("warp_window", False)
    return cfgs


def jax_aug_draw(rng, b, cams):
    """The rotated views' draw of JAX ``forward`` on key ``rng``:
    ``uniform(split(rng)[1], (b, cams, 3))`` (in a train step ``rng`` is
    first folded with the step)."""
    return np.array(jax.random.uniform(jax.random.split(rng)[1],
                                       (b, cams, 3)))
