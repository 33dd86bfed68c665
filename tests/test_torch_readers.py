"""The port's DDAD and nuScenes readers against the JAX package's, bit for
bit, on the CPU.

Both packages read the same on-disk fixtures (the DGP scene and the
nuScenes tables that tests/test_dataset_readers.py writes, every case of
it: plain, with depth, camelCase protos, a structured point cloud with a
frame missing its LiDAR sweep, a val sample without a previous frame), in
train mode (colour jitter on) and in val mode (off), over two epochs
(``set_epoch``), and the repository's own self-occlusion masks
(``assets/ddad_mask``, ``assets/nuscenes_mask``). Every array of every
sample must be equal: the readers are copies, the native resize is built
from the same source with the same flags, and the jitter draws from the
same seeds. Depth caches are off (``cache_depth=False``), so neither
package reads a file the other wrote. JAX's resize runs from the library
``helpers_jax_native`` builds (its in-place build races under ``-n 6``);
each test first asserts that JAX's loader has it.
"""
from pathlib import Path

import numpy as np
import pytest

from test_dataset_readers import CAMS, _make_ddad, _make_nuscenes
from vfdepth_tpu.data import factory as jfactory
from vfdepth_tpu.data.ddad import DDADDataset as JaxDDAD
from vfdepth_tpu.data.nuscenes import NuScenesDataset as JaxNuScenes
from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.data import DDADDataset, NuScenesDataset
from vfdepth_tpu_torch.data.factory import construct_dataset
from helpers_jax_native import jax_native  # noqa: F401
from helpers_torch_threads import port_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_native")

ROOT = Path(__file__).resolve().parent.parent
JITTER = (0.2, 0.2, 0.2, 0.05)
SIZE = dict(height=32, width=64, fusion_level=2)


def _equal_samples(port, ref, epochs=(0, 1)):
    """Every sample of both readers, array for array, over ``epochs``."""
    assert len(port) == len(ref) > 0
    for epoch in epochs:
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            got, want = port[i], ref[i]
            assert set(got) == set(want)
            for key, w in want.items():
                g = got[key]
                assert g.dtype == w.dtype and g.shape == w.shape, key
                np.testing.assert_array_equal(g, w, err_msg=f"{i} {key}")


def _pair(cls_port, cls_ref, *args, **kwargs):
    return cls_port(*args, **kwargs), cls_ref(*args, **kwargs)


DDAD_CASES = {
    "plain": (dict(), dict()),
    "depth": (dict(), dict(with_depth=True)),
    "camel": (dict(camel=True), dict(with_depth=True)),
    "structured_missing_lidar": (dict(structured_pc=True, missing_lidar_t=2),
                                 dict(with_depth=True)),
    "masks": (dict(), dict(mask_dir=str(ROOT / "assets" / "ddad_mask"))),
}


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("case", sorted(DDAD_CASES))
def test_ddad_reader_matches_jax(tmp_path, case, mode):
    fixture, extra = DDAD_CASES[case]
    ds_json = _make_ddad(str(tmp_path), **fixture)
    port, ref = _pair(DDADDataset, JaxDDAD, ds_json, cameras=CAMS,
                      split=mode, jitter=JITTER if mode == "train" else
                      (0.0,) * 4, cache_depth=False, **SIZE, **extra)
    _equal_samples(port, ref)
    if case == "masks":      # the repository's masks, not the ones fallback
        assert 0 < port[0]["mask"].mean() < 1
    if case == "structured_missing_lidar" and mode == "val":
        assert (port[1]["depth"] == 0).all() and (port[0]["depth"] > 0).any()
    for (k, e), (kr, er) in zip(port.rig_calibrations(),
                                ref.rig_calibrations()):
        np.testing.assert_array_equal(k, kr)
        np.testing.assert_array_equal(e, er)


def test_ddad_depth_cache_round_trip(tmp_path):
    """With the cache on, the port writes each camera's depth beside the
    point cloud and reads it back equal to JAX's depth made without a
    cache."""
    ds_json = _make_ddad(str(tmp_path))
    port = DDADDataset(ds_json, cameras=CAMS, split="val", with_depth=True,
                       **SIZE)
    first = port[0]["depth"]
    caches = sorted(tmp_path.rglob("*_depth.npz"))
    assert len(caches) == len(CAMS)
    np.testing.assert_array_equal(port[0]["depth"], first)
    ref = JaxDDAD(ds_json, cameras=CAMS, split="val", with_depth=True,
                  cache_depth=False, **SIZE)
    np.testing.assert_array_equal(ref[0]["depth"], first)


NUSC_CASES = {
    "plain": (dict(), dict()),
    "depth": (dict(), dict(with_depth=True)),
    "no_prev": (dict(no_prev_t=0), dict(with_depth=True)),
    "masks": (dict(), dict(mask_dir="masks")),
}


def _nuscenes_masks(tmp_path):
    """The repository's nuScenes masks for the fixture's two cameras; its
    front cameras have no self-occlusion, so CAM_FRONT takes CAM_BACK's
    mask (the one with an occluded region) to tell a mask read from the
    ones fallback."""
    src, dst = ROOT / "assets" / "nuscenes_mask", tmp_path / "masks"
    dst.mkdir()
    for cam, name in (("CAM_FRONT", "CAM_BACK"),
                      ("CAM_FRONT_LEFT", "CAM_FRONT_LEFT")):
        (dst / f"{cam}_mask.png").write_bytes(
            (src / f"{name}_mask.png").read_bytes())
    return str(dst)


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("case", sorted(NUSC_CASES))
def test_nuscenes_reader_matches_jax(tmp_path, case, mode):
    fixture, extra = NUSC_CASES[case]
    if case == "masks":
        extra = dict(mask_dir=_nuscenes_masks(tmp_path))
    root, cams = _make_nuscenes(str(tmp_path), **fixture)
    port, ref = _pair(NuScenesDataset, JaxNuScenes, root, cameras=cams,
                      split=mode, jitter=JITTER if mode == "train" else
                      (0.0,) * 4, cache_depth=False, **SIZE, **extra)
    _equal_samples(port, ref)
    if case == "no_prev":
        assert len(port) == (2 if mode == "train" else 3)
        if mode == "val":
            np.testing.assert_array_equal(port[0]["color/-1/0"],
                                          port[0]["color/0/0"])
    if case == "masks":
        assert 0 < port[0]["mask"].mean() < 1
    for (k, e), (kr, er) in zip(port.rig_calibrations(),
                                ref.rig_calibrations()):
        np.testing.assert_array_equal(k, kr)
        np.testing.assert_array_equal(e, er)


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("dataset", ["ddad", "nuscenes"])
def test_construct_dataset_builds_the_readers_as_jax(tmp_path, dataset,
                                                     mode):
    """``construct_dataset`` gives the port's reader the JAX factory's
    arguments: split, jitter in train mode only, depth outside train mode,
    ``mask_dir``, ``depth_type``, and the nuScenes split file from
    ``split_dir``; the two readers then give equal samples."""
    cfg = presets.tiny_config()
    cfg.set("dataset", dataset)
    cfg.set("height", 32)
    cfg.set("width", 64)
    if dataset == "ddad":
        cfg.set("data_path", _make_ddad(str(tmp_path)))
        cfg.set("cameras", CAMS)
        cfg.set("mask_dir", str(ROOT / "assets" / "ddad_mask"))
        cfg.set("depth_type", "lidar")
    else:
        root, cams = _make_nuscenes(str(tmp_path / "data"))
        split_dir = tmp_path / "splits"
        split_dir.mkdir()
        (split_dir / f"{mode}.txt").write_text("sample_2\nsample_1\n")
        cfg.set("data_path", root)
        cfg.set("cameras", cams)
        cfg.set("split_dir", str(split_dir))
    cfg.set("num_cams", len(cfg.cameras))
    port, ref = construct_dataset(cfg, mode), jfactory.construct_dataset(
        cfg, mode)
    cls = DDADDataset if dataset == "ddad" else NuScenesDataset
    assert type(port) is cls and type(ref).__name__ == cls.__name__
    for attr in ("cameras", "jitter", "with_depth", "mask_dir", "height",
                 "width", "frame_ids", "fusion_level", "index"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.jitter == (JITTER if mode == "train" else (0.0,) * 4)
    assert port.with_depth == (mode != "train")
    if dataset == "nuscenes":          # the split file's order
        assert port.index == ["sample_2", "sample_1"]
    else:
        assert port.depth_type == ref.depth_type == "lidar"
    port.cache_depth = ref.cache_depth = False
    _equal_samples(port, ref, epochs=(0,))
