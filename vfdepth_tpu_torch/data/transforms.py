"""Host-side image transforms: resize, colour jitter, sample assembly (port
of ``vfdepth_tpu/data/transforms.py``).

Reproduces the reference's data augmentation contract
(``models/vfdepth.py:97-138``: train = jitter(0.2, 0.2, 0.2, 0.05) + resize,
val/eval = resize only) and the per-scale pyramid assembly of
``dataset/data_util.py:46-91``: K/inv_K and frame-0 color pyramids for scales
0..fusion_level+1, context frames at scale 0 only.

Color jitter follows torchvision semantics: factors drawn uniformly from
[max(0, 1-b), 1+b] (brightness/contrast/saturation) and [-h, h] (hue),
applied in random order. 'color' carries the clean image, 'color_aug' the
jittered one (both resized).

Every bilinear resize goes through the native library (``..native``), which
raises when it cannot be built: the JAX package's fallbacks to PIL's uint8
bilinear and to numpy nearest are left out on purpose, so a sample is the
same in both packages or is not made at all.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..native import resize_batch
from .contract import build_intrinsics_pyramid, color_key


def resize_image(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a [H, W, 3] float image in [0, 1] (the native
    threaded resize on one thread)."""
    if img.shape[:2] == tuple(hw):
        return img
    return resize_batch(img[None].astype(np.float32, copy=False), hw,
                        n_threads=1)[0]


def resize_images_batch(imgs: np.ndarray, hw: Tuple[int, int],
                        n_threads: int = 4) -> np.ndarray:
    """Batched multi-camera resize [N, H, W, 3] via the native lib."""
    if imgs.shape[1:3] == tuple(hw):
        return imgs.astype(np.float32, copy=False)
    return resize_batch(imgs, hw, n_threads=n_threads)


def resize_mask(mask: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Nearest resize of a [H, W] or [H, W, 1] binary mask -> [H, W, 1]."""
    if mask.ndim == 3:
        mask = mask[..., 0]
    ys = np.clip((np.arange(hw[0]) * mask.shape[0] / hw[0]).astype(int), 0, mask.shape[0] - 1)
    xs = np.clip((np.arange(hw[1]) * mask.shape[1] / hw[1]).astype(int), 0, mask.shape[1] - 1)
    return mask[ys][:, xs][..., None].astype(np.float32)


def resize_depth_preserve(depth: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Sparse-preserving depth resize (packnet-sfm ``resize_depth_preserve``
    semantics, which the reference's DGP pipeline applies to lidar GT):
    every valid source point is scattered onto the target grid at its scaled
    integer position — ALL lidar returns survive (collisions overwrite),
    unlike lattice subsampling which discards ~(1 - 1/scale^2) of them.

    depth: [H0, W0] or [H0, W0, 1]; returns [h, w, 1] float32.
    """
    if depth.ndim == 3:
        depth = depth[..., 0]
    h0, w0 = depth.shape
    h, w = hw
    ys, xs = np.nonzero(depth > 0)
    vals = depth[ys, xs]
    ty = np.clip((ys * h / h0).astype(np.int64), 0, h - 1)
    tx = np.clip((xs * w / w0).astype(np.int64), 0, w - 1)
    out = np.zeros((h, w), np.float32)
    out[ty, tx] = vals
    return out[..., None]


def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    return (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])[..., None]


def draw_jitter_params(rng: np.random.RandomState, brightness: float,
                       contrast: float, saturation: float, hue: float):
    """Draw ONE torchvision-style jitter parameter set (factors + op order).

    The reference draws one parameter set per SAMPLE and applies it to every
    camera and context frame (torchvision ColorJitter called once per sample
    by packnet's ``duplicate_sample``-style transform) — per-camera draws
    would break cross-camera photometric consistency that the spatio losses
    rely on.
    """
    params = {}
    if brightness > 0:
        params["brightness"] = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    if contrast > 0:
        params["contrast"] = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    if saturation > 0:
        params["saturation"] = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    if hue > 0:
        params["hue"] = rng.uniform(-hue, hue)
    params["order"] = rng.permutation(len(params))
    return params


def apply_color_jitter(img: np.ndarray, params) -> np.ndarray:
    """Apply a drawn jitter parameter set to a [H, W, 3] float image."""
    ops = []
    if "brightness" in params:
        f = params["brightness"]
        ops.append(lambda x, f=f: x * f)
    if "contrast" in params:
        f = params["contrast"]
        ops.append(lambda x, f=f: (x - _rgb_to_gray(x).mean()) * f
                   + _rgb_to_gray(x).mean())
    if "saturation" in params:
        f = params["saturation"]
        ops.append(lambda x, f=f: (x - _rgb_to_gray(x)) * f + _rgb_to_gray(x))
    if "hue" in params:
        shift = params["hue"]

        def hue_op(x, shift=shift):
            # hue rotation in YIQ space (cheap approximation of HSV shift)
            theta = 2 * np.pi * shift
            cos_t, sin_t = np.cos(theta), np.sin(theta)
            tyiq = np.array([
                [0.299, 0.587, 0.114],
                [0.596, -0.274, -0.322],
                [0.211, -0.523, 0.312]])
            ityiq = np.linalg.inv(tyiq)
            rot = np.array([[1, 0, 0], [0, cos_t, -sin_t], [0, sin_t, cos_t]])
            m = ityiq @ rot @ tyiq
            return x @ m.T

        ops.append(hue_op)
    out = img
    for i in params["order"]:
        out = ops[i](out)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def color_jitter(rng: np.random.RandomState, img: np.ndarray,
                 brightness: float, contrast: float, saturation: float,
                 hue: float) -> np.ndarray:
    """Torchvision-style jitter on a [H, W, 3] float image in [0, 1]."""
    return apply_color_jitter(
        img, draw_jitter_params(rng, brightness, contrast, saturation, hue))


def assemble_sample(
    rng: np.random.RandomState,
    images: Dict[int, np.ndarray],      # frame_id -> [cams, H0, W0, 3] raw
    k_full: np.ndarray,                 # [cams, 4, 4] at raw resolution
    extrinsics: np.ndarray,             # [cams, 4, 4]
    mask: np.ndarray,                   # [cams, Hm, Wm(, 1)]
    hw: Tuple[int, int],
    fusion_level: int,
    jitter: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
    depth: Optional[np.ndarray] = None,  # [cams, H0, W0] GT (kept at raw res? resized)
) -> Dict[str, np.ndarray]:
    """Raw per-frame camera images -> contract batch-sample dict."""
    h, w = hw
    cams = k_full.shape[0]
    raw_h, raw_w = images[0].shape[1:3]
    n_scales = fusion_level + 2

    # scale intrinsics from raw resolution to the target resolution
    k0 = k_full.copy()
    k0[:, 0, :] *= w / raw_w
    k0[:, 1, :] *= h / raw_h

    do_jitter = any(j > 0 for j in jitter)
    # ONE jitter parameter set per sample, shared by every camera and
    # context frame (reference parity; see draw_jitter_params)
    params = draw_jitter_params(rng, *jitter) if do_jitter else None
    sample: Dict[str, np.ndarray] = {}
    for f, imgs in images.items():
        resized = resize_images_batch(imgs, hw)
        sample[color_key(f, 0)] = resized
        if do_jitter:
            sample[color_key(f, 0, aug=True)] = np.stack(
                [apply_color_jitter(resized[c], params) for c in range(cams)])
        else:
            sample[color_key(f, 0, aug=True)] = resized
    for s in range(1, n_scales):
        hs, ws = h // (2 ** s), w // (2 ** s)
        sample[color_key(0, s)] = resize_images_batch(
            sample[color_key(0, 0)], (hs, ws))
        sample[color_key(0, s, aug=True)] = resize_images_batch(
            sample[color_key(0, 0, True)], (hs, ws))

    sample.update(build_intrinsics_pyramid(k0, n_scales))
    sample["extrinsics"] = extrinsics.astype(np.float32)
    sample["extrinsics_inv"] = np.linalg.inv(extrinsics).astype(np.float32)
    sample["mask"] = np.stack([resize_mask(mask[c], hw) for c in range(cams)])
    if depth is not None:
        # Sparse-preserving resize to network resolution — the reference's
        # protocol: its DGP/nuScenes pipeline resizes lidar GT with packnet's
        # resize_depth_preserve (every return survives), then
        # compute_depth_losses interpolates the prediction to the GT map and
        # masks there (reference utils/logger.py:208-232). A plain nearest
        # subsample would discard ~90% of returns and shift positions,
        # making metrics non-comparable to the published table.
        sample["depth"] = np.stack(
            [resize_depth_preserve(depth[c], hw) for c in range(cams)])
    return sample
