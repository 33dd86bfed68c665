"""The destination-tile plan of the backward kernels K4 and K2/K2b, and the
order in which their CUDA forms sum, on the CPU at small sizes.

The plan (``vfdepth_tpu_torch/ops/dest_tiles.py``, ``csrc/dest_tiles.cuh``)
sorts the live contributions by the output tile of their tap base; each
output tile then sums the lists that reach it, chunk by chunk. Checked here:

* the plain plan is complete (every live contribution once), stable (index
  order within a key) and drops what adds nothing: K4's points whose 8
  weights are 0 (non-finite or far out), K2's invalid or dead points;
* every tap that adds something lands in exactly one tile that reads its
  point;
* summing each output in plan order (``tests/helpers_torch_plan.py``)
  reproduces the plain versions: K4's bf16 updates bit for bit where every
  tap-plane entry takes one addition (distinct base voxels), and where
  points crowd, within the bound of bf16 rounding (the kernel rounds every
  addition to bf16, the plain version's ``index_add_`` accumulates a call
  in f32: a cosine above 0.995 and a relative L2 difference below 0.1, as
  tests/test_torch_kernels_cuda.py bounds them); K4's f32 updates within
  2e-5 of the largest output and K2/K2b within 1e-5 (the same f32 terms
  summed in another order: each voxel's taps in plan order against the
  plain versions' tap planes, measured 5e-7 and 2e-7);
* hot tiles are cut in chunks of twice the mean list, their partial tiles
  summed in chunk order, and the scratch cap keeps every tile whole.

The plain versions themselves are held against the JAX package by
tests/test_torch_ops.py and tests/test_torch_mixed_ops.py, unchanged.
"""
import numpy as np
import pytest
import torch

from helpers_torch_plan import k2_in_plan_order, k4_in_plan_order
from vfdepth_tpu_torch.ops import backproject_sample as bp
from vfdepth_tpu_torch.ops import dest_tiles
from vfdepth_tpu_torch.ops import sample3d as s3
from helpers_torch_threads import port_threads  # noqa: F401

SHAPE = (2, 7, 9, 4, 6)      # [B, H(y), W(x), D(z), C]


def _coords(seed, n=700, crowd=300):
    """Frustum-like coordinates: a crowd near one corner (many points per
    base voxel), the rest spread over and past the volume, with non-finite
    and far-out points."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-1.2, 1.2, (2, n, 3)).astype(np.float32)
    c[:, :crowd] = rng.uniform(-1.0, -0.7, (2, crowd, 3))
    c[0, 5, 1] = np.nan
    c[1, 6, 0] = np.inf
    c[:, 7] = [40.0, -1e9, 3.0]
    return torch.from_numpy(c)


def _distinct(seed, shape=SHAPE):
    """One point per base voxel (fractions away from the edges): one
    addition per tap-plane entry."""
    rng = np.random.RandomState(seed)
    nb, h, w, d, _ = shape
    n_vox = (h - 1) * (w - 1) * (d - 1)
    base = np.stack([rng.permutation(n_vox) for _ in range(nb)])
    yb, xb = base // ((w - 1) * (d - 1)), (base // (d - 1)) % (w - 1)
    pix = np.stack([xb, yb, base % (d - 1)], -1) + rng.uniform(
        0.1, 0.9, (nb, n_vox, 3))
    return torch.from_numpy((pix / (0.5 * (np.array([w, h, d]) - 1))
                             - 1.0).astype(np.float32))


def _g(seed, n, c=SHAPE[-1], dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(2, n, c).astype(np.float32)).to(dtype)


def _check_plan(plan, keys, n_keys):
    """Complete, stable, dead last; start agrees with the keys."""
    keys = keys.long()
    order = plan.order.long()
    live = int((keys < n_keys).sum())
    assert int(plan.start[-1]) == live
    assert sorted(order.tolist()) == list(range(len(keys)))
    sk = keys[order]
    assert bool((sk[1:] >= sk[:-1]).all())
    same = sk[1:] == sk[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())    # stable
    assert bool((sk[live:] == n_keys).all()) and bool((sk[:live] < n_keys)
                                                      .all())
    counts = torch.bincount(sk[:live], minlength=n_keys)
    np.testing.assert_array_equal(plan.start[1:].long() - plan.start[:-1]
                                  .long(), counts)


@pytest.mark.parametrize("bf16_updates", [False, True])
def test_k4_plan_is_complete_stable_and_drops_dead(bf16_updates):
    coords = _coords(0)
    keys = s3.sample3d_bwd_keys(coords, SHAPE, bf16_updates)
    grid = s3._grid(SHAPE, bf16_updates)
    plan = s3.sample3d_bwd_plan_plain(coords, SHAPE, bf16_updates)
    _check_plan(plan, keys, grid.n_keys)
    dead = (keys == grid.n_keys).nonzero().flatten().tolist()
    assert {5, 700 + 6, 7, 700 + 7} <= set(dead)      # non-finite, far out
    base, wts = s3._point_taps(coords.reshape(-1, 3), *SHAPE[1:4])
    assert bool((torch.stack(wts).ne(0).any(0) == (keys < grid.n_keys)).all())


def _cams(seed, cams=3, h=10, w=13, c=5, n=900):
    rng = np.random.RandomState(seed)
    feats = torch.from_numpy(rng.randn(cams, h, w, c).astype(np.float32))
    mask = torch.from_numpy((rng.rand(cams, h, w) > 0.3).astype(np.float32))
    z = rng.uniform(-2.0, 10.0, (cams, n))
    px = rng.uniform(-4, w + 4, (cams, n))
    py = rng.uniform(-4, h + 4, (cams, n))
    cam3 = np.stack([px * z, py * z, z], -1).astype(np.float32)
    cam3[:, 30:35, 0] = np.nan
    cam3[:, 40:42, 2] = np.nan
    norm = rng.uniform(-1.3, 1.3, (cams, n, 2)).astype(np.float32)
    norm[:, 10, 0] = np.nan
    norm[:, 11] = [1e30, -3e9]
    return feats, mask, torch.from_numpy(cam3), torch.from_numpy(norm)


@pytest.mark.parametrize("case", ["raw gated", "normalised ungated"])
def test_k2_plan_is_complete_stable_and_drops_invalid(case):
    feats, mask, cam3, norm = _cams(1)
    cams, h, w, _ = feats.shape
    if case == "raw gated":
        _, valid = bp.sample2d_plain(feats, mask, cam3, "backproject", 0.25,
                                     True)
        coords, raw = cam3, True
    else:
        valid, coords, raw = None, norm, False
    keys = bp.backproject_bwd_keys(coords, valid, h, w, raw)
    grid = dest_tiles.Grid(cams, h, w, *bp.K2_TILE)
    plan = bp.backproject_bwd_plan_plain(coords, valid, h, w, raw)
    _check_plan(plan, keys, grid.n_keys)
    live, *_ = bp._taps(coords.reshape(-1, coords.shape[-1]), h, w, raw)
    if valid is not None:
        live = live & (valid.reshape(-1) != 0)
        assert 0 < int(live.sum()) < int((keys.numel()))
    np.testing.assert_array_equal((keys < grid.n_keys).numpy(), live.numpy())


def _tile_hits(grid, plan, cells_of):
    """Per contribution, the number of taps that land in a tile that reads
    it, summed over the tiles."""
    hits = torch.zeros(len(plan.order), dtype=torch.long)
    for t in range(grid.n_tiles):
        img = t // (grid.nty * grid.ntx)
        y0 = (t // grid.ntx) % grid.nty * grid.ty
        x0 = t % grid.ntx * grid.tx
        for items in dest_tiles.tile_items(plan, grid, t):
            cy, cx, ok = cells_of(items)
            inside = (ok & (cy >= y0) & (cy < y0 + grid.ty) & (cx >= x0)
                      & (cx < x0 + grid.tx)).sum(1)
            assert bool((items // (len(plan.order) // grid.n_img) == img)
                        .all())
            hits.index_add_(0, items, inside)
    return hits


@pytest.mark.parametrize("bf16_updates", [False, True])
def test_every_k4_tap_lands_in_one_tile_that_reads_it(bf16_updates):
    coords = _coords(2)
    _, h, w, d, _ = SHAPE
    grid = s3._grid(SHAPE, bf16_updates)
    plan = s3.sample3d_bwd_plan_plain(coords, SHAPE, bf16_updates)
    offs = torch.tensor(s3._tap_offsets(w, d))
    crd = coords.reshape(-1, 3)

    def cells_of(items):
        base, wts = s3._point_taps(crd[items], h, w, d)
        vox = base[:, None] + offs
        return vox // (w * d), (vox // d) % w, torch.stack(wts, 1) != 0

    _, wts = s3._point_taps(crd, h, w, d)
    want = (torch.stack(wts, 1) != 0).sum(1)
    assert torch.equal(_tile_hits(grid, plan, cells_of), want)


def test_every_k2_tap_lands_in_one_tile_that_reads_it():
    feats, mask, _, norm = _cams(3)
    cams, h, w, _ = feats.shape
    grid = dest_tiles.Grid(cams, h, w, *bp.K2_TILE)
    plan = bp.backproject_bwd_plan_plain(norm, None, h, w, False)
    crd = norm.reshape(-1, 2)

    def taps(items):
        live, ix, iy, _, _ = bp._taps(crd[items], h, w, False)
        cy = torch.stack([iy, iy, iy + 1, iy + 1], 1)
        cx = torch.stack([ix, ix + 1, ix, ix + 1], 1)
        ok = live[:, None] & (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
        return cy, cx, ok

    want = taps(torch.arange(crd.shape[0]))[2].sum(1)
    assert int(want.sum()) > 0
    assert torch.equal(_tile_hits(grid, plan, taps), want)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_k4_bf16_updates_in_plan_order_exact_at_distinct_bases(g_dtype):
    coords = _distinct(4)
    g = _g(5, coords.shape[1], dtype=g_dtype)
    got = k4_in_plan_order(g, coords, SHAPE, True)
    want = s3.sample3d_trilinear_bwd_bf16_plain(g, coords, SHAPE)
    assert got.dtype == g_dtype
    assert torch.equal(got, want)


def _cos_rel(a, b):
    a, b = a.double().ravel(), b.double().ravel()
    return ((a @ b) / (a.norm() * b.norm())).item(), \
        ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_k4_bf16_updates_in_plan_order_crowded(g_dtype):
    coords = _coords(6)
    g = _g(7, coords.shape[1], dtype=g_dtype)
    got = k4_in_plan_order(g, coords, SHAPE, True)
    for ref in (s3.sample3d_trilinear_bwd_bf16_plain(g, coords, SHAPE),
                s3.sample3d_trilinear_bwd_plain(g.float(), coords, SHAPE)):
        cos, rel = _cos_rel(got, ref)
        assert cos > 0.995 and rel < 0.1, (cos, rel)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_k4_f32_updates_in_plan_order_match_plain(g_dtype):
    coords = _coords(8)
    g = _g(9, coords.shape[1], dtype=g_dtype)
    got = k4_in_plan_order(g, coords, SHAPE, False)
    want = s3.sample3d_trilinear_bwd_plain(g, coords, SHAPE)
    assert got.dtype == g_dtype
    if g_dtype == torch.bfloat16:     # one rounding of f32 sums that differ
        got, want = got.float(), want.float()
        tol = (2.0 ** -7 + 2e-5) * want.abs().max().item()
    else:
        tol = 2e-5 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["K2 raw", "K2 normalised", "K2 bf16 g",
                                  "K2b gated raw", "K2b ungated normalised"])
def test_k2_in_plan_order_match_plain(case):
    rng = np.random.RandomState(10)
    if case.startswith("K2 "):
        b, gs, c = 1, 3, 5
        feats, mask, cam3, norm = _cams(11, cams=b * 2 * gs, c=c)
        h, w = feats.shape[1:3]
        raw = case != "K2 normalised"
        coords = cam3 if raw else torch.cat(
            [norm, cam3[..., 2:]], -1).contiguous()
        _, valid = bp.backproject_grouped_plain(feats, mask, coords, 0.25, b,
                                                gs, raw)
        g = torch.from_numpy(rng.randn(b, 2, coords.shape[1], c + 2).astype(
            np.float32))
        if case == "K2 bf16 g":
            g = g.to(torch.bfloat16)
        got = k2_in_plan_order(g, coords, valid, h, w, c, gs, raw)
        want = bp.backproject_grouped_bwd_plain(g, coords, valid, h, w, c,
                                                gs, raw)
    else:
        feats, mask, cam3, norm = _cams(12)
        cams, h, w, c = feats.shape
        if case == "K2b gated raw":
            _, valid = bp.sample2d_plain(feats, mask, cam3, "backproject",
                                         0.25, True)
            coords, raw, ldg = cam3, True, c + 1
        else:
            valid, coords, raw, ldg = None, norm, False, c
        g = torch.from_numpy(rng.randn(cams, coords.shape[1], ldg).astype(
            np.float32))
        got = k2_in_plan_order(g, coords, valid, h, w, c, 0, raw)
        want = bp.sample2d_bwd_plain(g, coords, valid, h, w, c, raw)
    assert want.abs().max() > 0
    if want.dtype == torch.bfloat16:   # the kernel's output, rounded once
        got, want = got.to(torch.bfloat16).float(), want.float()
        tol = (2.0 ** -7 + 1e-5) * want.abs().max().item()
    else:
        tol = 1e-5 * want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_hot_tiles_are_cut_in_chunks():
    """A crowd in one tile: its list is longer than twice the mean, so it
    is walked in chunks with scratch slots, and the chunks' partial sums,
    added in chunk order, still give the plain sums."""
    coords = _coords(13, n=3000, crowd=2600)
    grid = s3._grid(SHAPE, False)
    plan = s3.sample3d_bwd_plan_plain(coords, SHAPE, False)
    k = plan.chunk_off[1:] - plan.chunk_off[:-1]
    _, lens = grid.runs(plan.start)
    chunk = int(plan.params[0])
    assert chunk == max(256, 2 * -(-int(lens.sum()) // grid.n_tiles))
    assert int(k.max()) >= 3
    np.testing.assert_array_equal(k.numpy(), np.maximum(
        1, -(-lens.sum(1).numpy() // chunk)))
    assert int(plan.params[1]) == int(k[k > 1].sum()) <= grid.max_slots
    g = _g(14, coords.shape[1])
    torch.testing.assert_close(
        k4_in_plan_order(g, coords, SHAPE, False),
        s3.sample3d_trilinear_bwd_plain(g, coords, SHAPE), rtol=0,
        atol=2e-5 * s3.sample3d_trilinear_bwd_plain(g, coords, SHAPE).abs()
        .max().item())


def test_slot_cap_keeps_every_tile_whole():
    """Past the scratch cap no tile is cut (a fixed rule, so the plan stays
    deterministic)."""
    class Capped(dest_tiles.Grid):
        @property
        def max_slots(self):
            return 0

    coords = _coords(13, n=3000, crowd=2600)
    grid = s3._grid(SHAPE, False)
    keys = s3.sample3d_bwd_keys(coords, SHAPE, False)
    plan = dest_tiles.plan_plain(keys, Capped(*vars(grid).values()))
    assert torch.equal(plan.chunk_off, torch.arange(grid.n_tiles + 1,
                                                    dtype=torch.int32))
    assert int(plan.slot_off.abs().sum()) == 0
    assert plan.params.tolist() == [2 ** 31 - 1, 0]


@pytest.mark.parametrize("case", ["K4 f32 plan, bf16-update grid",
                                  "K4 plan of fewer points",
                                  "K2 plan, int64 order"])
def test_a_plan_of_other_sizes_is_refused(case):
    """The kernels index a plan by their grid's tiles and keys, so the
    private launch refuses a plan built for another grid or point count
    (here on the CPU, before anything would be launched); the plan built
    for the call passes."""
    coords = _coords(15)
    if case.startswith("K4"):
        grid = s3._grid(SHAPE, True)
        n = 2 * coords.shape[1]
        dest_tiles.check_plan(s3.sample3d_bwd_plan_plain(coords, SHAPE, True),
                              grid, n, torch.device("cpu"))
        bad = (s3.sample3d_bwd_plan_plain(coords, SHAPE, False)
               if "f32" in case else
               s3.sample3d_bwd_plan_plain(coords[:, :-1], SHAPE, True))
    else:
        _, _, cam3, _ = _cams(16)
        grid = dest_tiles.Grid(cam3.shape[0], 10, 13, *bp.K2_TILE)
        n = cam3.shape[0] * cam3.shape[1]
        good = bp.backproject_bwd_plan_plain(cam3, None, 10, 13, True)
        dest_tiles.check_plan(good, grid, n, torch.device("cpu"))
        bad = dest_tiles.Plan(**{**good.fields(),
                                 "order": good.order.long()})
    with pytest.raises(ValueError, match="plan"):
        dest_tiles.check_plan(bad, grid, n, torch.device("cpu"))
