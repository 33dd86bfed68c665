"""``sampler_3d: gather`` under mixed precision in the port: the gather-bf16
forms (``vfdepth_tpu_torch/ops/sample3d.py sample3d_gather`` and
``sample3d_gather_bwd``, their CUDA kernels in ``csrc/sample3d.cu`` and
``csrc/sample3d_bwd.cu``), against the JAX package's XLA gather
``grid_sample_3d`` in bf16 and the scatter of its custom VJP, on the CPU.

JAX runs jitted with XLA's excess precision off
(``xla_allow_excess_precision``), so it rounds to bf16 wherever its
program says. The coordinates mix spread points, points on the volume's
border and on voxel centres, fractions that round to 1 in bf16, points
outside the volume and non-finite ones.

* Forward: the plain version against ``grid_sample_3d`` on the same bf16
  volume: the same bits (tolerance 0: the same roundings in the same
  order).
* Backward: the plain version against ``jax.vjp`` of
  ``grid_sample_3d_nocoordgrad``: the same bits where no two taps share a
  voxel (points on distinct 2 x 2 x 2 blocks); where taps collide, within
  the spread of bf16 sums taken in another order (XLA's scatter order is
  unspecified): 4 bf16 steps (2^-6) of the largest output (measured: the
  same bits on the CPU, whose XLA scatter runs in update order).
* The plan: the plain (order, start) is each voxel's live taps in item
  order, and the plain backward equals the plan-order model of
  ``tests/helpers_torch_plan.py`` (a tap-by-tap loop) bit for bit.
* The wrappers take the plain versions on the CPU and refuse a non-bf16
  volume or cotangent.
* The slice: one mixed-precision ``predict`` and one training step with
  ``sampler_3d: gather`` against JAX's, at the spread of
  ``tests/test_torch_mixed_model.py`` (outputs 1e-2 of their magnitude,
  poses 2e-4; loss and logs 1e-2; each parameter's gradient within 0.5
  relative L2; BatchNorm statistics 1e-2 of their magnitude), and the
  port's gather step against its own 'packed' step (the same network,
  another sampler backward).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.ops.grid_sample import (grid_sample_3d,
                                         grid_sample_3d_nocoordgrad)
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.ops import sample3d as s3
from vfdepth_tpu_torch.training.model import VFDepthModel
from vfdepth_tpu_torch.weights import load_flax_params

from helpers_torch_plan import gather_bwd_in_plan_order
from helpers_torch_step import by_port_name, jax_step, port_step, with_motion
from helpers_torch_threads import port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"
STRICT = {"xla_allow_excess_precision": False}
SHAPE = (2, 6, 8, 4, 16)         # [B, H(y), W(x), D(z), C], yxz
BF = jnp.bfloat16


def _ndc(pix, shape=SHAPE):
    """Voxel coordinates (x, y, z) -> [-1, 1] (align_corners)."""
    _, h, w, d, _ = shape
    return (pix / (0.5 * (np.array([w, h, d]) - 1)) - 1.0).astype(np.float32)


def coords_of(kind: str, seed: int = 0, n: int = 400):
    rng = np.random.RandomState(seed)
    c = rng.uniform(-1.3, 1.3, (2, n, 3)).astype(np.float32)
    if kind == "border":
        # on the faces (+-1), on voxel centres (fraction 0) and just below
        # them (fractions that round to 1 in bf16)
        _, h, w, d, _ = SHAPE
        size = np.array([w, h, d]) - 1
        pix = rng.randint(0, size + 1, (2, n, 3)).astype(np.float32)
        pix[:, n // 3:2 * n // 3] -= 1e-4
        c = _ndc(pix)
        c[:, :40, rng.randint(3)] = rng.choice([-1.0, 1.0], (2, 40))
    elif kind == "outside":
        c[:, ::3] *= 3.0
        c[0, 1] = [np.nan, 0.0, 0.0]
        c[0, 2] = [0.0, np.inf, 0.0]
        c[1, 3] = [0.0, 0.0, -np.inf]
        c[1, 4] = [1e9, -1e9, 0.5]
        c[0, 5] = [-1.0000001, 1.0000001, 0.0]
    return c


def _distinct_coords(seed: int = 0):
    """One point inside each of the volume's 2 x 2 x 2 blocks: no two taps
    share a voxel."""
    rng = np.random.RandomState(seed)
    _, h, w, d, _ = SHAPE
    grid = np.stack(np.meshgrid(np.arange(0, w - 1, 2), np.arange(0, h - 1, 2),
                                np.arange(0, d - 1, 2), indexing="ij"),
                    -1).reshape(-1, 3).astype(np.float32)
    pix = np.stack([grid[rng.permutation(len(grid))] for _ in range(2)])
    return _ndc(pix + rng.uniform(0.05, 0.95, pix.shape))


def _vol(seed=1):
    rng = np.random.RandomState(seed)
    return jnp.asarray(rng.randn(*SHAPE).astype(np.float32)).astype(BF)


def _t(a):
    """A bf16 JAX array -> the same bits as a torch bf16 tensor."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def _jax_fwd(vol, coords):
    fn = jax.jit(lambda v, c: grid_sample_3d(jnp.moveaxis(v, 3, 1), c))
    return fn.lower(vol, coords).compile(compiler_options=STRICT)(vol, coords)


def _jax_bwd(vol, coords, g):
    def vjp(v, c, gg):
        _, pull = jax.vjp(lambda vv: grid_sample_3d_nocoordgrad(
            jnp.moveaxis(vv, 3, 1), c), v)
        return pull(gg)[0]
    fn = jax.jit(vjp).lower(vol, coords, g).compile(compiler_options=STRICT)
    return fn(vol, coords, g)


def _g(n, seed=2):
    rng = np.random.RandomState(seed)
    return jnp.asarray(rng.randn(2, n, SHAPE[-1]).astype(np.float32)).astype(BF)


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("kind", ["spread", "border", "outside"])
def test_forward_plain_equals_jax_bits(kind):
    vol, coords = _vol(), coords_of(kind)
    want = _t(_jax_fwd(vol, coords))
    got = s3.sample3d_gather(_t(vol), torch.from_numpy(coords))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num()), (
        (got.float() - want.float()).abs().max())
    assert got.float().abs().max() > 0


def test_backward_plain_equals_jax_bits_on_distinct_voxels():
    vol, coords = _vol(), _distinct_coords()
    g = _g(coords.shape[1])
    want = _t(_jax_bwd(vol, coords, g))
    got = s3.sample3d_gather_bwd(_t(g), torch.from_numpy(coords), SHAPE)
    assert got.dtype == torch.bfloat16 and got.shape == SHAPE
    assert torch.equal(got, want)
    assert (got != 0).float().mean() > 0.5


@pytest.mark.parametrize("kind", ["spread", "border", "outside"])
def test_backward_plain_matches_jax_where_taps_collide(kind):
    vol, coords = _vol(), coords_of(kind)
    g = _g(coords.shape[1])
    want = _t(_jax_bwd(vol, coords, g)).float()
    got = s3.sample3d_gather_bwd(_t(g), torch.from_numpy(coords),
                                 SHAPE).float()
    wts, keys = s3._gather_bwd_items(torch.from_numpy(coords), SHAPE)
    live = keys[keys < keys.max()]
    assert live.unique().numel() < live.numel()      # taps do collide
    assert np.isfinite(got.numpy()).all()
    assert (got - want).abs().max() <= 2.0 ** -6 * want.abs().max()


@pytest.mark.parametrize("kind", ["spread", "outside"])
def test_plan_is_each_voxels_live_taps_in_item_order(kind):
    coords = torch.from_numpy(coords_of(kind))
    order, start = s3.sample3d_gather_bwd_plan_plain(coords, SHAPE)
    wts, keys = s3._gather_bwd_items(coords, SHAPE)
    n_keys = int(np.prod(SHAPE[:4]))
    assert order.dtype == start.dtype == torch.int32
    assert start.shape == (n_keys + 1,) and order.shape == keys.shape
    live = int(start[-1])
    assert live == int((wts != 0).sum()) == int((keys < n_keys).sum())
    for k in range(n_keys):
        items = order[start[k]:start[k + 1]].long()
        assert torch.equal(items, torch.nonzero(keys == k).reshape(-1)), k
    assert bool((keys[order[live:].long()] == n_keys).all())


@pytest.mark.parametrize("kind", ["spread", "border", "outside"])
def test_backward_plain_equals_plan_order_model(kind):
    coords = torch.from_numpy(coords_of(kind, seed=3, n=150))
    g = _t(_g(150, seed=4))
    got = s3.sample3d_gather_bwd(g, coords, SHAPE)
    assert torch.equal(_bits(got), _bits(gather_bwd_in_plan_order(
        g, coords, SHAPE)))


def test_wrappers_refuse_other_dtypes():
    vol = torch.zeros(SHAPE)
    coords = torch.zeros(2, 5, 3)
    with pytest.raises(TypeError, match="bfloat16"):
        s3.sample3d_gather(vol, coords)
    with pytest.raises(TypeError, match="bfloat16"):
        s3.sample3d_gather_bwd(torch.zeros(2, 5, SHAPE[-1]), coords, SHAPE)
    with pytest.raises(TypeError, match="bf16 volume"):
        s3.Sample3dGather.apply(vol, coords)


def test_gather_function_gradient_is_the_backward():
    vol = _t(_vol()).requires_grad_()
    coords = torch.from_numpy(coords_of("spread"))
    g = _t(_g(coords.shape[1]))
    out = s3.Sample3dGather.apply(vol, coords)
    assert torch.equal(out, s3.sample3d_gather_plain(vol.detach(), coords))
    out.backward(g)
    assert vol.grad.dtype == torch.bfloat16
    assert torch.equal(vol.grad, s3.sample3d_gather_bwd_plain(g, coords,
                                                              SHAPE))


# ------------------------------------------------------------- the slice

def _cfgs(sampler="gather"):
    jcfg, tcfg = jax_get_config(TINY), get_config(TINY)
    for cfg in (jcfg, tcfg):
        cfg.set("warp_window", False)
        cfg.set("mixed_precision", True)
        cfg.set("sampler_3d", sampler)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def shared():
    cfg = jax_get_config(TINY)
    batch = FakeDataset(num_samples=1, num_cams=cfg.num_cams,
                        height=cfg.height, width=cfg.width,
                        fusion_level=cfg.fusion_level).batch([0])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params, stats = JaxModel(cfg).init(jax.random.PRNGKey(0), jbatch)
    return batch, jbatch, params, stats


def _port(params, stats, sampler="gather"):
    model = VFDepthModel(_cfgs(sampler)[1], device="cpu")
    load_flax_params(model, *jax.tree_util.tree_map(np.asarray,
                                                    (params, stats)))
    return model


def test_predict_with_gather_matches_jax(shared, monkeypatch):
    batch, jbatch, params, stats = shared
    jm = JaxModel(_cfgs()[0])

    def run(p, s, b):
        cam, disps, *_ = jm.predict_pose_depth(p, s, b, jax.random.PRNGKey(1),
                                               False)
        return cam, disps[0], jm.to_depth(disps[0], b["K/0"])
    fn = jax.jit(run).lower(params, stats, jbatch).compile(
        compiler_options=STRICT)
    want = [np.asarray(a, np.float32) for a in fn(params, stats, jbatch)]
    model = _port(params, stats)
    assert model.depth_net.fusion_net.gather
    calls = []
    real = s3.sample3d_gather

    def counted(vol, coords):
        calls.append(vol.dtype)
        return real(vol, coords)
    monkeypatch.setattr(s3, "sample3d_gather", counted)
    got = model.predict(batch)
    assert calls == [torch.bfloat16]       # the gather-bf16 form served
    for name, w in zip(("cam_T_cam", "disp/0", "depth/0"), want):
        g = got[name].numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), name
        atol = 2e-4 if name == "cam_T_cam" else 1e-2 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def steps(shared):
    batch, jbatch, params, stats = shared
    params = with_motion(params)
    grads, logs, new_stats, noise, _ = jax_step(
        JaxModel(_cfgs()[0]), params, stats, jbatch, 3, STRICT)
    out = {"jax": dict(grads=by_port_name(grads),
                       logs={k: float(v) for k, v in logs.items()},
                       stats=by_port_name(new_stats))}
    for sampler in ("gather", "packed"):
        model = _port(params, stats, sampler)
        tlogs, _ = port_step(model, batch, noise, 3)
        out[sampler] = dict(
            model=model, logs=tlogs,
            grads={k: p.grad.numpy() for k, p in model.named_parameters()},
            stats={k: v.numpy() for k, v in model.named_buffers()})
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_step_with_gather_loss_and_logs_match_jax(steps):
    want, got = steps["jax"]["logs"], steps["gather"]["logs"]
    assert set(got) == set(want)
    for key, w in want.items():
        assert np.isfinite(got[key]), key
        assert abs(got[key] - w) <= 1e-2 * max(abs(w), 1e-3), (key, got[key],
                                                               w)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_with_gather_gradients_match_jax(steps, net):
    want, got = steps["jax"]["grads"], steps["gather"]["grads"]
    names = [k for k in want if k.startswith(net + ".")]
    assert set(names) == {k for k in got if k.startswith(net + ".")}
    for name in names:
        g, w = got[name], want[name]
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        assert _rel(g, w) <= 0.5, (name, _rel(g, w))


def test_step_with_gather_batchnorm_matches_jax(steps):
    want, got = steps["jax"]["stats"], steps["gather"]["stats"]
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-2 * np.abs(w).max(), err_msg=name)


def test_gather_and_packed_steps_differ_only_in_the_sampler(steps):
    """The gather step's volume gradient comes from the gather backward,
    the 'packed' step's from K4's bf16 updates: the reduce convs above the
    sample see the same forward up to the sampler's rounding, so their
    gradients agree within the bf16 spread, and the voxel MLPs below it
    differ (other roundings) but stay within it."""
    ga, pa = steps["gather"]["grads"], steps["packed"]["grads"]
    assert steps["gather"]["model"].sampler_3d == "gather"
    for name in ga:
        assert _rel(ga[name], pa[name]) <= 0.5, (name, _rel(ga[name],
                                                            pa[name]))
    fused = [k for k in ga if ".fusion_net.conv_" in k]
    assert fused and any(not np.array_equal(ga[k], pa[k]) for k in fused)
