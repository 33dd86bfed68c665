"""One training step of the port against the JAX package's, on the CPU.

The tiny config (``configs/tiny_fake.yaml``, batch 1, ``tpu.warp_window``
off) from the flax init, weights carried over, with a pose-head bias of a
real ego-motion (``_with_motion``). The JAX step is ``build_train_step``'s
body under ``jax.jit``, computed once for the module (~40 s on one CPU
core: init plus one compile); its tie-break noise comes from the same key
splits as ``forward`` / ``total_loss`` and is handed to the port. JAX's CPU
path runs the ungrouped f32 gather sampler, the quad warp and the packed
3-D sampler with f32 updates (Pallas interpret mode); the port runs the
plain versions of K1-K5. All f32, so the two differ by summation order --
and by the auto-mask, a discrete comparison of two photometric losses:
SSIM amplifies the ~1e-6 f32 differences of the warped images to ~3e-5 in
the loss, and a few pixels lie that close to a tie (3 of 36,864 here;
which ones depends on every rounding, so the port runs its CPU
convolutions on a fixed 2 threads, ``PORT_THREADS``). Bounds, with room
for the XLA side's own rounding on another machine:

* the auto-masks agree on all but 12 pixels (0.03%; measured 3);
* loss and scalar logs: 2e-5 of their magnitude, 1e-3 for the four that
  average over the auto-mask (one flipped pixel moves them ~4e-5;
  measured 1.2e-4);
* each parameter's gradient, as a relative L2 error: depth net 5e-3, pose
  net 5e-2 (the pose gradient is a sum over pixels that largely cancels,
  so a flipped edge pixel weighs more; measured 8e-4 and 1e-2);
* updated BatchNorm running statistics: 1e-5 of their magnitude;
* a step from a carried Adam state (moments and count as a mid-run JAX
  state would hold them, updates of about lr): updated parameters within
  2e-2 * lr (measured 5e-3) -- the update moves by 0.1 * dg / sqrt(v_hat),
  and single pose gradient entries differ by up to 10% of their
  parameter's scale. Adam's first step from zero moments is about
  lr * sign(g), so a gradient entry near 0 flips it and that comparison
  is not made; the optimizer itself is held on identical gradients, to
  1e-5 of each update (optax's f32 bias correction) plus the parameters'
  f32 rounding.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vfdepth_tpu.config import get_config as jax_get_config
from vfdepth_tpu.data.fake import FakeDataset
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu.training.step import make_lr_schedule as jax_lr_schedule
from vfdepth_tpu.training.step import make_optimizer as jax_make_optimizer
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                        make_lr_schedule, make_optimizer)
from vfdepth_tpu_torch.training.step import lr_at
from vfdepth_tpu_torch.weights import (_leaves, _to_torch_layout, _torch_name,
                                       load_flax_params, load_optax_adam_state)
from helpers_torch_threads import PORT_THREADS, port_threads  # noqa: F401

jax.config.update("jax_platforms", "cpu")
TINY = "configs/tiny_fake.yaml"
STEP = 3          # global step of the compared update (cold start is off)
CARRIED_COUNT = 7


def _cfgs():
    jcfg, tcfg = jax_get_config(TINY), get_config(TINY)
    for cfg in (jcfg, tcfg):
        cfg.set("warp_window", False)
    return jcfg, tcfg


def _by_port_name(tree):
    return {_torch_name(path): _to_torch_layout(path[-1], value)
            for path, value in _leaves(tree)}


def _with_motion(params):
    """The flax init predicts a pose of ~0, where every temporal warp is
    near the identity and the auto-mask compares two losses that agree to
    ~1e-5 -- a coin toss that any f32 reordering flips. A pose-head bias of
    a real ego-motion (0.02-0.03 m, 0.01 rad) moves the warps off it."""
    params = jax.tree_util.tree_map(lambda a: a, params)
    head = dict(params["pose_net"]["pose_decoder"]["pose_2"])
    head["bias"] = jnp.asarray([1.0, -0.5, 0.5, 2.0, 1.0, 3.0], jnp.float32)
    params["pose_net"]["pose_decoder"] = dict(
        params["pose_net"]["pose_decoder"], pose_2=head)
    return params


@pytest.fixture(scope="module")
def step_pair():
    jcfg, tcfg = _cfgs()
    ds = FakeDataset(num_samples=1, num_cams=jcfg.num_cams,
                     height=jcfg.height, width=jcfg.width,
                     fusion_level=jcfg.fusion_level)
    batch = ds.batch([0])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
    params = _with_motion(params)
    rng = jax.random.PRNGKey(11)

    @jax.jit
    def jax_step(params, stats, batch, rng, step):
        rng = jax.random.fold_in(rng, step)

        def loss_fn(p):
            _, (loss, logs), new_stats = jm.forward(p, stats, batch, rng,
                                                    train=True, step=step)
            return loss, (logs, new_stats)

        grads, (logs, new_stats) = jax.grad(loss_fn, has_aux=True)(params)
        # the tie-break noise, from forward's and total_loss's key splits
        key = jax.random.split(rng)[0]
        noise = []
        for _ in jm.scales:
            key, k1 = jax.random.split(key)
            noise.append(jax.random.normal(
                k1, (1, jm.num_cams, len(jm.frame_ids) - 1, jm.height,
                     jm.width, 1)))
        scalar = {k: v for k, v in logs.items() if v.ndim == 0}
        return (grads, scalar, new_stats, jnp.stack(noise),
                logs["reproj_mask"])

    grads, logs, new_stats, noise, amask = jax_step(
        params, stats, jbatch, rng, jnp.int32(STEP))
    np_params, np_stats, np_grads, np_new_stats = jax.tree_util.tree_map(
        np.asarray, (params, stats, grads, new_stats))

    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, np_params, np_stats)
    # the CPU convolutions round differently on one thread than on several
    # (a few auto-mask pixels flip between the two): a fixed count keeps
    # the comparison the same on every machine
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        _, loss, tlogs = model(batch, step=STEP,
                               noise=torch.from_numpy(np.array(noise)))
        loss.backward()
    finally:
        torch.set_num_threads(threads)
    return dict(jcfg=jcfg, params=params, np_params=np_params,
                grads=grads, np_grads=np_grads,
                logs={k: float(v) for k, v in logs.items()},
                new_stats=np_new_stats, model=model,
                tlogs={k: float(v) for k, v in tlogs.items()
                       if v.dim() == 0},
                amask=(np.asarray(amask),
                       tlogs["reproj_mask"].detach().numpy()))


def test_auto_masks_agree(step_pair):
    want, got = step_pair["amask"]
    assert got.shape == want.shape
    assert 0.1 < want.mean() < 0.9
    assert (got != want).sum() <= 12


MASKED_LOGS = ("reproj_loss", "amask_cover", "spatio_tempo_loss", "total_loss")


def test_loss_and_scalar_logs(step_pair):
    want, got = step_pair["logs"], step_pair["tlogs"]
    assert set(got) == set(want)
    for key, w in want.items():
        tol = 1e-3 if key in MASKED_LOGS else 2e-5
        assert np.isfinite(got[key]), key
        assert abs(got[key] - w) <= tol * max(abs(w), 1e-3), \
            (key, got[key], w)


@pytest.mark.parametrize("net,tol", [("depth_net", 5e-3), ("pose_net", 5e-2)])
def test_gradients(step_pair, net, tol):
    want = _by_port_name({net: step_pair["np_grads"][net]})
    params = dict(step_pair["model"].named_parameters())
    assert set(want) == {k for k in params if k.startswith(net + ".")}
    for name, w in want.items():
        g = params[name].grad
        assert g is not None, name
        g = g.numpy()
        assert np.isfinite(g).all(), name
        norm = np.linalg.norm(w)
        assert norm > 0, name
        assert np.linalg.norm(g - w) <= tol * norm, (
            name, np.linalg.norm(g - w) / norm)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_batchnorm_statistics(step_pair, net):
    want = _by_port_name({net: step_pair["new_stats"][net]})
    bufs = dict(step_pair["model"].named_buffers())
    assert want
    for name, w in want.items():
        got = bufs[name].numpy()
        init = 0.0 if name.endswith("running_mean") else 1.0
        assert np.abs(w - init).max() > 0, name     # the step moved it
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5 * np.abs(
            w).max(), err_msg=name)


def _carried_state(params, seed):
    """An optax Adam state as a mid-run one holds it, after CARRIED_COUNT
    updates: first moments of (and above) this step's gradient size, second
    moments that make each update about lr."""
    rng = np.random.RandomState(seed)
    mu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(1e-3 * rng.randn(*p.shape), jnp.float32), params)
    nu = jax.tree_util.tree_map(
        lambda p: jnp.asarray(1e-8 * (0.5 + rng.rand(*p.shape)), jnp.float32),
        params)
    return optax.ScaleByAdamState(count=jnp.asarray(CARRIED_COUNT, jnp.int32),
                                  mu=mu, nu=nu)


def test_step_from_carried_adam_state(step_pair):
    jcfg, params = step_pair["jcfg"], step_pair["params"]
    tx = jax_make_optimizer(jcfg.learning_rate, jcfg.scheduler_step_size, 0)
    state = (_carried_state(params, 0), optax.EmptyState())

    @jax.jit    # one program: eager optax dispatches ~2k small ops
    def update(grads, state, params):
        return optax.apply_updates(params, tx.update(grads, state, params)[0])

    want = _by_port_name(jax.tree_util.tree_map(
        np.asarray, update(step_pair["grads"], state, params)))

    model = step_pair["model"]
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = create_train_state(model)
    load_optax_adam_state(opt, model,
                          jax.tree_util.tree_map(np.asarray, state))
    for group in opt.param_groups:
        group["lr"] = lr_at(group, CARRIED_COUNT)
    opt.step()
    lr = jcfg.learning_rate
    try:
        worst = 0.0
        for name, p in model.named_parameters():
            moved = np.abs(want[name] - before[name].numpy()).max()
            assert moved > 0.1 * lr, name
            worst = max(worst, np.abs(p.detach().numpy() - want[name]).max())
        assert worst <= 2e-2 * lr, worst / lr
    finally:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(before[name])


@pytest.mark.parametrize("boost", [1.0, 5.0])
def test_optimizer_on_identical_gradients(boost):
    """Adam + StepLR + the pose boost against optax on the same gradients,
    8 updates across the StepLR boundary and the boost's fade."""
    rng = np.random.RandomState(3)
    shapes = {"depth_net": (4, 3), "pose_net": (5,)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-6, 1, s)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(8)]

    tx = jax_make_optimizer(1e-2, 2, 3, pose_boost=boost,
                            boost_fade_start=2, boost_fade_steps=3)
    jp = {k: {"w": jnp.asarray(v)} for k, v in p0.items()}
    st = tx.init(jp)

    class Nets(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.depth_net = torch.nn.ParameterDict(
                {"w": torch.nn.Parameter(torch.from_numpy(p0["depth_net"]))})
            self.pose_net = torch.nn.ParameterDict(
                {"w": torch.nn.Parameter(torch.from_numpy(p0["pose_net"]))})

    nets = Nets()
    opt = make_optimizer(nets, 1e-2, 2, 3, pose_boost=boost,
                         boost_fade_start=2, boost_fade_steps=3)
    moved = {k: 0.0 for k in shapes}
    for count, g in enumerate(grads):
        upd, st = tx.update({k: {"w": jnp.asarray(v)} for k, v in g.items()},
                            st, jp)
        jp = optax.apply_updates(jp, upd)
        for k in shapes:
            moved[k] = moved[k] + np.abs(np.asarray(upd[k]["w"]))
        for group in opt.param_groups:
            group["lr"] = lr_at(group, count)
        for k, v in g.items():
            getattr(nets, k)["w"].grad = torch.from_numpy(v)
        opt.step()
        for k in shapes:
            # optax takes Adam's bias corrections 1 - b**t in f32 (1 - 0.999
            # is 1.3e-5 off there), torch in double: each update agrees to
            # 1e-5 of its size, plus the f32 rounding of the parameter
            got = getattr(nets, k)["w"].detach().numpy()
            want = np.asarray(jp[k]["w"])
            assert (np.abs(got - want) <= 1e-5 * moved[k] + 4 * np.spacing(
                np.abs(want))).all(), (k, count, got - want)


def test_lr_schedule_matches_optax():
    jsched = jax_lr_schedule(1e-4, 15, 4)
    tsched = make_lr_schedule(1e-4, 15, 4)
    for count in (0, 1, 59, 60, 61, 200):    # optax's rate is f32
        assert abs(tsched(count) - float(jsched(count))) <= 1e-7 * tsched(
            count), count
    assert make_lr_schedule(1e-4, 15, 0)(10 ** 6) == 1e-4
