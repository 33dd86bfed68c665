"""One training step of the JAX package and of the port from the same
weights, batch and tie-break noise, for the step parity tests of the port
(``tests/test_torch_three_cam.py``, ``test_torch_unmerged.py``,
``test_torch_pose_frames.py``, ``test_torch_mixed_three_cam.py``).

The JAX step is ``forward(train=True)`` + ``jax.grad`` under ``jax.jit``;
its noise comes from the same key splits as ``forward`` / ``total_loss`` and
is handed to the port, which runs the plain versions of its kernels on the
CPU (on a fixed ``PORT_THREADS``, 2: the CPU convolutions round
differently on one thread than on several, and the auto-mask sees it).
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.training import VFDepthModel
from vfdepth_tpu_torch.weights import (_leaves, _to_torch_layout, _torch_name,
                                       load_flax_params)
from helpers_torch_threads import PORT_THREADS

MASKED_LOGS = ("reproj_loss", "amask_cover", "spatio_tempo_loss", "total_loss")


def by_port_name(tree):
    return {_torch_name(path): _to_torch_layout(path[-1], value)
            for path, value in _leaves(tree)}


def with_motion(params, translation=(2.0, 1.0, 3.0)):
    """A pose-head bias of a real ego-motion (0.01 rad, and 0.01 m per unit
    of ``translation``): at the flax init every temporal warp is near the
    identity, and the auto-mask compares two losses that tie to ~1e-5."""
    params = jax.tree_util.tree_map(lambda a: a, params)
    head = dict(params["pose_net"]["pose_decoder"]["pose_2"])
    head["bias"] = jnp.asarray([1.0, -0.5, 0.5, *translation], jnp.float32)
    params["pose_net"]["pose_decoder"] = dict(
        params["pose_net"]["pose_decoder"], pose_2=head)
    return params


def jax_noise(jm, b: int, rng):
    """The standard normals of JAX's identity-loss tie-break in a training
    step whose key is ``rng`` (already folded with the step): [n_scales,
    b, cams, n_ctx, H, W, 1], one key split per scale."""
    key = jax.random.split(rng)[0]
    noise = []
    for _ in jm.scales:
        key, k1 = jax.random.split(key)
        noise.append(jax.random.normal(
            k1, (b, jm.num_cams, len(jm.frame_ids) - 1, jm.height,
                 jm.width, 1)))
    return jnp.stack(noise)


def jax_step(jm, params, stats, jbatch, step: int = 3,
             compiler_options=None):
    """One JAX training step (``forward(train=True)`` + ``jax.grad``),
    jitted once: numpy (gradients, scalar logs, BatchNorm statistics,
    tie-break noise, auto-mask). ``compiler_options`` go to XLA's compile
    (the mixed-precision tests turn excess precision off)."""
    b = jbatch["color/0/0"].shape[0]

    def fn(params, stats, batch, rng, step):
        rng = jax.random.fold_in(rng, step)

        def loss_fn(p):
            _, (loss, logs), new_stats = jm.forward(p, stats, batch, rng,
                                                    train=True, step=step)
            return loss, (logs, new_stats)

        grads, (logs, new_stats) = jax.grad(loss_fn, has_aux=True)(params)
        scalar = {k: v for k, v in logs.items() if v.ndim == 0}
        return (grads, scalar, new_stats, jax_noise(jm, b, rng),
                logs["reproj_mask"])

    args = (params, stats, jbatch, jax.random.PRNGKey(11), jnp.int32(step))
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options=compiler_options)
    return jax.tree_util.tree_map(np.asarray, compiled(*args))


def port_step(model, batch, noise, step: int = 3):
    """The port's training forward and backward on the CPU, on a fixed
    ``PORT_THREADS`` threads: (scalar logs, auto-mask); the gradients stay
    on ``model``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        _, loss, tlogs = model(batch, step=step,
                               noise=torch.from_numpy(np.array(noise)))
        loss.backward()
    finally:
        torch.set_num_threads(threads)
    return ({k: float(v.detach()) for k, v in tlogs.items() if v.dim() == 0},
            tlogs["reproj_mask"].detach().numpy())


def step_pair(jcfg, tcfg, batch, step: int = 3,
              translation=(2.0, 1.0, 3.0)):
    """The JAX step's gradients, scalar logs, BatchNorm statistics and
    auto-mask beside the port's, from the flax init (with ``with_motion``)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
    params = with_motion(params, translation)
    np_grads, logs, np_new_stats, noise, amask = jax_step(
        jm, params, stats, jbatch, step)
    np_params, np_stats = jax.tree_util.tree_map(np.asarray, (params, stats))

    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, np_params, np_stats)
    tlogs, tmask = port_step(model, batch, noise, step)
    return dict(np_grads=np_grads, new_stats=np_new_stats, model=model,
                logs={k: float(v) for k, v in logs.items()}, tlogs=tlogs,
                amask=(amask, tmask), weights=(np_params, np_stats))


def check_logs(pair, masked_tol: float, tol: float = 2e-5):
    want, got = pair["logs"], pair["tlogs"]
    assert set(got) == set(want)
    for key, w in want.items():
        t = masked_tol if key in MASKED_LOGS else tol
        assert np.isfinite(got[key]), key
        assert abs(got[key] - w) <= t * max(abs(w), 1e-3), (key, got[key], w)


def check_gradients(pair, net: str, tol: float):
    """Each parameter's gradient within ``tol`` relative L2 error."""
    want = by_port_name({net: pair["np_grads"][net]})
    params = dict(pair["model"].named_parameters())
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


def check_batchnorm(pair, net: str, tol: float = 1e-5):
    want = by_port_name({net: pair["new_stats"][net]})
    bufs = dict(pair["model"].named_buffers())
    assert want
    for name, w in want.items():
        got = bufs[name].numpy()
        init = 0.0 if name.endswith("running_mean") else 1.0
        assert np.abs(w - init).max() > 0, name     # the step moved it
        np.testing.assert_allclose(got, w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=name)
