"""The camera axis (``parallel/mesh.py``, JAX's 2-D ``(data, cam)`` mesh)
under the training options that run each net's own back-projection, on
the CPU: gloo ranks of the (data 1, cam 3) grid on the micro 3-camera rig
against the JAX package's unsharded step over the global batch and the
port's own single-process step.

* ``merge_backprojection: false``: each fusion net back-projects its own
  features on the rank's cameras (K1b) and completes its two overlap-group
  sums and count over the cam group, 4 cam-group all-reduces a step;
* ``batch_pose_frames: false`` (frames 0, -1, 1): the pose net's passes
  each back-project and sum, 2 x 2 + 2 = 6;
* ``merge_backprojection: false`` under ``remat: true``: the nets' halves
  are checkpointed, the cam-group sums between them are not, so the
  recompute repeats BatchNorm's all-reduces (twice the single step's) and
  no cam-group sum; held against the single-process remat step only.

JAX's 2-D step is one program over the global batch whose cameras GSPMD
splits, so it equals ``build_train_step`` at the global batch; it runs once
per option (the remat variant shares the plain one's), jitted
(``helpers_torch_step.jax_step``), from the flax init with the grid's
ego-motion (``test_torch_cam_parallel.py``'s ``MOTION``); the batch is
``helpers_torch_cam_options.global_batch`` (the first samples of
FakeDataset, one a data shard, two for the unbatched pose frames; the rig
yawed by 0.1 rad). One spawn runs every option of the grid
(``helpers_torch_cam_options.run_rank``), each rank on one thread.
``tests/test_torch_cam_parallel_fsm_aug.py`` holds the options of the
(2, 2) grid with the same checks (``prepare_grid`` and the ``check_*``
functions here).

The reprojection term's discrete choices: a pixel whose auto-mask
comparison (reprojection against identity) or best context frame ties
within f32 rounding flips between two steps that differ in rounding
alone, and one flip moves the masked logs by ~1e-4 and a gradient by up to
~1e-2. So the port's single-process forward runs first as a probe
(``_probe``), and its auto-masks, with every pixel within ``TIE_MARGIN``
of a tie in either choice left out, are imposed on JAX's step, the port's
single-process step and the grid's ranks
(``helpers_torch_parallel.impose_auto_masks``). Each side's own masks are
held against the probe's apart (``test_auto_masks_agree``): at most
``MAX_FLIPS`` of the pixels kept differ (a warp's validity at the image's
edge can move a pixel's comparison past any margin).

JAX's BatchNorm takes flax's exact variance here (``use_fast_variance``
off: E[(x - E[x])^2]), as the port does in one process and over ranks
(``models/blocks.py``): flax's default E[x^2] - E[x]^2 cancels in f32
where a channel's mean dwarfs its spread, which moved a gradient of the
mixed pair's depth net 6.4e-3 (relative L2) from the port's, over the
5e-3 bound; with the exact variance 1.4e-5.

Bounds: tests/test_torch_parallel.py's, for its reasons (see
tests/test_torch_cam_parallel.py): against JAX, logs 2e-5 of their
magnitude (1e-3 for the four over the auto-mask), gradients 5e-3 / 5e-2
relative L2 (depth / pose net), BatchNorm statistics 1e-5; against the
port's single-process step, logs 2e-6 (3e-4), gradients 2e-3, parameters
after Adam 2e-3 of the learning rate, BatchNorm statistics 1e-5. The ranks
end bit-identical.
"""
import functools
import shutil
import time

import numpy as np
import flax.linen.normalization as flax_normalization
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

import helpers_torch_cam_options as H
import helpers_torch_parallel as P
from helpers_torch_step import (MASKED_LOGS, by_port_name, jax_noise,
                                jax_step, with_motion)
from helpers_torch_synthesis import jax_aug_draw
from helpers_torch_threads import fixed_threads, port_threads  # noqa: F401
from test_torch_cam_parallel import _check_against_single
from test_torch_parallel import (JAX_GRAD_TOL, JAX_LOG_TOL, JAX_MASKED_TOL,
                                 TIE_MARGIN)
from vfdepth_tpu import presets as jpresets
from vfdepth_tpu.losses import auto_mask as jax_composite_auto_mask
from vfdepth_tpu.losses import composite as jax_composite
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.losses import auto_mask as port_auto_mask
from vfdepth_tpu_torch.losses import composite as port_composite
from vfdepth_tpu_torch.losses import photometric_loss
from vfdepth_tpu_torch.parallel import COUNTS, reduce_logs
from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                        train_step)
from vfdepth_tpu_torch.weights import load_flax_params

jax.config.update("jax_platforms", "cpu")
RANK_DEADLINE_S = 420
GRID = "1x3"
# options that share another's weights, draws, masks and JAX step (the
# same nets), held against the port's single-process step only
SHARED = {"unmerged_remat": "unmerged"}
# a pixel where one of the reprojection term's two choices (reprojection
# against identity: the auto-mask; the best context frame against the
# next) lies within TIE_MARGIN (test_torch_parallel.py's) of a tie in the
# probe is left out of every side's loss; at most MAX_EXCLUDED of the
# pixels are (0.16-1.45% measured, pixels whose context frames both warp
# from outside the image among them)
MAX_EXCLUDED = 0.02
# the pixels kept whose own auto-mask may differ from the probe's on JAX's
# side or the grid's (none measured, of 6,144-73,728)
MAX_FLIPS = 8


def _probe(model, batch, noise, aug_u):
    """The port's single-process training forward as it runs, keeping
    each scale's auto-mask and its two choices' margins -> (the masks to
    impose on every side: the auto-mask with each pixel within
    ``TIE_MARGIN`` of a tie zeroed; the probe's own masks; the pixels
    kept), each [n_scales, b, cams, H, W, 1]."""
    masks, auto_margin, frame_margin = [], [], []
    real_loss = port_composite.reprojection_loss

    def auto_mask(reproj, ident):
        auto_margin.append((reproj - ident).abs())
        masks.append(port_auto_mask(reproj, ident))
        return masks[-1]

    def reprojection_loss(noise, target, context, warped, *args, **kwargs):
        per_frame = photometric_loss(
            warped, target[:, :, None].expand_as(warped))
        if per_frame.shape[2] > 1:
            two = per_frame.topk(2, dim=2, largest=False).values
            frame_margin.append(two[:, :, 1] - two[:, :, 0])
        else:
            frame_margin.append(torch.full_like(per_frame[:, :, 0], np.inf))
        return real_loss(noise, target, context, warped, *args, **kwargs)

    with (fixed_threads(), torch.no_grad(),
          pytest.MonkeyPatch.context() as patch):
        patch.setattr(port_composite, "auto_mask", auto_mask)
        patch.setattr(port_composite, "reprojection_loss", reprojection_loss)
        model(batch, step=H.STEP, noise=noise, aug_u=aug_u)
    own = torch.stack(masks).numpy()
    keep = ((torch.stack(auto_margin) > TIE_MARGIN)
            & (torch.stack(frame_margin) > TIE_MARGIN)).numpy()
    return own * keep, own, keep


def _jax_step_imposed(jm, params, stats, jbatch, masks):
    """JAX's step (``jax_step``) with ``masks`` imposed as its auto-masks
    and BatchNorm on flax's exact variance -> (jax_step's outputs, JAX's
    own masks [n_scales, b, cams, H, W, 1])."""
    own, calls, n = {}, [], len(masks)

    def keep(k, mask):
        own[k] = np.asarray(mask)

    def imposed(reproj, ident):
        k = len(calls) % n
        calls.append(k)
        jax.debug.callback(functools.partial(keep, k),
                           jax_composite_auto_mask(reproj, ident))
        return jnp.asarray(masks[k])

    real_stats = flax_normalization._compute_stats
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_composite, "auto_mask", imposed)
        patch.setattr(flax_normalization, "_compute_stats",
                      lambda *a, **k: real_stats(
                          *a, **{**k, "use_fast_variance": False}))
        out = jax_step(jm, params, stats, jbatch, H.STEP)
    assert sorted(own) == list(range(n)), sorted(own)
    return out, np.stack([own[k] for k in range(n)])


def _single_step(model, batch, noise, aug_u, masks):
    """The port's step at the global batch in this process (no group, so
    no collective may run), ``masks`` imposed: logs, gradients, state
    after Adam, its own auto-masks."""
    before = dict(COUNTS)
    imposed = P.impose_auto_masks(masks)
    with fixed_threads(), pytest.MonkeyPatch.context() as patch:
        patch.setattr(port_composite, "auto_mask", imposed)
        opt = create_train_state(model)
        P.carry_adam_state(opt, model)
        logs = train_step(model, opt, batch, H.STEP, torch.Generator(),
                          noise=noise, aug_u=aug_u)
    return dict(logs=reduce_logs(logs), state=model.state_dict(),
                grads={n: p.grad for n, p in model.named_parameters()},
                collectives=dict(COUNTS) != before,
                own_masks=torch.stack(imposed.own).numpy())


def _spawn(name, work):
    ctx = mp.spawn(H.run_rank, args=(name, str(work)), nprocs=H.world(name),
                   join=False)
    deadline = time.monotonic() + RANK_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"the {name} ranks did not end in {RANK_DEADLINE_S} s")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(H.world(name))]
    shutil.rmtree(work)
    return ranks


def prepare_grid(name, work):
    """Every option of grid ``name``: the port's probe (``_probe``) for the
    masks to impose, the JAX step at the global batch (unless the option
    shares another's), the port's single-process step from the same
    weights, noise, rotated-view draw and masks, then one spawn of the
    grid's ranks running every option. -> {option: dict(jax, amask,
    single, ranks, lr)}."""
    inputs, out = {}, {}
    for option in H.grid_options(name):
        tcfg = H.option_config(option, cam_parallel=False)
        batch = H.global_batch(option)
        if option in SHARED:
            weights, draws, amask = out[SHARED[option]]["inputs"]
            jax_ref = None
        else:
            jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
            jcfg = H.option_config(option, cam_parallel=False,
                                   make=jpresets.micro_config)
            jm = JaxModel(jcfg)
            params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
            params = with_motion(params, H.motion(option))
            weights = jax.tree_util.tree_map(np.asarray, (params, stats))
            rng = jax.random.fold_in(jax.random.PRNGKey(11), H.STEP)
            aug_u = (torch.from_numpy(jax_aug_draw(rng, *batch[
                "extrinsics"].shape[:2])) if tcfg.aug_depth else None)
            noise = np.array(jax_noise(jm, len(batch["color/0/0"]), rng))
            draws = (torch.from_numpy(noise), aug_u)
            probe = VFDepthModel(tcfg, device="cpu")
            load_flax_params(probe, *weights)
            amask = dict(zip(("imposed", "probe", "keep"),
                             _probe(probe, batch, *draws)))
            (np_grads, jlogs, new_stats, jnoise, _), own = _jax_step_imposed(
                jm, params, stats, jbatch, amask["imposed"])
            assert np.array_equal(jnoise, noise)
            jax_ref = dict(logs={k: float(v) for k, v in jlogs.items()},
                           grads=np_grads, stats=new_stats, own_masks=own)
        model = VFDepthModel(tcfg, device="cpu")
        load_flax_params(model, *weights)
        # the starting state (the single step below moves it in place)
        inputs[option] = dict(state={k: v.clone() for k, v in
                                     model.state_dict().items()},
                              batch=batch, noise=draws[0], aug_u=draws[1],
                              amask=torch.from_numpy(amask["imposed"]))
        out[option] = dict(jax=jax_ref, inputs=(weights, draws, amask),
                           amask=amask, lr=tcfg.learning_rate,
                           single=_single_step(model, batch, *draws,
                                               amask["imposed"]))
    torch.save(inputs, work / "inputs.pt")
    ranks = _spawn(name, work)
    for option in out:
        out[option]["ranks"] = [r[option] for r in ranks]
        del out[option]["inputs"]
    return out


def _grid_masks(ranks, like):
    """The ranks' own auto-masks placed at their rows and cameras, each
    place filled once."""
    masks, filled = np.zeros_like(like), np.zeros(like.shape[1:3], int)
    for out in ranks:
        d, c = out["place"]
        own = out["own_masks"].numpy()
        masks[:, d:d + own.shape[1], c:c + own.shape[2]] = own
        filled[d:d + own.shape[1], c:c + own.shape[2]] += 1
    assert (filled == 1).all(), filled
    return masks


def check_auto_masks(run, jax_ref=None):
    """The single process's own auto-masks are the probe's; JAX's
    (``jax_ref``'s where the option shares another's JAX step) and the
    grid's differ from them on at most ``MAX_FLIPS`` of the pixels kept;
    the probe's masks cover some pixels and leave some; at most
    ``MAX_EXCLUDED`` of the pixels are left out as ties."""
    probe, keep = run["amask"]["probe"], run["amask"]["keep"]
    assert 0.05 < probe.mean() < 0.95, probe.mean()
    assert 1 - keep.mean() <= MAX_EXCLUDED, 1 - keep.mean()
    jax_own = (jax_ref or run["jax"])["own_masks"]
    assert (run["single"]["own_masks"] == probe).all()
    for side, own in (("jax", jax_own),
                      ("grid", _grid_masks(run["ranks"], probe))):
        assert own.shape == probe.shape, side
        flips = int((own != probe)[keep].sum())
        assert flips <= MAX_FLIPS, (side, flips)


def check_collectives(run, option):
    """The option's cam-group sums and gathers (``H.SITES``) and the
    loss's world sums on every rank, BatchNorm's sums, one gradient
    bucket, the set-up broadcast; no other camera-axis site; one process
    takes none."""
    want = H.SITES[option]
    for r, out in enumerate(run["ranks"]):
        counts = out["counts"]
        for site in ("cam_fusion", "cam_poses", "cam_depths", "loss"):
            assert counts.get(site, 0) == want.get(site, 0), (r, counts)
        assert counts["gradients"] == 1, (r, counts)
        assert counts["batch_norm"] > 0 and counts["broadcast"] > 0
    assert not run["single"]["collectives"]


def check_ranks_bit_identical(run):
    r0 = run["ranks"][0]
    assert r0["digests"] == (P.digest(r0["grads"]), P.digest(r0["state"]))
    for out in run["ranks"][1:]:
        assert out["digests"] == r0["digests"]
        assert out["logs"] == r0["logs"]


def check_logs_against_jax(run):
    want = run["jax"]["logs"]
    assert want["spatio_loss"] > 0 and want["spatio_tempo_loss"] > 0
    for r, out in enumerate(run["ranks"]):
        got = out["logs"]
        assert set(got) == set(want)
        for key, w in want.items():
            tol = JAX_MASKED_TOL if key in MASKED_LOGS else JAX_LOG_TOL
            assert np.isfinite(got[key]), key
            assert abs(got[key] - w) <= tol * max(abs(w), 1e-3), (
                r, key, got[key], w)


def check_gradients_against_jax(run, net):
    want = by_port_name({net: run["jax"]["grads"][net]})
    got = run["ranks"][0]["grads"]
    assert set(want) == {k for k in got if k.startswith(net + ".")}
    for name, w in want.items():
        g = got[name].numpy()
        assert np.isfinite(g).all(), name
        norm = np.linalg.norm(w)
        assert norm > 0, name
        assert np.linalg.norm(g - w) <= JAX_GRAD_TOL[net] * norm, (
            name, np.linalg.norm(g - w) / norm)


def check_batchnorm_against_jax(run, net):
    """Every BatchNorm statistic moved as JAX's over the global batch and
    every camera."""
    want = by_port_name({net: run["jax"]["stats"][net]})
    got = run["ranks"][0]["state"]
    assert want
    for name, w in want.items():
        init = 0.0 if name.endswith("running_mean") else 1.0
        assert np.abs(w - init).max() > 0, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def check_against_single(run):
    _check_against_single(run["ranks"][0], run["single"], run["lr"])


OPTIONS = H.grid_options(GRID)
JAX_HELD = [o for o in OPTIONS if o not in SHARED]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return prepare_grid(GRID, tmp_path_factory.mktemp(f"cam_opt_{GRID}"))


@pytest.mark.parametrize("option", OPTIONS)
def test_collectives_by_site(grid, option):
    check_collectives(grid[option], option)


def test_remat_recomputes_no_cam_group_sum(grid):
    """Under ``remat`` the checkpointed encoders recompute BatchNorm's
    all-reduces in the backward pass (twice the plain step's) and the
    cam-group sums, outside the checkpointed calls, run once; the step is
    the plain unmerged step's, bit for bit."""
    plain, remat = grid["unmerged"]["ranks"], grid["unmerged_remat"]["ranks"]
    for a, b in zip(plain, remat):
        assert b["counts"]["batch_norm"] == 2 * a["counts"]["batch_norm"]
        assert b["counts"]["cam_fusion"] == a["counts"]["cam_fusion"] == 4
        assert b["digests"] == a["digests"]


@pytest.mark.parametrize("option", OPTIONS)
def test_auto_masks_agree(grid, option):
    check_auto_masks(grid[option], grid[SHARED.get(option, option)]["jax"])


@pytest.mark.parametrize("option", OPTIONS)
def test_ranks_bit_identical(grid, option):
    check_ranks_bit_identical(grid[option])


@pytest.mark.parametrize("option", OPTIONS)
def test_step_against_single_process(grid, option):
    check_against_single(grid[option])


@pytest.mark.parametrize("option", JAX_HELD)
def test_step_logs_against_jax(grid, option):
    check_logs_against_jax(grid[option])


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
@pytest.mark.parametrize("option", JAX_HELD)
def test_step_gradients_against_jax(grid, option, net):
    check_gradients_against_jax(grid[option], net)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
@pytest.mark.parametrize("option", JAX_HELD)
def test_step_batchnorm_against_jax(grid, option, net):
    check_batchnorm_against_jax(grid[option], net)
