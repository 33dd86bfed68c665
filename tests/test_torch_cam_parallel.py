"""Camera-axis model parallelism of the port (``parallel/mesh.py``, JAX's
2-D ``(data, cam)`` mesh) on the CPU: gloo ranks of two grids against the
JAX package's unsharded step over the global batch and the port's own
single-process step.

JAX's 2-D step is one program over the global batch whose cameras GSPMD
splits, so it equals ``build_train_step`` at the global batch; that step
runs once per grid in this process, jitted (``helpers_torch_step.
jax_step``), from the flax init with a real ego-motion. The grids:

* ``1x3``: (data 1, cam 3) on the micro 3-camera rig, JAX's own grid
  (``tests/test_train_integration.py:218``), batch 1: one camera a rank,
  the overlap groups ([0], [1, 2]) split one member a rank;
* ``2x2``: (data 2, cam 2) on the 6-camera rig at micro widths, batch 1 a
  data shard (global batch 2): both axes above 1, and the overlap groups
  ([0, 3, 4], [1, 2, 5]) split unevenly, {0} | {1, 2} and {3, 4} | {5}.

Both on ``FakeDataset``'s "nuscenes" rig at the focal-length scale 15,
where the overlap losses are live, with an ego-motion per grid
(``helpers_torch_cam_parallel.MOTION``) that keeps the auto-mask off its
ties. One spawn runs every rank-side check
of a grid (``helpers_torch_cam_parallel.run_rank``), each rank on one
thread, with a ``FileStore`` under ``tmp_path``; the parent kills the
ranks and fails if they do not end in ``RANK_DEADLINE_S``.

Bounds: tests/test_torch_parallel.py's (PR 13's), for its reasons. Against
JAX, loss and scalar logs 2e-5 of their magnitude (1e-3 for the four that
average over the auto-mask), gradients 5e-3 / 5e-2 relative L2 (depth /
pose net), BatchNorm statistics 1e-5; against the port's single-process
step (the same function, the f32 sums in another order: the cam group's
sum of partial group sums, the loss's assembled per-camera vectors, the
global BatchNorm's sums over the ranks), the self-bounds: logs 2e-6 (3e-4
where they see the auto-mask), gradients 2e-3, BatchNorm statistics 1e-5,
parameters after Adam from a carried state 2e-3 of the learning rate. The
ranks end bit-identical.
"""
import shutil
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

import helpers_torch_cam_parallel as H
import helpers_torch_parallel as P
from helpers_torch_step import (MASKED_LOGS, by_port_name, jax_step,
                                with_motion)
from helpers_torch_threads import fixed_threads, port_threads  # noqa: F401
from test_torch_parallel import (JAX_GRAD_TOL, JAX_LOG_TOL, JAX_MASKED_TOL,
                                 SELF_GRAD_TOL, SELF_LOG_TOL,
                                 SELF_MASKED_TOL, SELF_PARAM_TOL,
                                 SELF_STATS_TOL)
from vfdepth_tpu import presets as jpresets
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.parallel import COUNTS, mesh, reduce_logs
from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                        train_step)
from vfdepth_tpu_torch.weights import load_flax_params

jax.config.update("jax_platforms", "cpu")
RANK_DEADLINE_S = 420
GRID_NAMES = sorted(H.GRIDS)


def _spawn(name, work):
    """Run grid ``name``'s ranks; their results. The work directory is
    emptied (checkpoints of two ResNet-18 encoders are ~270 MB each)."""
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
    files = sorted(str(p.relative_to(work)) for p in work.rglob("*")
                   if p.is_file() and p.parts[len(work.parts)] in (
                       "loop", "cli"))
    shutil.rmtree(work)
    return ranks, files


def _single_step(model, batch, noise):
    """The port's step at the global batch in this process (no group, so
    no collective may run): logs, gradients, state after Adam."""
    before = dict(COUNTS)
    with fixed_threads():
        opt = create_train_state(model)
        P.carry_adam_state(opt, model)
        logs = train_step(model, opt, batch, H.STEP, torch.Generator(),
                          noise=noise)
    return dict(logs=reduce_logs(logs), state=model.state_dict(),
                grads={n: p.grad for n, p in model.named_parameters()},
                collectives=dict(COUNTS) != before)


def _run_grid(name, work):
    data, cam, cams, _ = H.GRIDS[name]
    jcfg = jpresets.micro_config(cameras=list(cams))
    jcfg.set("focal_length_scale", 15.0)
    tcfg = H.step_config(name, cam_parallel=False)
    perm, indices = H.global_indices(name)
    batch = H.dataset(name, tcfg).batch(indices)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
    params = with_motion(params, H.MOTION[name])
    np_grads, jlogs, new_stats, noise, _ = jax_step(jm, params, stats,
                                                    jbatch, H.STEP)
    np_params, np_stats = jax.tree_util.tree_map(np.asarray, (params, stats))
    noise = torch.from_numpy(np.array(noise))

    def loaded(cfg):
        model = VFDepthModel(cfg, device="cpu")
        load_flax_params(model, np_params, np_stats)
        return model
    model = loaded(tcfg)
    torch.save(dict(state=model.state_dict(), noise=noise),
               work / "inputs.pt")
    single = _single_step(model, batch, noise)
    out = dict(name=name, single=single, noise=noise, perm=perm,
               batch=batch, lr=tcfg.learning_rate, jax=dict(
                   logs={k: float(v) for k, v in jlogs.items()},
                   grads=np_grads, stats=new_stats))
    if name == "2x2":
        wcfg = H.step_config(name, cam_parallel=False)
        wcfg.set("warp_window_hw", H.FORCED_HW, section="tpu")
        out["windowed_single"] = _single_step(loaded(wcfg), batch, noise)
        sizing = VFDepthModel(H.window_config(name), device="cpu")
        both = [H.window_batch(name, d) for d in range(data)]
        sizing.configure_warp_window(
            {k: np.concatenate([b[k] for b in both])
             for k in ("K/0", "extrinsics")},
            rigs=H.dataset(name, H.window_config(name), 2).rig_calibrations())
        out["sized_windows"] = (sizing.warp_window, sizing.warp_window_hw)
    out["ranks"], out["files"] = _spawn(name, work)
    return out


@pytest.fixture(scope="module")
def grid_1x3(tmp_path_factory):
    return _run_grid("1x3", tmp_path_factory.mktemp("cam_1x3"))


@pytest.fixture(scope="module")
def grid_2x2(tmp_path_factory):
    return _run_grid("2x2", tmp_path_factory.mktemp("cam_2x2"))


@pytest.fixture(params=GRID_NAMES)
def runs(request):
    return request.getfixturevalue(f"grid_{request.param}")


def test_grid_layout(runs):
    """Rank r sits at (d, c) = divmod(r, cam) with the cameras [c*k,
    (c+1)*k); its cam group is the ranks of its d, its data group those of
    its c, its loader shard (d, data); a cam-group sum of (rank + 1)
    weighted by (rank + 1) has the group's sum as value and gradient."""
    data, cam, cams, _ = H.GRIDS[runs["name"]]
    k = len(cams) // cam
    for r, out in enumerate(runs["ranks"]):
        g = out["grid"]
        d, c = divmod(r, cam)
        assert mesh.grid_coords(r, cam) == (d, c) == g["coords"]
        assert g["data_cam"] == (data, cam)
        assert g["local_cams"] == slice(c * k, (c + 1) * k)
        assert g["loader"] == (d, data)
        assert g["cam_group"] == [d * cam + j for j in range(cam)]
        assert g["data_group"] == [i * cam + c for i in range(data)]
        group_sum = float(sum(j + 1 for j in g["cam_group"]))
        assert torch.equal(g["sum_value"], torch.full((3,), group_sum))
        assert torch.equal(g["sum_grad"], torch.full((3,), group_sum))


def test_loader_shards(runs):
    """The ranks of one cam group read the same batch, their data shard's
    first; the data shards partition the epoch, in order the global
    batch."""
    data, cam = H.GRIDS[runs["name"]][:2]
    ranks = runs["ranks"]
    shards = [ranks[d * cam]["epoch_indices"] for d in range(data)]
    assert np.array_equal(np.concatenate(shards), runs["perm"])
    for r, out in enumerate(ranks):
        d = r // cam
        assert np.array_equal(out["epoch_indices"], shards[d])
        for key, value in runs["batch"].items():
            assert np.array_equal(out["batch"][key], value[d:d + 1]), key


def test_step_noise_slices(runs):
    """Each rank's forward got the global tie-break noise's slice of its
    data shard (axis 1) and of its cameras (axis 2)."""
    data, cam, cams, _ = H.GRIDS[runs["name"]]
    k = len(cams) // cam
    for r, out in enumerate(runs["ranks"]):
        d, c = divmod(r, cam)
        assert torch.equal(out["noise"],
                           runs["noise"][:, d:d + 1, c * k:(c + 1) * k])


def test_collectives_by_site(runs):
    """A step takes two cam-group all-reduces, of the back-projection's
    group sums and of its count (forward; their backward sums the
    cotangents), seven world sums in the
    loss (num and den of three masked means, the smoothness's batch
    means), BatchNorm's sums, one gradient bucket; one process takes
    none."""
    for r, out in enumerate(runs["ranks"]):
        counts = out["counts"]
        assert counts["cam_fusion"] == 2, (r, counts)
        assert counts["loss"] == 7 and counts["gradients"] == 1, (r, counts)
        assert counts["batch_norm"] > 0 and counts["broadcast"] > 0
    assert not runs["single"]["collectives"]


def test_step_logs_against_jax(runs):
    want = runs["jax"]["logs"]
    assert want["spatio_loss"] > 0 and want["spatio_tempo_loss"] > 0
    for r, out in enumerate(runs["ranks"]):
        got = out["logs"]
        assert set(got) == set(want)
        for key, w in want.items():
            tol = JAX_MASKED_TOL if key in MASKED_LOGS else JAX_LOG_TOL
            assert np.isfinite(got[key]), key
            assert abs(got[key] - w) <= tol * max(abs(w), 1e-3), (
                r, key, got[key], w)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_gradients_against_jax(runs, net):
    want = by_port_name({net: runs["jax"]["grads"][net]})
    got = runs["ranks"][0]["grads"]
    assert set(want) == {k for k in got if k.startswith(net + ".")}
    for name, w in want.items():
        g = got[name].numpy()
        assert np.isfinite(g).all(), name
        norm = np.linalg.norm(w)
        assert norm > 0, name
        assert np.linalg.norm(g - w) <= JAX_GRAD_TOL[net] * norm, (
            name, np.linalg.norm(g - w) / norm)


@pytest.mark.parametrize("net", ["depth_net", "pose_net"])
def test_step_batchnorm_against_jax(runs, net):
    """Every BatchNorm statistic (all in the encoders, per-camera stages:
    ``test_batchnorm_only_in_per_camera_stages``) moved as JAX's over the
    global batch and every camera."""
    want = by_port_name({net: runs["jax"]["stats"][net]})
    got = runs["ranks"][0]["state"]
    assert want
    for name, w in want.items():
        init = 0.0 if name.endswith("running_mean") else 1.0
        assert np.abs(w - init).max() > 0, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def _check_against_single(got, want, lr):
    for key, w in want["logs"].items():
        tol = SELF_MASKED_TOL if key in MASKED_LOGS else SELF_LOG_TOL
        assert abs(got["logs"][key] - w) <= tol * max(abs(w), 1e-3), (
            key, got["logs"][key], w)
    assert set(got["grads"]) == set(want["grads"])
    for name, w in want["grads"].items():
        norm = w.norm()
        assert norm > 0, name
        assert (got["grads"][name] - w).norm() <= SELF_GRAD_TOL * norm, (
            name, ((got["grads"][name] - w).norm() / norm).item())
    params = set(want["grads"])
    for name, w in want["state"].items():
        g = got["state"][name]
        if name in params:
            assert (g - w).abs().max() <= SELF_PARAM_TOL * lr, name
        elif not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(
                g, w, rtol=SELF_STATS_TOL,
                atol=SELF_STATS_TOL * w.abs().max().item(), msg=name)


def test_step_against_single_process(runs):
    """Logs, gradients, parameters after Adam and BatchNorm statistics of
    the grid's step against the port's step at the global batch in one
    process."""
    _check_against_single(runs["ranks"][0], runs["single"], runs["lr"])


def test_ranks_bit_identical(runs):
    """Every rank holds the same gradients, parameters, statistics (their
    digests: names, shapes and bits) and logs."""
    r0 = runs["ranks"][0]
    assert r0["digests"] == (P.digest(r0["grads"]), P.digest(r0["state"]))
    for out in runs["ranks"][1:]:
        assert out["digests"] == r0["digests"]
        assert out["logs"] == r0["logs"]


def test_batchnorm_only_in_per_camera_stages():
    """Every BatchNorm layer is in an encoder, which runs per camera on
    this rank's cameras (a disjoint set of (sample, camera) pairs on each
    rank), so the world's sum of its statistics is the global batch's. The
    voxel stages, replicated over a cam group, hold none that would count
    the group's copies as extra samples. So for every pair of nets: the
    fsm nets (``MonoDepthNet``, ``MonoPoseNet``) run whole on this rank's
    cameras, and their decoders hold none either."""
    for depth_model in ("fusion", "fsm"):
        for pose_model in ("fusion", "fsm"):
            model = VFDepthModel(presets.micro_config(
                depth_model=depth_model, pose_model=pose_model),
                device="cpu")
            names = [n for n, m in model.named_modules()
                     if isinstance(m, torch.nn.BatchNorm2d)]
            assert any(n.startswith("depth_net.") for n in names)
            assert any(n.startswith("pose_net.") for n in names)
            assert all(n.startswith(("depth_net.encoder.",
                                     "pose_net.encoder."))
                       for n in names), (depth_model, pose_model, names)


def test_windowed_step(grid_2x2):
    """The step with the warp windows on (``tpu.warp_window_hw`` forced to
    16x32 boxes, placed per step from each rank's targets and the rig's
    sources) against the single-process windowed step; the ranks end
    bit-identical. ``configure_warp_window`` at 128x256 sizes the boxes
    over the global first batch, gathered over the data group: its spread
    of focal lengths turns the windows off on every rank, where data shard
    0's batch alone would size boxes."""
    ranks = grid_2x2["ranks"]
    got = ranks[0]["windowed"]
    assert got["windows"] == (True, (((16, 32), (16, 32)),) * 2)
    assert got["logs"]["warp_window_overflow"] > 0
    _check_against_single(got, grid_2x2["windowed_single"], grid_2x2["lr"])
    for out in ranks[1:]:
        assert out["windowed"]["digests"] == got["digests"]
    sized = grid_2x2["sized_windows"]
    assert sized == (False, None)
    for out in ranks:
        assert out["sized_windows"] == sized
    alone = VFDepthModel(H.window_config("2x2"), device="cpu")
    alone.configure_warp_window(
        H.window_batch("2x2", 0),
        rigs=H.dataset("2x2", H.window_config("2x2"), 2).rig_calibrations())
    assert alone.warp_window and alone.warp_window_hw is not None


def test_training_loop(grid_1x3):
    """``Trainer.learn`` builds the grid from ``tpu.cam_parallel_size`` and
    trains 2 steps through the camera axis; only rank 0 writes files; the
    ranks end bit-identical."""
    ranks = grid_1x3["ranks"]
    for out in ranks:
        assert out["loop_grid"] == (1, 3) and out["loop_cam_fusion"] == 4
        assert out["loop_digest"] == ranks[0]["loop_digest"]
    files = grid_1x3["files"]
    assert any(f.startswith("loop/rank0/models/") for f in files), files
    assert not any(f.startswith(("loop/rank1", "loop/rank2")) for f in files)


def test_command_line(grid_2x2):
    """The command line's ``main`` on tiny_fake.yaml with
    ``tpu.cam_parallel_size: 2`` on 4 ranks trains through the (2, 2)
    grid: one step, rank 0's checkpoint."""
    for out in grid_2x2["ranks"]:
        assert out["cli_cam_fusion"] == 2
    files = grid_2x2["files"]
    assert any(f.startswith("cli/cam_cli/models/weights_0/")
               for f in files), files


def _grid_stub(cam):
    return mesh.Grid(1, cam, 0, 0, None, None)


def test_grid_rule(monkeypatch):
    """JAX's rule: no grid in one process or with ``cam_parallel_size`` 1,
    nor on a world smaller than it (JAX drops the camera axis there and
    trains on its 1-D data mesh); a larger world not a multiple of it
    raises (JAX would leave ranks out), as does ``num_cams`` not divisible
    by it (JAX's message); a model whose cameras do not divide over a grid
    refuses it."""
    cfg = presets.micro_config()
    cfg.set("cam_parallel_size", 3, section="tpu")
    assert mesh.cam_grid_for(cfg) is None            # one process
    monkeypatch.setattr(mesh, "rank_world", lambda: (1, 2))
    assert mesh.cam_grid_for(cfg) is None            # world 2 < cam 3
    monkeypatch.setattr(mesh, "rank_world", lambda: (0, 4))
    with pytest.raises(ValueError, match="not a multiple.*A3b"):
        mesh.cam_grid_for(cfg)
    cfg.set("cam_parallel_size", 2, section="tpu")
    with pytest.raises(ValueError, match=r"batch 2 must divide over 2 data "
                       r"shards and num_cams 3 over 2 camera shards"):
        mesh.cam_grid_for(cfg)
    cfg.set("cam_parallel_size", 1, section="tpu")
    assert mesh.cam_grid_for(cfg) is None
    with pytest.raises(ValueError, match="num_cams 3"):
        VFDepthModel(presets.micro_config(), device="cpu").shard_cameras(
            _grid_stub(2))


def test_local_cameras_and_placement():
    """``local_cameras`` takes the c-th block of a camera axis; inside
    ``camera_shard`` a per-camera vector of this rank's cameras goes to
    its place among the rig's (no group: the sum is the placement
    itself)."""
    grid = mesh.Grid(1, 3, 0, 1, None, None)
    x = torch.arange(2 * 6 * 4.0).reshape(2, 6, 4)
    assert torch.equal(mesh.local_cameras(x, grid, 6), x[:, 2:4])
    assert torch.equal(mesh.local_cameras(x, None, 6), x)
    v = torch.tensor([1.0, 2.0])
    assert torch.equal(mesh._placed(v, grid, 6),
                       torch.tensor([0.0, 0.0, 1.0, 2.0, 0.0, 0.0]))
