"""Data-parallel training of the port (``vfdepth_tpu_torch/parallel/``) on
the CPU: two gloo ranks at batch 1 against the JAX package's step and the
port's own single-process step at batch 2.

JAX's sharded step is one program over the global batch (its gradient is
the global loss's, its BatchNorm a SyncBatchNorm, its masked means global),
so it equals ``build_train_step`` at the global batch. Here that step runs
once in this process, jitted (``helpers_torch_step.jax_step``), on the
micro model of ``tests/test_torch_three_cam.py`` (3 cameras at 32x64 on
``FakeDataset``'s "nuscenes" rig at the focal-length scale 15, the flax
init with a real ego-motion); the port runs the same step in one process
at batch 2, then two ranks are spawned (``torch.multiprocessing`` with a
``FileStore`` under ``tmp_path``; ``helpers_torch_parallel.run_rank``), each
with its loader shard's first batch and JAX's global noise. One spawn runs
every rank-side check, each rank on one thread; the parent kills the ranks
and fails if they do not end in ``RANK_DEADLINE_S`` (a collective that one
rank skips hangs, it does not fail).

Bounds, the two ranks' step (its ``parallel.reduce_logs`` logs, its
averaged gradients, its state after Adam):

* against JAX, tests/test_torch_train_step.py's bounds for the port's
  single-process step, for its reasons: loss and scalar logs 2e-5 of their
  magnitude, 1e-3 for the four that average over the auto-mask (measured
  1.3e-6 and 1.9e-4); gradients, as a relative L2 error, 5e-3 (depth net;
  measured 2.5e-3) and 5e-2 (pose net; 2.7e-3); BatchNorm statistics 1e-5;
* against the port's single-process batch-2 step: the two compute the
  same function, differing by the order of f32 sums (a batch-1 convolution
  against a batch-2 one; the global BatchNorm's E[x^2] - E[x]^2 against
  ``var_mean``'s two passes), which can move an auto-mask pixel across a
  tie (none moved here; one moves the masked logs by ~1e-4 of their
  magnitude among these 12,288 pixels and a gradient by up to ~1e-3).
  Measured: logs that see no auto-mask agree to 3.3e-7 of their magnitude
  (bound 2e-6), those that average over it to 7e-6 (bound 3e-4: two
  flipped pixels); gradients to 2.5e-5 relative L2 (bound 2e-3);
  BatchNorm statistics to 9.6e-7 of their magnitude (bound 1e-5);
  parameters after Adam from a carried state to 1.2e-4 of the learning
  rate (bound 2e-3).

The ranks end with bit-identical parameters and statistics. The unequal
mask counts and means of (c) hold ``_percam_masked_mean`` and BatchNorm to
the one-process values to 1e-6 (f32 sums of 64-192 terms in another
order). The warp windows of (e) are integers and equal exactly.
"""
import shutil
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

import helpers_torch_parallel as H
from helpers_torch_step import (MASKED_LOGS, by_port_name, jax_step,
                                with_motion)
from helpers_torch_threads import fixed_threads, port_threads  # noqa: F401
from vfdepth_tpu import presets as jpresets
from vfdepth_tpu.training.model import VFDepthModel as JaxModel
from vfdepth_tpu_torch.parallel import COUNTS, distributed, reduce_logs
from vfdepth_tpu_torch.training import (VFDepthModel, create_train_state,
                                        train_step)
from vfdepth_tpu_torch.weights import load_flax_params

jax.config.update("jax_platforms", "cpu")
RANK_DEADLINE_S = 300
JAX_LOG_TOL, JAX_MASKED_TOL = 2e-5, 1e-3
JAX_GRAD_TOL = {"depth_net": 5e-3, "pose_net": 5e-2}
SELF_LOG_TOL, SELF_MASKED_TOL = 2e-6, 3e-4
SELF_GRAD_TOL, SELF_STATS_TOL, SELF_PARAM_TOL = 2e-3, 1e-5, 2e-3
UNEQUAL_TOL = 1e-6


def _global_indices():
    """The ranks' first samples, in rank order: the first of each
    contiguous shard of epoch 0's host-invariant permutation."""
    perm = np.random.RandomState(42).permutation(H.NUM_SAMPLES)
    return perm, [perm[r * H.NUM_SAMPLES // H.WORLD] for r in range(H.WORLD)]


def _spawn(work):
    """Run the ranks; their results, and the files each rank's training
    loop wrote. The work directory is emptied (a checkpoint of the micro
    model's two ResNet-18 encoders is ~270 MB)."""
    ctx = mp.spawn(H.run_rank, args=(str(work),), nprocs=H.WORLD, join=False)
    deadline = time.monotonic() + RANK_DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"the ranks did not end in {RANK_DEADLINE_S} s")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(H.WORLD)]
    loop = work / "loop"
    files = [sorted(p.relative_to(loop / f"rank{r}")
                    for p in (loop / f"rank{r}").rglob("*") if p.is_file())
             for r in range(H.WORLD)]
    shutil.rmtree(work)
    return ranks, files


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    jcfg = jpresets.micro_config()
    jcfg.set("focal_length_scale", 15.0)
    tcfg = H.step_config()
    perm, indices = _global_indices()
    batch = H.dataset(tcfg).batch(indices)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JaxModel(jcfg)
    params, stats = jm.init(jax.random.PRNGKey(0), jbatch)
    params = with_motion(params, (40.0, 20.0, 60.0))
    np_grads, jlogs, new_stats, noise, _ = jax_step(jm, params, stats,
                                                    jbatch, H.STEP)
    np_params, np_stats = jax.tree_util.tree_map(np.asarray, (params, stats))

    model = VFDepthModel(tcfg, device="cpu")
    load_flax_params(model, np_params, np_stats)
    noise = torch.from_numpy(np.array(noise))
    torch.save(dict(state=model.state_dict(), noise=noise),
               work / "inputs.pt")
    # the port's single-process step at the global batch: no group, so no
    # collective may run
    counts_before = dict(COUNTS)
    with fixed_threads():
        opt = create_train_state(model)
        H.carry_adam_state(opt, model)
        logs = train_step(model, opt, batch, H.STEP, torch.Generator(),
                          noise=noise)
    single = dict(
        logs=reduce_logs(logs), state=model.state_dict(),
        grads={n: p.grad for n, p in model.named_parameters()},
        counts=(counts_before, dict(COUNTS)))
    ranks, loop_files = _spawn(work)
    return dict(ranks=ranks, loop_files=loop_files, single=single,
                noise=noise, perm=perm, batch=batch, jax=dict(
                    logs={k: float(v) for k, v in jlogs.items()},
                    grads=np_grads, stats=new_stats),
                lr=tcfg.learning_rate)


def test_ranks_joined_one_group(runs):
    for r, out in enumerate(runs["ranks"]):
        assert out["rank_world"] == (r, H.WORLD)
        assert out["backend"] == "gloo"
        counts = out["step_counts"]
        # the set-up broadcast, BatchNorm's and the loss's global sums (3
        # masked means), one gradient bucket, the logs' sum and maximum
        for site in ("broadcast", "batch_norm", "loss"):
            assert counts.get(site, 0) > 0, (r, site, counts)
        assert counts["loss"] == 6 and counts["gradients"] == 1
        assert counts["logs"] == 2


def test_single_process_runs_no_collective(runs):
    before, after = runs["single"]["counts"]
    assert before == after
    assert distributed.rank_world() == (0, 1)
    assert distributed.maybe_initialize_distributed("cpu") == (0, 1)
    assert not distributed.is_active()


def test_launch_environment(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "VFDEPTH_COORDINATOR",
                "VFDEPTH_NUM_PROCESSES", "VFDEPTH_PROCESS_ID"):
        monkeypatch.delenv(key, raising=False)
    assert distributed._launch() is None
    monkeypatch.setenv("VFDEPTH_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("VFDEPTH_NUM_PROCESSES", "4")
    monkeypatch.setenv("VFDEPTH_PROCESS_ID", "2")
    assert distributed._launch() == ("tcp://localhost:1234", 2, 4, None)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed._launch() == ("env://", 3, 4, 1)


def test_loader_shards(runs):
    """(d) the ranks' shards partition the epoch's permutation, and their
    first batches, in rank order, are the global batch of the step."""
    shards = [out["epoch_indices"] for out in runs["ranks"]]
    assert np.array_equal(np.concatenate(shards), runs["perm"])
    assert not set(shards[0]) & set(shards[1])
    for r, out in enumerate(runs["ranks"]):
        for key, value in runs["batch"].items():
            assert np.array_equal(out["batch"][key], value[r:r + 1]), key


def test_step_noise_slices(runs):
    """Each rank's forward got its slice of the global tie-break noise,
    whose batch axis is 1. (A wrong slice changes the step only where the
    noise breaks an auto-mask tie; on this step's ego-motion no pixel ties
    that closely, so the step's own comparisons cannot see it.)"""
    noise = runs["noise"]
    assert noise.shape[1] == H.WORLD
    for r, out in enumerate(runs["ranks"]):
        assert torch.equal(out["noise"], noise[:, r:r + 1])


def test_step_logs_against_jax(runs):
    want = runs["jax"]["logs"]
    for r, out in enumerate(runs["ranks"]):
        got = out["logs"]
        assert set(got) == set(want)
        for key, w in want.items():
            tol = JAX_MASKED_TOL if key in MASKED_LOGS else JAX_LOG_TOL
            assert np.isfinite(got[key]), key
            assert abs(got[key] - w) <= tol * max(abs(w), 1e-3), (
                r, key, got[key], w)
    assert want["spatio_loss"] > 0 and want["spatio_tempo_loss"] > 0


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
    want = by_port_name({net: runs["jax"]["stats"][net]})
    got = runs["ranks"][0]["state"]
    assert want
    for name, w in want.items():
        init = 0.0 if name.endswith("running_mean") else 1.0
        assert np.abs(w - init).max() > 0, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_step_logs_against_single_process(runs):
    want = runs["single"]["logs"]
    got = runs["ranks"][0]["logs"]
    assert set(got) == set(want)
    for key, w in want.items():
        tol = SELF_MASKED_TOL if key in MASKED_LOGS else SELF_LOG_TOL
        assert abs(got[key] - w) <= tol * max(abs(w), 1e-3), (
            key, got[key], w)


def test_step_gradients_against_single_process(runs):
    want, got = runs["single"]["grads"], runs["ranks"][0]["grads"]
    assert set(got) == set(want)
    for name, w in want.items():
        norm = w.norm()
        assert norm > 0, name
        assert (got[name] - w).norm() <= SELF_GRAD_TOL * norm, (
            name, ((got[name] - w).norm() / norm).item())


@pytest.mark.parametrize("kind", ["parameters", "batchnorm"])
def test_step_state_against_single_process(runs, kind):
    """Every parameter after Adam (from a carried state) within
    ``SELF_PARAM_TOL`` of the learning rate; every BatchNorm statistic
    within ``SELF_STATS_TOL`` of its magnitude."""
    want, got = runs["single"]["state"], runs["ranks"][0]["state"]
    params = {n for n, _ in VFDepthModel(H.step_config(),
                                          device="cpu").named_parameters()}
    names = [k for k in want if (k in params) == (kind == "parameters")
             and not k.endswith("num_batches_tracked")]
    assert names
    for name in names:
        w, g = want[name], got[name]
        if kind == "parameters":
            assert (g - w).abs().max() <= SELF_PARAM_TOL * runs["lr"], name
        else:
            torch.testing.assert_close(
                g, w, rtol=SELF_STATS_TOL,
                atol=SELF_STATS_TOL * w.abs().max().item(), msg=name)


def test_ranks_bit_identical(runs):
    """(b) both ranks hold the same gradients, parameters and statistics
    (their digests: names, shapes and bits) and logs."""
    r0, r1 = runs["ranks"]
    assert r0["digests"] == (H.digest(r0["grads"]), H.digest(r0["state"]))
    assert r1["digests"] == r0["digests"]
    assert r1["logs"] == r0["logs"]


def test_unequal_masked_mean(runs):
    """(c) the per-camera masked mean over two ranks whose masks keep 90%
    and 10% of their pixels equals the one-process value; each rank's
    input gradient is that of the sum of the ranks' (equal) objectives,
    twice the one-process gradient, halved by the gradient average."""
    inp = H.unequal_inputs()
    keep = [float(inp["mask"][r].mean()) for r in range(H.WORLD)]
    assert keep[0] > 0.8 and keep[1] < 0.2
    want, dwant = H.masked_mean_and_grad(inp["loss"], inp["mask"],
                                         inp["weights"])
    for r, out in enumerate(runs["ranks"]):
        torch.testing.assert_close(out["masked_mean"], want, rtol=UNEQUAL_TOL,
                                   atol=UNEQUAL_TOL)
        torch.testing.assert_close(out["masked_mean_dloss"] / H.WORLD,
                                   dwant[r:r + 1], rtol=UNEQUAL_TOL,
                                   atol=UNEQUAL_TOL * dwant.abs().max().item())
    # a mean of the ranks' own masked means would differ
    local = [H.masked_mean_and_grad(inp["loss"][r:r + 1],
                                    inp["mask"][r:r + 1], inp["weights"])[0]
             for r in range(H.WORLD)]
    assert (sum(local) / H.WORLD - want).abs().max() > 1e-2


def test_unequal_batch_norm(runs):
    """(c) BatchNorm over two ranks whose inputs have other means and
    scales: the output, the moved statistics and the gradients of the
    summed objective equal one BatchNorm over both halves (the weight's
    and bias's gradients summed over the ranks)."""
    inp = H.unequal_inputs()
    want = H.batch_norm_and_grads(inp["x"], inp["cot"])
    ranks = [out["batch_norm"] for out in runs["ranks"]]

    def close(got, ref):
        torch.testing.assert_close(got, ref, rtol=UNEQUAL_TOL,
                                   atol=UNEQUAL_TOL * ref.abs().max().item())
    for r, got in enumerate(ranks):
        close(got["y"], want["y"][r:r + 1])
        close(got["dx"], want["dx"][r:r + 1])
        close(got["running_mean"], want["running_mean"])
        close(got["running_var"], want["running_var"])
    close(ranks[0]["dweight"] + ranks[1]["dweight"], want["dweight"])
    close(ranks[0]["dbias"] + ranks[1]["dbias"], want["dbias"])
    local = H.batch_norm_and_grads(inp["x"][:1], inp["cot"][:1])
    assert (local["running_mean"] - want["running_mean"]).abs().max() > 0.1


def test_windows_agree(runs):
    """(e) the ranks size the same boxes, those of the global first batch,
    where rank 0's batch alone would size others."""
    cfg = H.window_config()
    batches = [H.window_batch(cfg, r) for r in range(H.WORLD)]
    rigs = H.dataset(cfg, 2).rig_calibrations()

    def sized(batch):
        model = VFDepthModel(cfg, device="cpu")
        model.configure_warp_window(batch, rigs=rigs)
        return model.warp_window, model.warp_window_hw
    both = sized({k: np.concatenate([b[k] for b in batches])
                  for k in ("K/0", "extrinsics")})
    assert both[0] and both[1] is not None
    assert sized(batches[0]) != both
    for out in runs["ranks"]:
        assert out["windows"] == both


def test_training_loop(runs):
    """(f) ``Trainer.learn`` on both ranks: rank 1's boxes overflow, rank
    0's do not, and both note the overflow's maximum at each checkpoint and
    fall back to dense warps at the second; only rank 0 validates and
    writes files; the ranks end bit-identical. ``tpu.cam_parallel_size``
    3 on 2 ranks raises (a world not a multiple of it), naming ROADMAP
    A3b."""
    files = runs["loop_files"]
    assert files[1] == []
    assert any(p.parts[0] == "models" for p in files[0]), files[0]
    a, b = (out["loop_notes"] for out in runs["ranks"])
    assert a == b and len(a) == 2
    assert all(ov > 0 for ov, _ in a) and all(on for _, on in a)
    for out in runs["ranks"]:
        assert out["loop_windows"] == (False, None)
        assert "A3b" in out["cam_parallel"]
    assert runs["ranks"][0]["loop_validations"] == [0, 1]
    assert runs["ranks"][1]["loop_validations"] == []
    assert runs["ranks"][0]["loop_digest"] == runs["ranks"][1]["loop_digest"]
