"""The rank side of ``tests/test_torch_parallel.py``: what each of the
spawned gloo ranks runs on the CPU (torch, numpy and the port only; the
JAX side stays in the test module's own process).

``run_rank`` joins a 2-rank group through a ``FileStore`` under the test's
``tmp_path`` (no TCP port to collide between test workers), runs every
check's rank-side work and saves what it saw to ``rank<r>.pt``:

* ``step``: its loader shard's first batch and one ``train_step`` at
  batch 1 from the parent's weights (rank 1 starts from other weights, so
  the set-up broadcast must replace them) with the parent's global noise;
  the noise its forward received, the reduced logs, gradients and state
  after Adam (rank 1 only their digests);
* ``unequal``: ``_percam_masked_mean`` and a BatchNorm layer on per-rank
  slices with deliberately unequal mask counts and means;
* ``windows``: ``configure_warp_window`` on this rank's first batch of the
  "nuscenes" rig, rank 1's focal length shortened so its rig needs other
  boxes;
* ``loop``: ``Trainer.learn`` for 2 steps, a log checkpoint at each, rank
  1's boxes too small for the overlaps (it overflows, rank 0 does not).
"""
import hashlib
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.data import BatchLoader, FakeDataset
from vfdepth_tpu_torch.losses.composite import _percam_masked_mean
from vfdepth_tpu_torch.models.blocks import BatchNorm
from vfdepth_tpu_torch.parallel import (COUNTS, global_batch,
                                        maybe_initialize_distributed,
                                        reduce_logs)
from vfdepth_tpu_torch.training import (Trainer, VFDepthModel,
                                        create_train_state, train_step)

WORLD = 2
THREADS = 1               # a rank's intra-op threads (two ranks side by side)
COLLECTIVE_TIMEOUT_S = 120
STEP = 3                  # global step of the compared update
NUM_SAMPLES = 8           # FakeDataset samples: 4 a shard
WINDOW_SIZE = dict(height=128, width=256)
WINDOW_FX_SCALE = 0.8     # rank 1's focal length in the window check
LOOP_HW = ([32, 64], [8, 16])   # each rank's boxes in the loop check


def step_config():
    """The micro model on the "nuscenes" rig at the focal-length scale 15,
    where the overlap losses are live (tests/test_torch_three_cam.py)."""
    cfg = presets.micro_config()
    cfg.set("focal_length_scale", 15.0)
    return cfg


def dataset(cfg, num_samples=NUM_SAMPLES):
    return FakeDataset(num_samples=num_samples, num_cams=cfg.num_cams,
                       height=cfg.height, width=cfg.width,
                       fusion_level=cfg.fusion_level, rig="nuscenes")


def shard_loader(ds, rank, world=WORLD):
    return BatchLoader(ds, 1, shuffle=True, num_workers=0, seed=42,
                       shard_index=rank, num_shards=world)


def carry_adam_state(opt, model, seed: int = 0) -> None:
    """A mid-run Adam state on every parameter, as
    tests/test_torch_train_step.py carries optax's: 7 updates made, first
    moments of this step's gradient size, second moments that make each
    update about lr. (Adam's first step from zero moments is about
    lr * sign(g), which a gradient entry near 0 flips.)"""
    rng = np.random.RandomState(seed)
    for _, p in model.named_parameters():
        opt.state[p] = dict(
            step=torch.tensor(7.0),
            exp_avg=torch.from_numpy(
                (1e-3 * rng.randn(*p.shape)).astype(np.float32)),
            exp_avg_sq=torch.from_numpy(
                (1e-8 * (0.5 + rng.rand(*p.shape))).astype(np.float32)))


def unequal_inputs():
    """Global [2, ...] inputs of the unequal-count checks: a loss map and a
    mask that keeps 90% of rank 0's pixels and 10% of rank 1's; a
    BatchNorm input whose rank-1 half has another mean and scale, and the
    cotangent of its output."""
    rng = np.random.RandomState(7)
    loss = rng.rand(2, 3, 8, 8, 1).astype(np.float32)
    keep = np.array([0.9, 0.1], np.float32)[:, None, None, None, None]
    mask = (rng.rand(2, 3, 8, 8, 1) < keep).astype(np.float32)
    x = rng.randn(2, 4, 5, 6).astype(np.float32)
    x[1] = 2.0 * x[1] + 3.0
    cot = rng.randn(2, 4, 5, 6).astype(np.float32)
    weights = rng.rand(3).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in dict(
        loss=loss, mask=mask, x=x, cot=cot, weights=weights).items()}


def masked_mean_and_grad(loss, mask, weights):
    loss = loss.clone().requires_grad_(True)
    value = _percam_masked_mean(loss, mask)
    (value * weights).sum().backward()
    return value.detach(), loss.grad


def batch_norm_and_grads(x, cot):
    """A BatchNorm layer's train-mode output, moved statistics and the
    gradients of sum(output * cot) (input, weight, bias)."""
    torch.manual_seed(0)
    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    bn.train()
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * cot).sum().backward()
    return dict(y=y.detach(), running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone(), dx=x.grad,
                dweight=bn.weight.grad, dbias=bn.bias.grad)


def digest(tensors) -> str:
    """A hash of a name -> tensor dict's names, dtypes, shapes and bits."""
    h = hashlib.sha256()
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous()
        h.update(f"{name} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _step(rank, inputs):
    cfg = step_config()
    loader = shard_loader(dataset(cfg), rank)
    batch = next(iter(loader))
    model = VFDepthModel(cfg, device="cpu", seed=rank)
    if rank == 0:
        model.load_state_dict(inputs["state"])
    opt = create_train_state(model)
    carry_adam_state(opt, model)
    seen, forward = {}, model.forward

    def recording(*args, **kwargs):
        seen["noise"] = kwargs["noise"].clone()
        return forward(*args, **kwargs)
    model.forward = recording
    logs = train_step(model, opt, batch, STEP, torch.Generator(),
                      noise=inputs["noise"])
    grads = {n: p.grad for n, p in model.named_parameters()}
    state = model.state_dict()
    out = dict(epoch_indices=loader._epoch_indices(), batch=batch,
               noise=seen["noise"], logs=reduce_logs(logs),
               digests=(digest(grads), digest(state)))
    if rank == 0:       # rank 1's are held to rank 0's by their digests
        out.update(grads={n: g.clone() for n, g in grads.items()},
                   state={k: v.clone() for k, v in state.items()})
    return out


def _unequal(rank):
    inp = unequal_inputs()
    part = {k: v[rank:rank + 1] for k, v in inp.items() if k != "weights"}
    with global_batch():
        value, dloss = masked_mean_and_grad(part["loss"], part["mask"],
                                            inp["weights"])
    return dict(masked_mean=value, masked_mean_dloss=dloss,
                batch_norm=batch_norm_and_grads(part["x"], part["cot"]))


def window_batch(cfg, rank):
    """Rank ``rank``'s first batch of the window check: sample ``rank`` of
    the "nuscenes" rig, rank 1's focal length shortened."""
    batch = dataset(cfg, 2).batch([rank])
    if rank == 1:
        batch["K/0"] = batch["K/0"].copy()
        batch["K/0"][..., :2, :2] *= WINDOW_FX_SCALE
    return batch


def window_config():
    cfg = presets.micro_config(**WINDOW_SIZE)
    cfg.set("focal_length_scale", 15.0)
    return cfg


def _windows(rank):
    cfg = window_config()
    model = VFDepthModel(cfg, device="cpu")
    model.configure_warp_window(window_batch(cfg, rank),
                                rigs=dataset(cfg, 2).rig_calibrations())
    return dict(windows=(model.warp_window, model.warp_window_hw))


def _loop(rank, work: Path):
    cfg = step_config()
    root = work / "loop" / f"rank{rank}"
    for key, value in (("warp_window_hw", LOOP_HW[rank]), ("num_epochs", 1),
                       ("log_frequency", 1), ("early_phase", 1000),
                       ("late_log_frequency", 1000),
                       ("log_path", str(root / "log")),
                       ("save_weights_root", str(root / "models"))):
        cfg.set(key, value)
    ds = dataset(cfg)
    model = VFDepthModel(cfg, device="cpu", seed=rank)
    trainer = Trainer(cfg, model, use_tb=True)
    notes, validations = [], []
    real_note, real_validate = trainer._note_warp_overflow, trainer._validate

    def note(overflow):
        notes.append((overflow, model.warp_window))
        return real_note(overflow)

    def validate(*args, **kwargs):
        validations.append(args[-1])
        return real_validate(*args, **kwargs)
    trainer._note_warp_overflow, trainer._validate = note, validate
    trainer.learn(shard_loader(ds, rank),
                  BatchLoader(ds, 1, shuffle=False, num_workers=0),
                  max_steps=2)
    return dict(loop_notes=notes, loop_validations=validations,
                loop_windows=(model.warp_window, model.warp_window_hw),
                loop_digest=digest(model.state_dict()))


def run_rank(rank: int, work: str) -> None:
    """One rank: join the group, run every check's part, save the results
    to ``<work>/rank<rank>.pt``."""
    torch.set_num_threads(THREADS)
    work = Path(work)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD))
    got = maybe_initialize_distributed(
        "cpu", init_method=f"file://{work / 'store'}",
        timeout_s=COLLECTIVE_TIMEOUT_S)
    out = dict(rank_world=got, backend=dist.get_backend())
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    out.update(_step(rank, inputs))
    out["step_counts"] = dict(COUNTS)
    out.update(_unequal(rank))
    out.update(_windows(rank))
    out.update(_loop(rank, work))
    cfg = step_config()
    cfg.set("cam_parallel_size", WORLD + 1)
    try:
        Trainer(cfg, VFDepthModel(cfg, device="cpu"), use_tb=False)
        out["cam_parallel"] = None
    except ValueError as e:
        out["cam_parallel"] = str(e)
    dist.barrier()
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()
