"""The port's data feed against the JAX package's, on the CPU:
``BatchLoader`` (the same batches, bit for bit, over two epochs, shuffled
or not, with and without collation threads, for each of two shards),
``construct_dataset`` (the same samples), and ``device_prefetch`` on the
CPU (what ``VFDepthModel._to_device`` makes, which then copies nothing).
Everything here is the same numpy arithmetic on both sides: no tolerance.
"""
import numpy as np
import pytest
import torch

from vfdepth_tpu.data.factory import construct_dataset as jax_construct
from vfdepth_tpu.data.fake import FakeDataset as JaxFake
from vfdepth_tpu.data.loader import BatchLoader as JaxLoader
from vfdepth_tpu_torch import presets
from vfdepth_tpu_torch.config import get_config
from vfdepth_tpu_torch.data import BatchLoader, FakeDataset, device_prefetch
from vfdepth_tpu_torch.data.factory import construct_dataset
from vfdepth_tpu_torch.training import VFDepthModel
from helpers_torch_threads import port_threads  # noqa: F401

DS = dict(num_samples=9, num_cams=3, height=32, width=64, fusion_level=2)


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _epochs(loader, n=2):
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out.append(list(loader))
    return out


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("shard", [0, 1])
def test_batch_loader_matches_jax(shuffle, num_workers, shard):
    kw = dict(batch_size=2, shuffle=shuffle, num_workers=num_workers, seed=5,
              shard_index=shard, num_shards=2)
    port = BatchLoader(FakeDataset(**DS), **kw)
    ref = JaxLoader(JaxFake(**DS), **kw)
    assert port.steps_per_epoch == ref.steps_per_epoch == len(port) == 2
    got, want = _epochs(port), _epochs(ref)
    for e in range(2):
        assert len(got[e]) == len(want[e]) == 2
        for a, b in zip(got[e], want[e]):
            _equal(a, b)
    if shuffle:     # a new permutation each epoch (epoch folded into seed)
        assert not np.array_equal(got[0][0]["color/0/0"],
                                  got[1][0]["color/0/0"])


def test_partial_batch_kept_without_drop_last():
    kw = dict(batch_size=4, shuffle=True, drop_last=False, num_workers=2)
    port = BatchLoader(FakeDataset(**DS), **kw)
    ref = JaxLoader(JaxFake(**DS), **kw)
    assert port.steps_per_epoch == ref.steps_per_epoch == 3
    got, want = list(port), list(ref)
    assert [b["mask"].shape[0] for b in got] == [4, 4, 1]
    for a, b in zip(got, want):
        _equal(a, b)


class _Samples:
    """A dataset without the ``batch`` fast path, one of whose samples
    fails; it records ``set_epoch``."""

    def __init__(self, bad=None):
        self.bad, self.epochs = bad, []

    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == self.bad:
            raise KeyError(f"sample {i} is broken")
        return {"x": np.full((2,), i, np.float32)}

    def set_epoch(self, epoch):
        self.epochs.append(epoch)


def test_per_sample_collation_and_set_epoch():
    ds = _Samples()
    loader = BatchLoader(ds, 2, shuffle=False, num_workers=2)
    loader.set_epoch(3)
    assert ds.epochs == [3]
    assert [b["x"][:, 0].tolist() for b in loader] == [[0, 1], [2, 3], [4, 5]]


@pytest.mark.parametrize("num_workers", [0, 2])
def test_worker_exception_reaches_the_consumer(num_workers):
    loader = BatchLoader(_Samples(bad=3), 2, shuffle=False,
                         num_workers=num_workers)
    if num_workers:
        with pytest.raises(RuntimeError, match="batch 1") as info:
            list(loader)
        assert isinstance(info.value.__cause__, KeyError)
    else:
        with pytest.raises(KeyError):
            list(loader)


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("dataset", ["fake", "synthetic"])
def test_construct_dataset_matches_jax(dataset, mode):
    cfg = presets.micro_config()
    cfg.set("dataset", dataset)
    cfg.set("num_fake_samples", 3)
    port, ref = construct_dataset(cfg, mode), jax_construct(cfg, mode)
    assert type(port).__name__ == type(ref).__name__
    assert len(port) == len(ref) == 3
    _equal(port.batch([0, 2]), ref.batch([0, 2]))
    assert ("depth" in port[0]) == (mode != "train" or dataset == "synthetic")


@pytest.mark.parametrize("dataset", ["ddad", "nuscenes"])
def test_construct_dataset_builds_the_readers(tmp_path, dataset):
    """The factory builds the port's DDAD and nuScenes readers (held
    against JAX's in tests/test_torch_readers.py)."""
    from test_dataset_readers import CAMS, _make_ddad, _make_nuscenes
    from vfdepth_tpu_torch.data import DDADDataset, NuScenesDataset
    cfg = presets.micro_config()
    cfg.set("dataset", dataset)
    if dataset == "ddad":
        cfg.set("data_path", _make_ddad(str(tmp_path)))
        cfg.set("cameras", CAMS)
    else:
        root, cams = _make_nuscenes(str(tmp_path))
        cfg.set("data_path", root)
        cfg.set("cameras", cams)
    ds = construct_dataset(cfg, "train")
    assert type(ds) is (DDADDataset if dataset == "ddad" else NuScenesDataset)
    assert len(ds) > 0 and ds[0]["color/0/0"].shape[0] == len(cfg.cameras)


def test_device_prefetch_on_cpu_is_to_device():
    """On the CPU it yields ``_to_device``'s f32 tensors, in order, and the
    model takes them without another copy."""
    cfg = get_config("configs/tiny_fake.yaml")
    model = VFDepthModel(cfg, device="cpu")
    ds = FakeDataset(num_samples=4, num_cams=cfg.num_cams, height=cfg.height,
                     width=cfg.width, fusion_level=cfg.fusion_level)
    batches = [ds.batch([i]) for i in range(4)]
    batches[1] = {k: v.astype(np.float64) for k, v in batches[1].items()}
    got = list(device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(got) == 4
    for batch, dev in zip(batches, got):
        want = model._to_device(batch)
        assert dev.keys() == batch.keys()
        for k, t in dev.items():
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            assert torch.equal(t, want[k]), k
        again = model._to_device(dev)
        assert all(again[k] is dev[k] for k in dev)
