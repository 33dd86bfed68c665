"""Host-side data feed: threaded collation + device prefetch (port of
``vfdepth_tpu/data/loader.py``).

``BatchLoader`` is copied: a background thread pool builds numpy batches
while the device computes; each epoch is a seeded permutation
(``RandomState(seed + epoch)``, ``set_epoch`` passed on to the dataset),
cut into contiguous per-host shards like the reference's
DistributedSampler.

``device_prefetch`` is the counterpart of the JAX package's
``jax.device_put`` pipeline in PyTorch's idiom: each batch's arrays are
pinned on the host and copied with ``non_blocking`` copies on a side CUDA
stream, ``size`` batches ahead of the consumer, so the uploads overlap the
device's work on the current batch.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Iterator, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..utils.tracing import span


class BatchLoader:
    """Iterable over collated numpy batch dicts.

    Args:
      dataset: object with __len__ and __getitem__ -> Dict[str, np.ndarray],
        or with a ``batch(indices)`` fast path.
      batch_size: per-host batch size.
      shuffle: reshuffle each epoch (seeded; epoch folded into the seed).
      drop_last: drop the trailing partial batch (the reference always does).
      num_workers: collation threads (0 = synchronous).
      shard_index/num_shards: this host's shard of the index space.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 2, seed: int = 42,
                 shard_index: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        # propagate to the dataset so per-sample augmentation seeds change
        # across epochs (otherwise every epoch replays identical jitter)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    @property
    def steps_per_epoch(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        # contiguous per-host shard of the (shuffled) index space
        per = n // self.num_shards
        idx = idx[self.shard_index * per:(self.shard_index + 1) * per]
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        return idx

    def _collate(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        if hasattr(self.dataset, "batch"):
            return self.dataset.batch(list(indices))
        samples = [self.dataset[int(i)] for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def __len__(self) -> int:
        return self.steps_per_epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.num_workers <= 0:
            for b in batches:
                yield self._collate(b)
            return

        lock = threading.Lock()
        pos = {"i": 0}
        out: Dict[int, Any] = {}
        cond = threading.Condition()

        def worker():
            while True:
                with lock:
                    i = pos["i"]
                    if i >= len(batches):
                        break
                    pos["i"] = i + 1
                # store exceptions as the slot value and re-raise in the
                # consumer: a swallowed worker death would leave the
                # consumer waiting forever on a batch that never arrives
                try:
                    data = self._collate(batches[i])
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    data = e
                with cond:
                    out[i] = data
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        for i in range(len(batches)):
            with cond:
                while i not in out:
                    cond.wait(timeout=60.0)
                data = out.pop(i)
            if isinstance(data, BaseException):
                raise RuntimeError(
                    f"BatchLoader worker failed on batch {i}") from data
            yield data
        for t in threads:
            t.join()


def _as_f32(value) -> torch.Tensor:
    return torch.as_tensor(value).to(torch.float32)


def device_prefetch(iterator, size: int = 2,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of ``iterator`` (dicts of arrays) as dicts of f32 tensors on
    ``device`` (CUDA unless the CPU is asked for), uploaded ``size``
    batches ahead of the consumer.

    What it yields is what ``VFDepthModel._to_device`` makes of the batch,
    bit for bit, so the model takes it without another copy. On CUDA each
    array is pinned and copied with a ``non_blocking`` copy on a side
    stream; before a batch is yielded, the consumer's stream waits for its
    copies, and every tensor is marked as used on that stream
    (``record_stream``) so that the caching allocator cannot hand its memory
    to the side stream's next copy while the consumer still reads it.
    Pinning or copying failures raise: there is no pageable fallback.
    """
    device = resolve_device(device)
    it = iter(iterator)
    if device.type != "cuda":
        for batch in it:
            with span("vf.loader.pin"):
                host = {k: _as_f32(v) for k, v in batch.items()}
            with span("vf.loader.upload"):
                dev = {k: t.to(device) for k, t in host.items()}
            yield dev
        return

    stream = torch.cuda.Stream(device)

    def put(batch):
        with span("vf.loader.pin"):
            host = {k: _as_f32(v).contiguous().pin_memory()
                    for k, v in batch.items()}
        with span("vf.loader.upload"), torch.cuda.stream(stream):
            dev = {k: t.to(device, non_blocking=True) for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return dev, done

    buf: collections.deque = collections.deque()
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= max(size, 1):
            break
    while buf:
        dev, done = buf.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in dev.values():
            t.record_stream(consumer)
        yield dev
        del dev        # the consumer's reference is the last one
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
