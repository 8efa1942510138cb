"""The worker-process batch loader (counterpart of
dalle2_video_tpu/data/grain_pipeline.py::make_grain_loader, in PyTorch's
idiom): a ``torch.utils.data.DataLoader`` whose workers read whole batches.

``make_worker_loader`` hands each of ``worker_count`` worker processes
(started by ``spawn``: the consumer holds CUDA and other threads, which a
fork would copy mid-flight; the dataset is pickled to them without its
store handle) index batches from ``EpochBatches``; a worker calls
``dataset.batch_items(indices)`` once per batch (one gathered store read)
and the batch comes back as a dict of tensors, pinned when the consumer's
device is CUDA. ``read_buffer`` batches per worker are read ahead
(``prefetch_factor``). A worker's exception is raised in the consumer and
fails the epoch; a consumer that stops early shuts the workers down.

One deviation from the JAX package: grain's ``IndexSampler`` draws its own
order, which is not reproduced here. ``EpochBatches`` yields the index
batches of the thread loader, ``datasets.BatchLoader`` (a
``RandomState(seed + epoch)`` permutation, drop remainder), so both
loaders of the port give the same batches bit for bit, each rank its
shard (``shard_index`` / ``num_shards``: a contiguous slice of the epoch's
order, as the JAX loader's per-host shard).
"""

from __future__ import annotations

import multiprocessing
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from dalle2_video_tpu_torch.data.datasets import epoch_order


class EpochBatches(Sampler):
    """Index batches of one epoch per iteration: ``epoch_order`` (the
    thread loader's) cut into ``batch_size`` batches, the remainder
    dropped; the epoch advances each time the sampler is iterated."""

    def __init__(self, indices: np.ndarray, batch_size: int, shuffle: bool = True,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1):
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index, self.num_shards = shard_index, num_shards
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.indices) // self.num_shards // self.batch_size

    def __iter__(self) -> Iterator[List[int]]:
        idx = epoch_order(self.indices, self.shuffle, self.seed, self.epoch,
                          self.shard_index, self.num_shards)
        self.epoch += 1
        for i in range(len(self)):
            yield idx[i * self.batch_size:(i + 1) * self.batch_size].tolist()


class _Batches(Dataset):
    """A dataset whose item is a whole batch: ``batch_items(indices)``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, indices: List[int]) -> Dict[str, np.ndarray]:
        return self.dataset.batch_items(np.asarray(indices))


def _as_tensors(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


class WorkerLoader(DataLoader):
    """A DataLoader that shuts its workers down as soon as an epoch's
    iteration ends, fails or is abandoned (left to the garbage collector
    after a worker's error, the shutdown waits out a 5 s join per worker)."""

    def __iter__(self):
        it = super().__iter__()
        try:
            yield from it
        finally:
            if hasattr(it, "_shutdown_workers"):
                it._shutdown_workers()


def make_worker_loader(dataset, batch_size: int, indices: Optional[np.ndarray] = None, *,
                       shuffle: bool = True, seed: int = 0, shard_index: int = 0,
                       num_shards: int = 1, worker_count: int = 4,
                       read_buffer: int = 2, pin_memory: bool = False) -> WorkerLoader:
    """A DataLoader of dict batches (tensors) over ``dataset[indices]``, this
    rank's shard of each epoch: ``worker_count`` worker processes (0: read
    in the caller's process), ``read_buffer`` batches read ahead per worker,
    pinned host memory if ``pin_memory``. Each iteration is one epoch, in
    ``EpochBatches``' order."""
    indices = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    return WorkerLoader(
        _Batches(dataset), batch_size=None,
        sampler=EpochBatches(indices, batch_size, shuffle=shuffle, seed=seed,
                             shard_index=shard_index, num_shards=num_shards),
        num_workers=worker_count, collate_fn=_as_tensors, pin_memory=pin_memory,
        prefetch_factor=read_buffer if worker_count > 0 else None,
        multiprocessing_context=multiprocessing.get_context("spawn") if worker_count > 0
        else None)
