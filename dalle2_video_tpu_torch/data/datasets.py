"""Index splits and the epoch batch iterator (port of the JAX-free parts of
dalle2_video_tpu/data/datasets.py: ``split_indices``, ``BatchLoader``).

The CelebV-Text dataset reader (h5 / .vshard video stores) is not ported:
it waits until the data files are in the repository. Any object with
``__len__`` and ``batch_items(indices) -> dict of arrays`` is a dataset
here (the training entry point's synthetic set is one).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def split_indices(n: int, train_ratio: float = 0.8, seed: int = 1234
                  ) -> Dict[str, np.ndarray]:
    """Seeded train / val split shared across stages."""
    perm = np.random.RandomState(seed).permutation(n)
    n_train = int(n * train_ratio)
    return {"train": perm[:n_train], "val": perm[n_train:]}


PREFETCH = 2  # batches read ahead by the loader's thread


class BatchLoader:
    """Epoch iterator: seeded shuffle (seed + epoch), drop-remainder
    batches, a background thread that reads ``PREFETCH`` batches ahead; a
    read error fails the epoch. One device, so no per-host shard (the JAX
    loader's ``shard_index`` / ``num_shards`` wait for data-parallel
    training)."""

    def __init__(self, dataset, batch_size: int, indices: Optional[np.ndarray] = None,
                 shuffle: bool = True, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.indices = (np.asarray(indices) if indices is not None
                        else np.arange(len(dataset)))
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.indices) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = self.indices
        if self.shuffle:
            idx = idx[np.random.RandomState(self.seed + self.epoch).permutation(len(idx))]
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_indices()
        self.epoch += 1
        nb = len(idx) // self.batch_size
        if nb == 0:
            return
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that honours `stop`, so a consumer that leaves
            # early never strands the thread on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for i in range(nb):
                    if stop.is_set():
                        return
                    sel = idx[i * self.batch_size:(i + 1) * self.batch_size]
                    if not put(("batch", self.ds.batch_items(sel))):
                        return
                put(("done", None))
            except Exception as exc:  # noqa: BLE001 -- handed to the consumer
                put(("error", exc))

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise item
                yield item
        finally:
            stop.set()
            th.join(timeout=5.0)
