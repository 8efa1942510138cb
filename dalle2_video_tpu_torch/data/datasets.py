"""The CelebV-Text dataset, index splits and the epoch batch iterator (port
of dalle2_video_tpu/data/datasets.py: ``CelebVTextDataset``,
``split_indices``, ``BatchLoader``).

The dataset picks its stage from the artifacts it is given, as the JAX
one does: tokenised texts + a video store (CLIP), text + video embeds
(prior), video embeds + a video store (decoder). A video store is an h5
file (dataset "videos", (N, 3, T, S, S) f32, the reference layout) or a
``.vshard`` file (``data/shards.py``); videos are read at batch time, one
gathered read per batch, and come out channels-last (b, T, S, S, 3).
Any object with ``__len__`` and ``batch_items(indices) -> dict of arrays``
is a dataset for the loaders (the training entry point's synthetic set is
one). The worker-process loader is ``data/worker_loader.py``.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

log = logging.getLogger("dalle2_video_tpu_torch.data")


def _load_array(path) -> np.ndarray:
    """A .npy, .npz (its first array) or torch .pt / .pth tensor file."""
    p = Path(path)
    if p.suffix == ".npy":
        return np.load(p)
    if p.suffix == ".npz":
        with np.load(p) as z:
            return z[z.files[0]]
    if p.suffix in (".pt", ".pth"):
        import torch

        t = torch.load(p, map_location="cpu", weights_only=True)
        return t.numpy() if hasattr(t, "numpy") else np.asarray(t)
    raise ValueError(f"unsupported array format: {path}")


def _is_vshard(path) -> bool:
    return str(path).endswith(".vshard")


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ImportError("an h5 video store needs h5py (or convert it to .vshard with "
                          "data/shards.py::h5_to_vshard where h5py is installed)") from exc
    return h5py


class CelebVTextDataset:
    """Stage-detecting dataset over CelebV-Text artifacts. ``batch_items``
    returns the stage's arrays for a batch of indices: {"texts", "videos"}
    (CLIP), {"text_embeds", "video_embeds"} (prior), {"video_embeds",
    "videos"} (decoder), {"videos"} (the VQGAN, from a store alone). Its length is the artifacts' count, capped by the
    video store's.

    The store handle is opened lazily in the process that reads (a loader
    worker opens its own) and is never pickled: a handle opened before a
    fork is dropped in the child and reopened."""

    def __init__(self, texts_path=None, videos_path=None, text_embeds_path=None,
                 video_embeds_path=None, h5_dataset_name: str = "videos"):
        self.videos_path = videos_path
        self.h5_dataset_name = h5_dataset_name
        self._store = None
        self._store_pid = None
        if texts_path is not None and videos_path is not None:
            self.stage = "CLIP"
            self.texts = _load_array(texts_path)
            n = len(self.texts)
        elif text_embeds_path is not None and video_embeds_path is not None:
            self.stage = "prior"
            self.text_embeds = _load_array(text_embeds_path).astype(np.float32)
            self.video_embeds = _load_array(video_embeds_path).astype(np.float32)
            if len(self.text_embeds) != len(self.video_embeds):
                raise ValueError(f"{len(self.text_embeds)} text embeds, "
                                 f"{len(self.video_embeds)} video embeds")
            n = len(self.text_embeds)
        elif video_embeds_path is not None and videos_path is not None:
            self.stage = "decoder"
            self.video_embeds = _load_array(video_embeds_path).astype(np.float32)
            n = len(self.video_embeds)
        elif videos_path is not None:
            # the VQGAN's stage: the store's videos alone (the JAX dataset
            # has no such stage, so scripts/train_vqgan.py reads only its
            # synthetic smoke set)
            self.stage = "videos"
            n = float("inf")
        else:
            raise ValueError("cannot infer stage: give (texts, videos) for CLIP, "
                             "(text_embeds, video_embeds) for prior, "
                             "(video_embeds, videos) for decoder, or videos alone")
        if videos_path is not None:
            if _is_vshard(videos_path):
                from dalle2_video_tpu_torch.data.shards import ShardReader

                reader = ShardReader(videos_path)
                n_videos = len(reader)
                reader.close()
            else:
                with _h5py().File(videos_path, "r") as f:
                    n_videos = f[h5_dataset_name].shape[0]
            n = min(n, n_videos)
        self._len = n
        log.info("CelebVTextDataset stage=%s size=%d", self.stage, n)

    def __len__(self) -> int:
        return self._len

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_store"] = state["_store_pid"] = None
        return state

    def _videos(self):
        """This process's store handle: a ShardReader, or the h5 dataset."""
        if self._store is None or self._store_pid != os.getpid():
            if _is_vshard(self.videos_path):
                from dalle2_video_tpu_torch.data.shards import ShardReader

                self._store = ShardReader(self.videos_path)
            else:
                self._store = _h5py().File(self.videos_path, "r")[self.h5_dataset_name]
            self._store_pid = os.getpid()
        return self._store

    def load_videos(self, indices) -> np.ndarray:
        """(b, T, S, S, 3) channels-last videos for ``indices`` (any order),
        in the store's dtype: one gather from a .vshard store; from h5 one
        read at the sorted indices, put back in the asked order."""
        indices = np.asarray(indices)
        store = self._videos()
        if _is_vshard(self.videos_path):
            vids = store.gather(indices)
        else:
            order = np.argsort(indices)
            vids = store[indices[order].tolist()]  # h5 fancy indexing wants sorted
            unsort = np.empty_like(order)
            unsort[order] = np.arange(len(order))
            vids = vids[unsort]
        return np.ascontiguousarray(np.transpose(vids, (0, 2, 3, 4, 1)))

    def batch_items(self, indices) -> Dict[str, np.ndarray]:
        indices = np.asarray(indices)
        if self.stage == "CLIP":
            return {"texts": self.texts[indices], "videos": self.load_videos(indices)}
        if self.stage == "prior":
            return {"text_embeds": self.text_embeds[indices],
                    "video_embeds": self.video_embeds[indices]}
        if self.stage == "videos":
            return {"videos": self.load_videos(indices)}
        return {"video_embeds": self.video_embeds[indices],
                "videos": self.load_videos(indices)}


def split_indices(n: int, train_ratio: float = 0.8, seed: int = 1234
                  ) -> Dict[str, np.ndarray]:
    """Seeded train / val split shared across stages."""
    perm = np.random.RandomState(seed).permutation(n)
    n_train = int(n * train_ratio)
    return {"train": perm[:n_train], "val": perm[n_train:]}


def epoch_order(indices: np.ndarray, shuffle: bool, seed: int, epoch: int,
                shard_index: int = 0, num_shards: int = 1) -> np.ndarray:
    """One epoch's order of ``indices``: permuted by ``RandomState(seed +
    epoch)`` when ``shuffle``, then this shard's contiguous slice of it
    (len // num_shards indices from shard_index times that), as the JAX
    loader's per-host shard (both of the port's loaders batch it, the
    remainder dropped)."""
    if shuffle:
        indices = indices[np.random.RandomState(seed + epoch).permutation(len(indices))]
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
    per = len(indices) // num_shards
    return indices[shard_index * per:(shard_index + 1) * per]


PREFETCH = 2  # batches read ahead by the loader's thread


class BatchLoader:
    """Epoch iterator: seeded shuffle (seed + epoch), this rank's shard of
    it (``shard_index`` of ``num_shards``: the data index and size of the
    mesh), drop-remainder batches of ``batch_size`` (the rank's rows), a
    background thread that reads ``PREFETCH`` batches ahead; a read error
    fails the epoch."""

    def __init__(self, dataset, batch_size: int, indices: Optional[np.ndarray] = None,
                 shuffle: bool = True, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.indices = (np.asarray(indices) if indices is not None
                        else np.arange(len(dataset)))
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index, self.num_shards = shard_index, num_shards
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.indices) // self.num_shards // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        return epoch_order(self.indices, self.shuffle, self.seed, self.epoch,
                           self.shard_index, self.num_shards)

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
