"""The training data path against the JAX package, on the CPU: the .vshard
store (``data/shards.py``), ``CelebVTextDataset`` on h5 and .vshard stores,
the worker-process loader (``data/worker_loader.py``) against the thread
loader, preprocessing (``data/preprocess.py``) of cv2-written mp4s, and the
training entry point trained from a store. Every store is written inside
the test; nothing is downloaded.
"""

from __future__ import annotations

import json
import multiprocessing
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dalle2_video_tpu.data import shards as jax_shards
from dalle2_video_tpu.data.datasets import BatchLoader as JaxLoader
from dalle2_video_tpu.data.datasets import CelebVTextDataset as JaxDataset
from dalle2_video_tpu_torch.data import shards
from dalle2_video_tpu_torch.data.datasets import BatchLoader, CelebVTextDataset
from dalle2_video_tpu_torch.data.worker_loader import EpochBatches, make_worker_loader

torch.set_num_threads(1)
N, T, S = 10, 3, 8  # records, frames, frame size of the stores


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One corpus in every form: an h5 store, a .vshard store, tokens (.npy,
    .pt) and embeds (.npy, .pt), with 12 embeds for 10 videos (the length
    rule caps at the store)."""
    import h5py

    d = tmp_path_factory.mktemp("stores")
    rng = np.random.RandomState(0)
    videos = rng.randn(N, 3, T, S, S).astype(np.float32)
    with h5py.File(d / "videos.h5", "w") as f:
        f.create_dataset("videos", data=videos, chunks=(1, 3, T, S, S))
    with shards.ShardWriter(d / "videos.vshard", videos.shape[1:]) as w:
        for v in videos:
            w.append(v)
    out = {"videos": videos, "h5": str(d / "videos.h5"), "vshard": str(d / "videos.vshard")}
    arrays = {"tokens": rng.randint(0, 1000, (N, 77)).astype(np.int32),
              "embeds": rng.randn(N + 2, 16).astype(np.float32),
              "text_embeds": rng.randn(N + 2, 16).astype(np.float32)}
    for name, a in arrays.items():
        np.save(d / f"{name}.npy", a)
        torch.save(torch.from_numpy(a), d / f"{name}.pt")
        out[name] = {ext: str(d / f"{name}.{ext}") for ext in ("npy", "pt")}
    return out


# ------------------------------------------------------------ the .vshard store
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_vshard_stores_cross_read_bit_for_bit(tmp_path, dtype):
    """A store written by either package is the same file, and each reader
    gathers the other's records exactly, in any order with repeats; an
    index out of range raises."""
    rng = np.random.RandomState(1)
    data = (rng.randn(7, 2, 3, 5) * 50).astype(dtype)
    for writer, name in ((shards.ShardWriter, "port"), (jax_shards.ShardWriter, "jax")):
        with writer(tmp_path / f"{name}.vshard", data.shape[1:], dtype) as w:
            for rec in data:
                w.append(rec)
    assert (tmp_path / "port.vshard").read_bytes() == (tmp_path / "jax.vshard").read_bytes()
    idx = [6, 0, 3, 3, 1]
    for name in ("port", "jax"):
        ours = shards.ShardReader(str(tmp_path / f"{name}.vshard"), num_threads=3)
        theirs = jax_shards.ShardReader(str(tmp_path / f"{name}.vshard"))
        assert len(ours) == 7 and ours.record_shape == (2, 3, 5) and ours.dtype == dtype
        np.testing.assert_array_equal(ours.gather(idx), data[idx])
        np.testing.assert_array_equal(ours.gather(idx), theirs.gather(idx))
        ours.prefetch(idx)
        with pytest.raises(IndexError):
            ours.gather([0, 7])
        ours.close()
        theirs.close()
    with pytest.raises(IOError):
        shards.ShardReader(str(tmp_path / "missing.vshard"))


def test_h5_to_vshard_matches_jax(stores, tmp_path):
    """h5_to_vshard of one h5 store gives the JAX package's file byte for
    byte; the reader's library is built under the port's csrc/_build."""
    assert shards.h5_to_vshard(stores["h5"], tmp_path / "port.vshard") == N
    assert jax_shards.h5_to_vshard(stores["h5"], str(tmp_path / "jax.vshard")) == N
    assert (tmp_path / "port.vshard").read_bytes() == (tmp_path / "jax.vshard").read_bytes()
    assert shards.lib_path().parent == shards.BUILD_DIR
    assert shards.BUILD_DIR.parts[-3:] == ("dalle2_video_tpu_torch", "csrc", "_build")


def test_concurrent_first_builds_make_one_library(stores, tmp_path):
    """Four processes building the reader at once into an empty directory
    (loader workers, test workers) all load one complete library; no
    temporary file is left behind."""
    script = ("import sys; from pathlib import Path; from dalle2_video_tpu_torch.data import "
              "shards; shards.BUILD_DIR = Path(sys.argv[1]); r = shards.ShardReader(sys.argv[2]); "
              "print(shards.lib_path(), len(r))")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path / "build"),
                               stores["vshard"]], stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=60)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len({o[0] for o in outs}) == 1 and {o[1] for o in outs} == {str(N)}
    assert sorted(f.suffix for f in (tmp_path / "build").iterdir()) == [".lock", ".so"]


# ------------------------------------------------------------ the dataset
_DS_CASES = [("h5", "CLIP", "npy"), ("vshard", "CLIP", "pt"), ("h5", "decoder", "pt"),
             ("vshard", "decoder", "npy"), (None, "prior", "pt")]


@pytest.mark.parametrize("store,stage,ext", _DS_CASES,
                         ids=[f"{s}-{g}-{e}" for s, g, e in _DS_CASES])
def test_dataset_batch_items_match_jax(stores, store, stage, ext):
    """The stage, the length and every array of batch_items equal the JAX
    dataset's, at unsorted indices; videos channels-last."""
    kw = {"CLIP": dict(texts_path=stores["tokens"][ext]),
          "decoder": dict(video_embeds_path=stores["embeds"][ext]),
          "prior": dict(text_embeds_path=stores["text_embeds"][ext],
                        video_embeds_path=stores["embeds"][ext])}[stage]
    if store is not None:
        kw["videos_path"] = stores[store]
    ours, theirs = CelebVTextDataset(**kw), JaxDataset(**kw)
    assert ours.stage == theirs.stage == stage
    assert len(ours) == len(theirs) == (N + 2 if stage == "prior" else N)
    idx = np.array([7, 2, 9, 0])
    got, want = ours.batch_items(idx), theirs.batch_items(idx)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    if "videos" in got:
        np.testing.assert_array_equal(
            got["videos"], stores["videos"][idx].transpose(0, 2, 3, 4, 1))


def test_dataset_handle_is_per_process_and_h5py_named(stores, monkeypatch):
    """A dataset that has read from h5 pickles without its handle and
    reopens it where it reads next; without h5py an h5 path raises an
    ImportError that names h5py (a .vshard store needs no h5py)."""
    ds = CelebVTextDataset(video_embeds_path=stores["embeds"]["npy"],
                           videos_path=stores["h5"])
    first = ds.batch_items(np.array([3]))["videos"]
    copy = pickle.loads(pickle.dumps(ds))
    assert copy._store is None
    np.testing.assert_array_equal(copy.batch_items(np.array([3]))["videos"], first)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        CelebVTextDataset(video_embeds_path=stores["embeds"]["npy"], videos_path=stores["h5"])
    CelebVTextDataset(video_embeds_path=stores["embeds"]["npy"], videos_path=stores["vshard"])


# ------------------------------------------------------------ the loaders
def test_worker_loader_gives_the_thread_loaders_batches(stores):
    """Two worker processes over a .vshard store: two epochs of the same
    batches as BatchLoader (seed + epoch, drop remainder), bit for bit, as
    tensors; the sampler's batches are BatchLoader's indices; a val loader
    keeps its order."""
    ds = CelebVTextDataset(video_embeds_path=stores["embeds"]["npy"],
                           videos_path=stores["vshard"])
    train = np.array([8, 1, 5, 3, 0, 9, 4])
    workers = make_worker_loader(ds, 2, train, seed=5, worker_count=2, read_buffer=2)
    thread = BatchLoader(ds, 2, train, seed=5)
    assert len(workers) == len(thread) == 3
    for epoch in range(2):
        theirs = JaxLoader(ds, 2, train, seed=5)
        theirs.epoch = epoch
        want_idx = theirs._epoch_indices()[:6].reshape(3, 2)
        got, want = list(workers), list(thread)
        assert len(got) == len(want) == 3
        for g, w, i in zip(got, want, want_idx):
            assert all(isinstance(v, torch.Tensor) for v in g.values())
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), w[k])
            np.testing.assert_array_equal(g["video_embeds"].numpy(), ds.video_embeds[i])
    assert [b for b in EpochBatches(np.arange(5), 2, shuffle=False)] == [[0, 1], [2, 3]]


def test_worker_loader_fails_the_epoch_on_a_worker_error(stores, tmp_path):
    """A worker that cannot read its store (here: truncated after the
    dataset was opened) raises in the consumer, and the workers are shut
    down at once."""
    store = tmp_path / "videos.vshard"
    store.write_bytes(Path(stores["vshard"]).read_bytes())
    ds = CelebVTextDataset(video_embeds_path=stores["embeds"]["npy"], videos_path=str(store))
    store.write_bytes(b"")
    before = set(multiprocessing.active_children())
    t = time.time()
    with pytest.raises(IOError, match="cannot open shard"):
        list(make_worker_loader(ds, 2, worker_count=2))
    assert time.time() - t < 10 and set(multiprocessing.active_children()) <= before


def test_worker_loader_abandoned_iteration_shuts_down(stores):
    """A consumer that takes one batch of many and lets go: the workers are
    shut down within seconds."""
    ds = CelebVTextDataset(video_embeds_path=stores["embeds"]["npy"],
                           videos_path=stores["vshard"])
    before = set(multiprocessing.active_children())
    it = iter(make_worker_loader(ds, 1, worker_count=2, read_buffer=4))
    assert next(it)["videos"].shape == (1, T, S, S, 3)
    workers = set(multiprocessing.active_children()) - before
    assert len(workers) == 2
    t = time.time()
    del it
    for w in workers:
        w.join(10)
    assert time.time() - t < 5 and not any(w.is_alive() for w in workers)


# ------------------------------------------------------------ preprocessing
def _corpus(root):
    """Four captioned clips as cv2 mp4s (48 x 64, 8 frames at 8 fps): clip 2
    has no video, clip 3 only 5 frames (both skipped); two caption
    sources besides the details, one of them missing for clip 1."""
    import cv2

    texts, videos = root / "texts", root / "videos"
    for d in ("face40_details_new", "emotion", "light_dir"):
        (texts / d).mkdir(parents=True)
    videos.mkdir()
    for i in range(4):
        name = f"clip{i}"
        (texts / "face40_details_new" / f"{name}.txt").write_text(
            f"a person number {i}\nwith short hair\n")
        (texts / "emotion" / f"{name}.txt").write_text("neutral emotion")
        if i != 1:
            (texts / "light_dir" / f"{name}.txt").write_text(" light from the left ")
        if i == 2:
            continue
        vw = cv2.VideoWriter(str(videos / f"{name}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                             8, (64, 48))
        rng = np.random.RandomState(i)
        for _ in range(5 if i == 3 else 8):
            vw.write(rng.randint(0, 255, (48, 64, 3), np.uint8))
        vw.release()
    return texts, videos


@pytest.mark.parametrize("ext", ["h5", "vshard"])
def test_preprocess_matches_jax(tmp_path, ext):
    """python -m dalle2_video_tpu_torch.data.preprocess on a corpus gives
    the JAX run's store (CLIP-normalised (3, 8, 32, 32) clips) and tokens
    bit for bit; the store feeds the dataset."""
    from dalle2_video_tpu.data.preprocess import PreprocessConfig as JaxConfig
    from dalle2_video_tpu.data.preprocess import run as jax_run
    from dalle2_video_tpu_torch.data import preprocess

    texts, videos = _corpus(tmp_path)
    out = {k: tmp_path / k for k in ("port", "jax")}
    preprocess.main([f"texts.root={texts}", f"videos.root={videos}",
                     f"videos.preprocessed={out['port'] / f'videos.{ext}'}",
                     f"texts.tokenized={out['port'] / 'tokens.npy'}",
                     "seq_len=1", "fps=8", "frame_size=32", "log_level=WARNING"])
    count, _, _ = jax_run(JaxConfig(
        texts_root=str(texts), videos_root=str(videos),
        out_h5=str(out["jax"] / f"videos.{ext}"), out_tokens=str(out["jax"] / "tokens.npy"),
        seq_len=1, fps=8, frame_size=32))
    assert count == 2
    np.testing.assert_array_equal(np.load(out["port"] / "tokens.npy"),
                                  np.load(out["jax"] / "tokens.npy"))
    np.save(tmp_path / "emb.npy", np.zeros((2, 4), np.float32))
    got, want = (CelebVTextDataset(video_embeds_path=str(tmp_path / "emb.npy"),
                                   videos_path=str(out[k] / f"videos.{ext}"))
                 for k in ("port", "jax"))
    assert len(got) == len(want) == 2
    g, w = got.load_videos(np.array([1, 0])), want.load_videos(np.array([1, 0]))
    assert g.shape == (2, 8, 32, 32, 3) and g.dtype == np.float32
    np.testing.assert_array_equal(g, w)
    assert g.min() < -1.0 and g.max() > 1.0  # CLIP-normalised, not [0, 1]
    if ext == "vshard":
        assert ((out["port"] / "videos.vshard").read_bytes()
                == (out["jax"] / "videos.vshard").read_bytes())


# ------------------------------------------------------------ the entry point
_TRAIN_CASES = [("h5", "grain"), ("h5", "thread"), ("vshard", "grain"), ("vshard", "thread")]


@pytest.mark.parametrize("store,loader", _TRAIN_CASES, ids=[f"{s}-{l}" for s, l in _TRAIN_CASES])
def test_train_entry_point_trains_from_a_store(stores, tmp_path, store, loader):
    """python -m dalle2_video_tpu_torch.train configs/celebv_text.yaml
    videos.preprocessed=<store> videos.embed=<npy>, without smoke, at the
    smoke widths on the CPU: 2 steps of batch 2 a unet (max_steps, which
    leaves the epoch's loader early), the 2-clip validation, a checkpoint."""
    from dalle2_video_tpu_torch.train import load_latest
    from dalle2_video_tpu_torch.train.__main__ import main as train_main

    unet = ["dim_mults=[1,2]", "num_resnet_blocks=1", "attn_heads=2", "attn_dim_head=8"]
    train_main(["configs/celebv_text.yaml", f"videos.preprocessed={stores[store]}",
                f"videos.embed={stores['embeds']['npy']}", f"loader={loader}",
                "loader_workers=2", "device=cpu", f"run_dir={tmp_path}", "dim=16",
                "frame_sizes=[4,8]", "frame_numbers=[2,2]", "decoder.batch_size=2", "max_steps=2",
                "decoder.epochs=1", "decoder.bf16_compute=false", "log_level=WARNING",
                "unet1.dim=16", "unet2.dim=8", *(f"unet{u}.{k}" for u in (1, 2) for k in unet)])
    state = load_latest(str(tmp_path / "decoder_default"))
    assert state["steps"] == [2, 2]
    lines = [json.loads(line) for line in
             (tmp_path / "decoder_default.metrics.jsonl").read_text().splitlines()]
    assert [sorted(k for k in line if "/" in k) for line in lines] == [
        ["train/loss_unet1", "train/loss_unet2"], ["val/loss_unet1", "val/loss_unet2"]]
    assert all(np.isfinite(v) for line in lines for k, v in line.items() if "/" in k)
