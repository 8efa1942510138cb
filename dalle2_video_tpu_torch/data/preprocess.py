"""Offline CelebV-Text preprocessing: mp4 clips + caption files -> a video
store + tokenised captions (port of dalle2_video_tpu/data/preprocess.py and
scripts/preprocess.py).

    python -m dalle2_video_tpu_torch.data.preprocess [configs/celebv_text.yaml] [key=value ...]

For every caption file under ``texts.root/<details_dir>`` (sorted, at most
``limit``) with an mp4 of the same name under ``videos.root``: the first
``seq_len * fps`` frames are decoded (OpenCV, else imageio; shorter or
unreadable clips are skipped), each frame's shorter side resized to
``frame_size`` (bicubic), centre-cropped, scaled to [0, 1] and normalised
with the CLIP mean / std, and the clip appended as (3, T, S, S) f32 to
``videos.preprocessed``: an h5 store (dataset "videos", chunked one clip a
chunk) or, for a ``.vshard`` path, the port's fixed-record store. The six
caption sources of a clip are joined and tokenised to ``texts.tokenized``
((N, 77) int32, the port's tokenizer).

A host step: it never touches the card. cv2 (or imageio) and, for an h5
store, h5py are imported when used, and their absence raises.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("dalle2_video_tpu_torch.data")

# OpenAI CLIP's normalisation constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

ADDITIONAL_CAPTION_DIRS = ("action_dur", "emotion", "light_dir", "light_intensity",
                           "light_color_temp")


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    texts_root: str
    videos_root: str
    details_dir: str = "face40_details_new"
    additional_dirs: Sequence[str] = ADDITIONAL_CAPTION_DIRS
    out_h5: str = "data/videos/chunked.h5"  # an h5 or a .vshard store
    out_tokens: str = "data/texts/tokenized.npy"
    seq_len: int = 5  # seconds
    fps: int = 30
    frame_size: int = 224
    normalize: bool = True  # CLIP mean / std
    limit: Optional[int] = None
    bpe_path: Optional[str] = None


def load_text(name: str, cfg: PreprocessConfig) -> str:
    """The clip's caption: its details file, then each additional source
    that has a file for it, lines joined by spaces."""
    root = Path(cfg.texts_root)
    parts: List[str] = list((root / cfg.details_dir / f"{name}.txt").read_text()
                            .strip().splitlines())
    for d in cfg.additional_dirs:
        p = root / d / f"{name}.txt"
        if p.exists():
            parts.extend(p.read_text().strip().splitlines())
    return " ".join(s.strip() for s in parts if s.strip())


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise ImportError("preprocessing resizes frames with OpenCV (cv2)") from exc
    return cv2


def _decode_frames_cv2(path: str, num_frames: int) -> Optional[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while len(frames) < num_frames:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.stack(frames) if frames else None


def _decode_frames_imageio(path: str, num_frames: int) -> Optional[np.ndarray]:
    try:
        import imageio.v3 as iio
    except ImportError as exc:
        raise ImportError("decoding mp4s needs OpenCV (cv2) or imageio") from exc
    frames = []
    for i, frame in enumerate(iio.imiter(path)):
        if i >= num_frames:
            break
        frames.append(np.asarray(frame)[..., :3])
    return np.stack(frames) if frames else None


def decode_frames(path: str, num_frames: int) -> Optional[np.ndarray]:
    """The first ``num_frames`` RGB frames (t, h, w, 3) uint8, or None."""
    try:
        return _decode_frames_cv2(path, num_frames)
    except ImportError:
        return _decode_frames_imageio(path, num_frames)


def preprocess_frames(frames: np.ndarray, size: int, normalize: bool) -> np.ndarray:
    """(t, h, w, 3) uint8 -> (3, t, size, size) f32: the shorter side
    resized to ``size`` (cv2 INTER_CUBIC), centre crop, / 255, CLIP mean /
    std if ``normalize``."""
    cv2 = _cv2()
    t, h, w, _ = frames.shape
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    y0, x0 = (nh - size) // 2, (nw - size) // 2
    out = np.empty((t, size, size, 3), np.float32)
    for i in range(t):
        r = cv2.resize(frames[i], (nw, nh), interpolation=cv2.INTER_CUBIC)
        out[i] = r[y0:y0 + size, x0:x0 + size].astype(np.float32) / 255.0
    if normalize:
        out = (out - CLIP_MEAN) / CLIP_STD
    return np.transpose(out, (3, 0, 1, 2))


class _H5Sink:
    """A resizable h5 dataset "videos", one clip a chunk (the reference
    layout)."""

    def __init__(self, path: Path):
        from dalle2_video_tpu_torch.data.datasets import _h5py

        self._f = _h5py().File(path, "w")
        self._dset = None
        self.count = 0

    def append(self, clip: np.ndarray) -> None:
        if self._dset is None:
            self._dset = self._f.create_dataset(
                "videos", shape=(0, *clip.shape), maxshape=(None, *clip.shape),
                chunks=(1, *clip.shape), dtype=np.float32)
        self._dset.resize(self.count + 1, axis=0)
        self._dset[self.count] = clip
        self.count += 1

    def close(self) -> None:
        self._f.close()


class _ShardSink:
    """A .vshard store of f32 clips, opened at the first clip's shape."""

    def __init__(self, path: Path):
        self._path = path
        self._w = None
        self.count = 0

    def append(self, clip: np.ndarray) -> None:
        if self._w is None:
            from dalle2_video_tpu_torch.data.shards import ShardWriter

            self._w = ShardWriter(self._path, clip.shape, np.float32)
        self._w.append(clip)
        self.count = self._w.count

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


def run(cfg: PreprocessConfig) -> Tuple[int, str, str]:
    """Process the corpus; returns (clips written, store path, tokens path).
    The store's format follows ``out_h5``'s extension (.vshard, else h5)."""
    from dalle2_video_tpu_torch.data.tokenizer import get_tokenizer, tokenize

    num_frames = cfg.seq_len * cfg.fps
    details = sorted((Path(cfg.texts_root) / cfg.details_dir).glob("*.txt"))
    if cfg.limit:
        details = details[:cfg.limit]
    out_store, out_tokens = Path(cfg.out_h5), Path(cfg.out_tokens)
    out_store.parent.mkdir(parents=True, exist_ok=True)
    out_tokens.parent.mkdir(parents=True, exist_ok=True)
    tok = get_tokenizer(cfg.bpe_path)
    texts: List[str] = []
    sink = _ShardSink(out_store) if str(out_store).endswith(".vshard") else _H5Sink(out_store)
    try:
        for txt_file in details:
            name = txt_file.stem
            video_path = Path(cfg.videos_root) / f"{name}.mp4"
            if not video_path.exists():
                log.warning("missing video for %s, skipping", name)
                continue
            frames = decode_frames(str(video_path), num_frames)
            if frames is None or len(frames) < num_frames:
                log.warning("short or unreadable video %s, skipping", name)
                continue
            sink.append(preprocess_frames(frames, cfg.frame_size, cfg.normalize))
            texts.append(load_text(name, cfg))
            if sink.count % 50 == 0:
                log.info("processed %d clips", sink.count)
    finally:
        sink.close()
    np.save(out_tokens, tokenize(texts, truncate=True, tokenizer=tok))
    log.info("wrote %d clips -> %s, tokens -> %s", sink.count, out_store, out_tokens)
    return sink.count, str(out_store), str(out_tokens)


def main(argv=None) -> None:
    from dalle2_video_tpu_torch.utils.config import config_from_argv

    cfg = config_from_argv(argv)
    logging.basicConfig(level=cfg.get("log_level", "INFO"))
    count, store, tokens = run(PreprocessConfig(
        texts_root=cfg["texts"]["root"], videos_root=cfg["videos"]["root"],
        details_dir=cfg["texts"].get("details_dir", "face40_details_new"),
        out_h5=cfg["videos"]["preprocessed"], out_tokens=cfg["texts"]["tokenized"],
        seq_len=cfg["seq_len"], fps=cfg["fps"], frame_size=cfg["frame_size"],
        limit=cfg.get("limit"), bpe_path=cfg.get("bpe_path")))
    print(f"preprocessed {count} clips -> {store}, tokens -> {tokens}")


if __name__ == "__main__":
    main()
