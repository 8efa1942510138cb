"""Checkpointing of the full training state (port of
dalle2_video_tpu/train/checkpoint.py, with ``torch.save`` in place of orbax).

A checkpoint is a directory holding ``state.pt`` (whatever state dict the
caller saves -- ``DecoderTrainer.state_dict()``: params, optimiser states,
EMA shadows, step counts) and a ``framework_version`` stamp. Saves are
synchronous and atomic (written to a temporary name, then renamed), so a
crash never leaves half a checkpoint under a step's name.

``RollingCheckpointManager`` keeps the newest ``max_to_keep`` steps under
``recent/``, the ``best_k`` steps by a metric (min mode) under ``best/``,
and every ``keep_period``-th step permanently. ``PreemptionGuard`` turns
SIGTERM into a flag the training loop polls, then saves and exits 143.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from dalle2_video_tpu_torch import __version__

logger = logging.getLogger("dalle2_video_tpu_torch")

_VERSION_KEY = "framework_version"
_STATE = "state.pt"
_METRICS = "metrics.json"


def save_checkpoint(path: str, state: Any, *, metrics: Optional[dict] = None) -> None:
    """Write ``state`` (and optional metrics) as one checkpoint directory,
    replacing any checkpoint already at ``path``."""
    path = Path(path).absolute()
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    torch.save(state, tmp / _STATE)
    (tmp / _VERSION_KEY).write_text(__version__)
    if metrics is not None:
        (tmp / _METRICS).write_text(json.dumps(metrics))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location: Any = "cpu") -> Any:
    """The state saved at ``path`` (warns on a version mismatch). Only
    checkpoints this program wrote should be loaded: the file is a pickle."""
    path = Path(path).absolute()
    vfile = path / _VERSION_KEY
    if vfile.exists() and vfile.read_text() != __version__:
        logger.warning("loading checkpoint written by version %s; current version is %s",
                       vfile.read_text(), __version__)
    return torch.load(path / _STATE, map_location=map_location, weights_only=False)


def _steps(directory: Path) -> List[int]:
    if not directory.exists():
        return []
    return sorted(int(p.name) for p in directory.iterdir()
                  if p.is_dir() and p.name.isdigit() and (p / _STATE).exists())


class RollingCheckpointManager:
    """Step-indexed checkpoints with newest-K, best-K and keep-period
    retention (see module docstring)."""

    def __init__(self, directory: str, *, max_to_keep: int = 3, best_k: int = 1,
                 metric_key: str = "val_loss", keep_period: Optional[int] = None):
        self._dir = Path(directory).absolute()
        self._recent = self._dir / "recent"
        self._best = self._dir / "best"
        self._recent.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.best_k = best_k
        self.metric_key = metric_key
        self.keep_period = keep_period
        vfile = self._dir / _VERSION_KEY
        if vfile.exists():
            recorded = vfile.read_text().strip()
            if recorded != __version__:
                logger.warning("checkpoint dir %s was written by version %s (current: %s)",
                               self._dir, recorded, __version__)
        else:
            vfile.write_text(__version__)

    @property
    def directory(self) -> Path:
        return self._dir

    def save(self, step: int, state: Any, metrics: Optional[dict] = None) -> None:
        save_checkpoint(str(self._recent / str(step)), state, metrics=metrics)
        kept = _steps(self._recent)
        for s in kept[:max(len(kept) - self.max_to_keep, 0)]:
            if not (self.keep_period and s % self.keep_period == 0):
                shutil.rmtree(self._recent / str(s))
        if self.best_k and metrics and self.metric_key in metrics:
            best = self._best_metrics()
            worst = max(best.values()) if len(best) >= self.best_k else None
            if worst is None or metrics[self.metric_key] < worst:
                save_checkpoint(str(self._best / str(step)), state, metrics=metrics)
                best[step] = metrics[self.metric_key]
                for s in sorted(best, key=lambda k: (best[k], -k))[self.best_k:]:
                    shutil.rmtree(self._best / str(s))

    def _best_metrics(self) -> Dict[int, float]:
        out = {}
        for s in _steps(self._best):
            m = self._best / str(s) / _METRICS
            if m.exists():
                vals = json.loads(m.read_text())
                if self.metric_key in vals:
                    out[s] = vals[self.metric_key]
        return out

    def latest_step(self) -> Optional[int]:
        steps = _steps(self._recent)
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        best = self._best_metrics()
        return min(best, key=lambda k: (best[k], -k)) if best else None

    def all_steps(self) -> List[int]:
        return _steps(self._recent)

    def restore_latest(self, map_location: Any = "cpu") -> Any:
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        return load_checkpoint(str(self._recent / str(step)), map_location)

    def restore_best(self, map_location: Any = "cpu") -> Any:
        step = self.best_step()
        if step is None:
            return self.restore_latest(map_location)
        return load_checkpoint(str(self._best / str(step)), map_location)


class PreemptionGuard:
    """SIGTERM (by default) only sets a flag; the training loop polls
    ``preempted`` at batch boundaries and calls ``emergency_save``, which
    writes a checkpoint and a ``PREEMPTED`` marker before the loop exits
    with ``EXIT_CODE`` (143) so a supervisor restarts it with resume."""

    EXIT_CODE = 128 + signal.SIGTERM

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._received: Optional[int] = None
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handle)

    def _handle(self, signum, frame):  # noqa: ARG002 -- signal API
        self._received = signum
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def emergency_save(self, mgr: RollingCheckpointManager, step: int, state: Any,
                       metrics: Optional[dict] = None) -> None:
        if mgr.latest_step() != step:
            mgr.save(step, state, metrics=metrics)
        (mgr.directory / "PREEMPTED").write_text(str(step))
        logger.warning("preemption (signal %s): emergency checkpoint at step %d",
                       self._received, step)

    def restore_handlers(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)


def has_checkpoint(path: str) -> bool:
    """A rolling directory with a step, or a single checkpoint directory."""
    p = Path(path).absolute()
    return bool(_steps(p / "recent")) or (p / _STATE).exists()


def load_latest(path: str, map_location: Any = "cpu") -> Any:
    """Newest state under ``path``, whichever layout."""
    p = Path(path).absolute()
    if (p / "recent").exists():
        return RollingCheckpointManager(str(p)).restore_latest(map_location)
    return load_checkpoint(str(p), map_location)
