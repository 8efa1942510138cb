"""Metrics logging: stdout + a JSONL file per run (port of
dalle2_video_tpu/utils/logging.py; wandb is not ported, ``use_wandb``
raises)."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Optional

logger = logging.getLogger("dalle2_video_tpu_torch")


class MetricsLogger:
    """``<run_dir>/<run_name>.metrics.jsonl`` (one record per ``log``), the
    run's config beside it, and a heartbeat file touched at most every 5 s
    so a supervisor can tell a long epoch from a hang."""

    def __init__(self, run_dir: str, run_name: str, use_wandb: bool = False,
                 config: Optional[Dict[str, Any]] = None):
        if use_wandb:
            raise NotImplementedError("wandb logging is not ported; use_wandb must be false")
        self.dir = Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.name = run_name
        self.path = self.dir / f"{run_name}.metrics.jsonl"
        self._f = open(self.path, "a")
        self._hb_time = 0.0
        if config:
            (self.dir / f"{run_name}.config.json").write_text(
                json.dumps(config, indent=2, default=str))

    def heartbeat(self) -> None:
        now = time.time()
        if now - self._hb_time < 5.0:
            return
        self._hb_time = now
        (self.dir / f"{self.name}.heartbeat").touch()

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"time": time.time(), **({"step": step} if step is not None else {})}
        rec.update({k: float(v) if hasattr(v, "item") else v for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        logger.info(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in rec.items() if k != "time"))

    def close(self) -> None:
        self._f.close()
