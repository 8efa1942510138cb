"""Crash and hang supervisor for a training entry point (the counterpart of
scripts/run_elastic.py).

    python -m dalle2_video_tpu_torch.train.elastic [--max-restarts 10] \
        [--hang-secs 3600] [--watch GLOB] [--backoff 10] -- \
        python -m dalle2_video_tpu_torch.train train_name=prod

- A child that exits non-zero is started again after a backoff of
  ``backoff * 2^(restart - 1)`` seconds (at most 600), up to
  ``--max-restarts`` restarts; every restart appends ``resume=true``, so
  the entry point restores its latest checkpoint.
- A child whose heartbeat goes stale for ``--hang-secs`` is hung: it gets
  SIGTERM by its exact PID (the port's entry points save and exit 143 on
  it: ``train/checkpoint.py::PreemptionGuard``), is killed 60 s later if
  still alive, is reaped, and starts again as after a crash.
- The heartbeat is the newest mtime of the files the ``--watch`` glob
  matches, polled every 30 s. By default the glob is this run's own
  files, ``<run_dir>/*<train_name>*`` (``utils/logging.py::MetricsLogger``
  writes ``<name>.metrics.jsonl`` there and touches ``<name>.heartbeat``
  every few seconds of training), from the command's ``run_dir=`` /
  ``train_name=`` overrides first, then its YAML (the built-in celebv_text
  settings without one; ``utils/config.py::load_config``), so a sibling
  run in the same directory cannot mask a hang. Without a train name it
  falls back to ``<run_dir>/**/*.jsonl`` and warns.
"""

from __future__ import annotations

import argparse
import glob
import os
import signal
import subprocess
import sys
import time
from typing import Iterable, List, Optional, Sequence

POLL_SECS = 30.0
KILL_WAIT_SECS = 60.0


def newest_mtime(patterns: Iterable[str]) -> float:
    newest = 0.0
    for pat in patterns:
        for f in glob.glob(pat, recursive=True):
            try:
                newest = max(newest, os.path.getmtime(f))
            except OSError:
                pass
    return newest


def watch_glob(cmd: Sequence[str]) -> str:
    """The heartbeat glob of the run ``cmd`` starts (see the module
    docstring)."""
    overrides = dict(a.split("=", 1) for a in cmd if "=" in a and not a.startswith("-"))
    run_dir, train_name = overrides.get("run_dir"), overrides.get("train_name")
    yaml_args = [a for a in cmd if a.endswith((".yaml", ".yml"))]
    if run_dir is None or train_name is None:
        try:
            from dalle2_video_tpu_torch.utils.config import load_config

            ycfg = load_config(yaml_args[0] if yaml_args else None)
            run_dir = run_dir or ycfg.get("run_dir")
            train_name = train_name or ycfg.get("train_name")
        except Exception as e:  # noqa: BLE001 -- a best-effort derivation
            print(f"[elastic] could not read config for watch glob: {e}", flush=True)
    run_dir = run_dir or "runs"
    if train_name:
        return f"{run_dir}/*{train_name}*"
    pattern = f"{run_dir}/**/*.jsonl"
    print(f"[elastic] WARNING: no train_name found; watching {pattern}: concurrent runs in "
          "the same run_dir can mask a hang (pass --watch to pin)", flush=True)
    return pattern


def supervise(cmd: List[str], *, max_restarts: int = 10, hang_secs: float = 3600.0,
              watch: Optional[str] = None, backoff: float = 10.0,
              poll: Optional[float] = None) -> int:
    """Run ``cmd`` until it exits 0, restarting it as the module docstring
    says; returns 0, or the last exit code (1 if none) after giving up.
    ``poll``: seconds between heartbeat checks (``POLL_SECS``)."""
    poll = POLL_SECS if poll is None else poll
    if watch is None:
        watch = watch_glob(cmd)
    print(f"[elastic] heartbeat glob: {watch}", flush=True)
    restarts = 0
    while True:
        start = time.time()
        print(f"[elastic] launch attempt {restarts + 1}: {' '.join(cmd)}", flush=True)
        child = subprocess.Popen(cmd)
        hung = False
        while child.poll() is None:
            time.sleep(poll)
            beat = max(newest_mtime([watch]), start)
            if time.time() - beat > hang_secs:
                print(f"[elastic] heartbeat stale >{hang_secs}s: killing pid {child.pid}",
                      flush=True)
                child.send_signal(signal.SIGTERM)
                try:
                    child.wait(timeout=KILL_WAIT_SECS)
                except subprocess.TimeoutExpired:
                    child.kill()
                    child.wait()  # reap: no zombie, a real returncode
                hung = True
                break
        rc = child.returncode
        if rc == 0 and not hung:
            print("[elastic] run completed cleanly", flush=True)
            return 0
        restarts += 1
        if restarts > max_restarts:
            print(f"[elastic] giving up after {max_restarts} restarts", flush=True)
            return rc or 1
        wait = min(backoff * (2 ** (restarts - 1)), 600.0)
        print(f"[elastic] child exited rc={rc} hung={hung}; restarting in {wait:.0f}s "
              "(resume=true)", flush=True)
        if "resume=true" not in cmd:
            cmd = cmd + ["resume=true"]
        time.sleep(wait)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--hang-secs", type=float, default=3600.0,
                    help="restart if the heartbeat files have not moved for this long")
    ap.add_argument("--watch", default=None,
                    help="glob of heartbeat files (default: the command's run_dir/train_name)")
    ap.add_argument("--backoff", type=float, default=10.0)
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="-- followed by the training command")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given (use: elastic [opts] -- python -m ...)")
    return supervise(list(cmd), max_restarts=args.max_restarts, hang_secs=args.hang_secs,
                     watch=args.watch, backoff=args.backoff)


if __name__ == "__main__":
    sys.exit(main())
