"""The README's last entry points against the JAX scripts they port:
``serve/sample.py`` (scripts/sample.py: the frame mask, the refusal of a
long video beside inpainting) and ``train/elastic.py``
(scripts/run_elastic.py: the heartbeat glob it derives from the supervised
command, which the script prints).

Port-only: the CLI's ``.npy`` equals ``build_generate_batch``'s video for
the same prompt and seed on the smoke stack (and a request with options
through the same callable); the supervisor restarts a crashing child with
``resume=true``, kills (by its PID) and restarts a hung one whether or not
it honours SIGTERM, and gives up after ``--max-restarts``. Its children
are plain Python without torch. The port runs on one CPU thread.
"""

from __future__ import annotations

import ast
import functools
import glob
import json
import logging
import os
import sys
import unittest.mock as mock
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dalle2_video_tpu_torch.serve import sample, stack
from dalle2_video_tpu_torch.serve.stack import apply_smoke, build_generate_batch
from dalle2_video_tpu_torch.train import elastic
from dalle2_video_tpu_torch.utils.config import config_from_argv

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from scripts import run_elastic as jax_elastic  # noqa: E402


# ------------------------------------------------------------ sample CLI
def _script_frame_mask(frames, t):
    """scripts/sample.py's own statements that build the mask from
    ``inpaint_frames`` (the else branch of ``if cfg.get("inpaint_mask")``),
    run on a known video of t frames."""
    tree = ast.parse((ROOT / "scripts" / "sample.py").read_text())
    branch = next(n for n in ast.walk(tree) if isinstance(n, ast.If)
                  and "inpaint_mask" in ast.unparse(n.test))
    ns = {"cfg": {"inpaint_frames": frames}, "known": np.zeros((1, t, 2, 2, 3), np.float32),
          "np": np}
    exec(compile(ast.Module(branch.orelse, []), "scripts/sample.py", "exec"), ns)
    return ns["mask"]


@pytest.mark.parametrize("frames,t", [("0,1", 16), ("3", 5), ([0, 2, 4], 90), ("1,1", 4)])
def test_frame_mask_matches_the_script(frames, t):
    want = _script_frame_mask(frames, t)
    got = sample.frame_mask(frames, t)
    assert got.dtype == want.dtype and got.shape == want.shape == (1, t, 1, 1, 1)
    assert np.array_equal(got, want)


def test_request_options_and_refusals(tmp_path):
    """The script's option handling: a (T, H, W, C) known video becomes a
    batch of one with the frames' mask; inpaint_video needs a mask or
    frames; a long video (n_frames past the last stage's) refuses
    inpainting before any stack is built, and an n_frames within the
    window is no long video."""
    known = np.random.default_rng(0).random((4, 8, 8, 3), dtype=np.float32)
    np.save(tmp_path / "known.npy", known)
    base = {"frame_numbers": [4, 4], "inpaint_video": str(tmp_path / "known.npy")}
    kw = sample.request_options({**base, "inpaint_frames": "0,1", "negative_prompt": "x"})
    assert kw["inpaint_video"].shape == (1, 4, 8, 8, 3)
    assert np.array_equal(kw["inpaint_mask"], sample.frame_mask("0,1", 4))
    assert (kw["inpaint_method"], kw["inpaint_guidance_weight"]) == ("replace", 10.0)
    assert kw["negative_prompts"] == ["x"]
    with pytest.raises(SystemExit, match="inpaint_mask"):
        sample.request_options(base)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        sample.sample({**base, "inpaint_frames": "0", "n_frames": 9},
                      generate_batch=lambda *a, **k: pytest.fail("the stack was reached"))
    assert "n_frames" not in sample.request_options({**base, "inpaint_frames": "0",
                                                     "n_frames": 4})
    assert sample.request_options({"frame_numbers": [4, 4], "n_frames": 9, "overlap": 2}) == {
        "n_frames": 9, "overlap": 2}


def _script_long_video(cfg, frame_numbers, inpaint):
    """scripts/sample.py's own long-video branch (``n_frames = ...`` and the
    ``if n_frames ...`` statement) on stand-ins: "refused" where it raises,
    else the keywords of the generate_long call it makes (None for a plain
    generate)."""
    tree = ast.parse((ROOT / "scripts" / "sample.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    kept = [n for n in main.body if "n_frames" in ast.unparse(n).split("\n")[0]]
    calls = []
    wrapper = SimpleNamespace(generate_long=lambda *a, **kw: calls.append(kw),
                              generate=lambda *a, **kw: None)
    ns = {"cfg": cfg, "decoder": SimpleNamespace(config=SimpleNamespace(
        frame_numbers=frame_numbers)), "inpaint_kwargs": {"inpaint_video": 0} if inpaint else {},
        "wrapper": wrapper, "prior_params": None, "dec_params": None, "k_gen": None,
        "text_embed": None, "cond_scale": 1.0}
    try:
        exec(compile(ast.Module(kept, []), "scripts/sample.py", "exec"), ns)
    except SystemExit:
        return "refused"
    return {k: calls[0][k] for k in ("n_frames", "overlap")} if calls else None


@pytest.mark.parametrize("n_frames,overlap,inpaint", [
    (9, 2, False), (9, None, False), (4, None, False), (9, None, True), (4, None, True)])
def test_long_video_routing_matches_the_script(n_frames, overlap, inpaint, tmp_path):
    """Past the last stage's frames a request is a long video (its overlap
    passed on) and refuses inpainting, as the script's branch does; within
    them it is a plain request, inpainting or not."""
    cfg = {"frame_numbers": [4, 4], "n_frames": n_frames, "overlap": overlap}
    if inpaint:
        np.save(tmp_path / "known.npy", np.zeros((4, 2, 2, 3), np.float32))
        cfg.update(inpaint_video=str(tmp_path / "known.npy"), inpaint_frames="0")
    want = _script_long_video(cfg, cfg["frame_numbers"], inpaint)
    try:
        kw = sample.request_options(cfg)
    except SystemExit:
        got = "refused"
    else:
        got = {k: kw[k] for k in ("n_frames", "overlap")} if "n_frames" in kw else None
    assert got == want


def test_cli_video_is_the_servers(tmp_path, monkeypatch):
    """python -m ...serve.sample on the smoke stack (2 DDIM steps a stage,
    cond_scale 2; the text tower cut to one layer, which costs seconds a
    build on one thread at 12) writes the float32 (1, T, H, W, C) video that
    build_generate_batch returns for the same prompt at the request seed
    sample_seed, bit for bit; then requests with options (the frames'
    inpainting beside a negative prompt, a long video) through the CLI's
    request handling equal the callable called with the script's keywords."""
    monkeypatch.setattr(stack, "CLIPTextConfig", functools.partial(stack.CLIPTextConfig, layers=1))
    out = tmp_path / "v.npy"
    argv = ["smoke=true", "device=cpu", f"run_dir={tmp_path}", "sample_timesteps=[2,2]",
            "prompt=a person smiling", "sample_seed=5", "cond_scale=2.0", f"out={out}"]
    video = sample.main(argv)
    assert np.array_equal(np.load(out), video)
    cfg = apply_smoke(config_from_argv(argv))
    gb = build_generate_batch(cfg, logging.getLogger("test"), "cpu")
    want = gb(["a person smiling"], [5], cond_scale=2.0, ddim_steps=None)
    assert video.dtype == np.float32 and video.shape == (1, 2, 32, 32, 3)
    assert np.array_equal(video, want)

    np.save(tmp_path / "known.npy", want[0])
    opts = {"inpaint_video": str(tmp_path / "known.npy"), "inpaint_frames": "0",
            "negative_prompt": "a person frowning"}
    got = sample.sample({**cfg, **opts}, generate_batch=gb)
    ref = gb(["a person smiling"], [5], cond_scale=2.0, ddim_steps=None,
             inpaint_video=want, inpaint_mask=sample.frame_mask("0", 2),
             negative_prompts=["a person frowning"])
    assert np.array_equal(got, ref) and np.array_equal(np.load(out), ref)
    assert float(np.abs(got[0, 0] - want[0, 0]).max()) <= 1e-6  # the known frame kept
    long = sample.sample({**cfg, "n_frames": 3, "overlap": 1}, generate_batch=gb)
    assert long.shape == (1, 3, 32, 32, 3)
    assert np.array_equal(long, gb(["a person smiling"], [5], cond_scale=2.0, ddim_steps=None,
                                   n_frames=3, overlap=1))


# ------------------------------------------------------------- elastic
class _Done:
    """A Popen stand-in whose child has already exited 0."""

    def __init__(self, cmd):
        self.pid, self.returncode = 1, 0

    def poll(self):
        return 0


def _script_glob(argv, capsys):
    with mock.patch.object(sys, "argv", ["run_elastic.py", "--", *argv]), \
            mock.patch.object(jax_elastic.subprocess, "Popen", _Done):
        assert jax_elastic.main() == 0
    line = next(x for x in capsys.readouterr().out.splitlines() if "heartbeat glob:" in x)
    return line.split("heartbeat glob: ", 1)[1]


@pytest.mark.parametrize("argv", [
    ["run_dir=r/x", "train_name=prod"],
    ["run_dir=r/x"],
    ["train_name=prod"],
    ["configs/cascade_sr.yaml"],
    ["configs/cascade_sr.yaml", "train_name=sr2", "decoder.batch_size=4"],
    ["{yaml}"],  # a YAML without train_name: the fallback
])
def test_watch_glob_matches_the_script(argv, tmp_path, capsys, monkeypatch):
    """The glob derived from the command's overrides, then its YAML (the
    celebv_text settings without one), equals the one the script prints."""
    monkeypatch.chdir(ROOT)
    (tmp_path / "bare.yaml").write_text("run_dir: some/where\n")
    argv = [str(tmp_path / "bare.yaml") if a == "{yaml}" else a for a in argv]
    cmd = [sys.executable, "-m", "dalle2_video_tpu_torch.train", *argv]
    want = _script_glob(cmd, capsys)
    assert elastic.watch_glob(cmd) == want


CHILD = """
import json, os, signal, sys, time
log, mode = sys.argv[1], sys.argv[2]
attempt = sum(1 for _ in open(log)) if os.path.exists(log) else 0
with open(log, "a") as f:
    f.write(json.dumps({"pid": os.getpid(), "argv": sys.argv[3:]}) + "\\n")
if mode == "crash":
    sys.exit(1 if attempt < 2 else 0)
if mode == "fail":
    sys.exit(3)
if attempt == 0:  # hang: no heartbeat, ever
    if mode == "hang_ignoring_sigterm":
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    else:  # the port's PreemptionGuard: save, then exit 143
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    time.sleep(60)
sys.exit(0)
"""


def _child(tmp_path, mode):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    log = tmp_path / "attempts.jsonl"
    return [sys.executable, str(script), str(log), mode, "train_name=t"], log


def _attempts(log):
    return [json.loads(x) for x in log.read_text().splitlines()]


def _fast(**kw):
    return dict(dict(hang_secs=60.0, watch="nothing/*", backoff=0.01, poll=0.02), **kw)


def test_supervisor_restarts_a_crashing_child_with_resume(tmp_path):
    cmd, log = _child(tmp_path, "crash")
    assert elastic.supervise(cmd, **_fast(max_restarts=5)) == 0
    assert [a["argv"] for a in _attempts(log)] == [
        ["train_name=t"], ["train_name=t", "resume=true"], ["train_name=t", "resume=true"]]


@pytest.mark.parametrize("mode", ["hang_ignoring_sigterm", "hang_exiting_on_sigterm"])
def test_supervisor_kills_and_restarts_a_hung_child(tmp_path, mode, capsys):
    """No heartbeat for hang_secs: SIGTERM to the child's PID, a kill after
    the wait where it ignores it, a reap, then a restart with resume=true."""
    cmd, log = _child(tmp_path, mode)
    with mock.patch.object(elastic, "KILL_WAIT_SECS", 0.3):
        assert elastic.supervise(cmd, **_fast(max_restarts=2, hang_secs=0.5)) == 0
    first, second = _attempts(log)
    assert second["argv"][-1] == "resume=true" and first["argv"] == ["train_name=t"]
    with pytest.raises(ProcessLookupError):  # killed and reaped: not even a zombie
        os.kill(first["pid"], 0)
    rc = -9 if mode == "hang_ignoring_sigterm" else 143
    assert f"child exited rc={rc} hung=True" in capsys.readouterr().out


def test_supervisor_gives_up_after_max_restarts(tmp_path, monkeypatch):
    """Through the CLI: a child that always fails runs 1 + --max-restarts
    times and its exit code comes back; the heartbeat of a busy child
    (its files' mtimes) keeps it alive past hang_secs."""
    cmd, log = _child(tmp_path, "fail")
    monkeypatch.setattr(elastic, "POLL_SECS", 0.02)
    assert elastic.main(["--max-restarts", "2", "--backoff", "0", "--watch", "nothing/*",
                         "--", *cmd]) == 3
    assert len(_attempts(log)) == 3
    beat = tmp_path / "run" / "t.heartbeat"
    beat.parent.mkdir()
    beat.touch()
    assert elastic.newest_mtime([str(tmp_path / "run" / "*t*")]) == os.path.getmtime(beat)
    assert glob.glob(elastic.watch_glob(["x", f"run_dir={tmp_path / 'run'}", "train_name=t"]))
