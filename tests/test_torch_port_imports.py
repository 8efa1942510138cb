"""The port stands alone: no module of dalle2_video_tpu_torch imports jax,
flax or the JAX package -- checked by a source scan and by importing every
module in a fresh interpreter that blocks those names."""

from __future__ import annotations

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import dalle2_video_tpu_torch

PKG = Path(dalle2_video_tpu_torch.__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "dalle2_video_tpu")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "dalle2_video_tpu_torch."))


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def test_source_scan_finds_no_banned_import():
    offenders = []
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(PKG)}: {n}" for n in names if _banned(n)]
    assert not offenders, offenders
    assert len(list(PKG.rglob("*.py"))) >= 25
    # the training data path and the request options' modules are among
    # the modules scanned and imported
    assert {f"dalle2_video_tpu_torch.data.{m}" for m in (
        "datasets", "shards", "worker_loader", "preprocess")} <= set(_modules())
    assert {"dalle2_video_tpu_torch.engine.longvideo",
            "dalle2_video_tpu_torch.utils.chunked"} <= set(_modules())
    # and stages 1-2: the CLIP stage, the embeddings handoff, the prior's trainer
    assert {"dalle2_video_tpu_torch.models.vivit", "dalle2_video_tpu_torch.utils.contrastive",
            *(f"dalle2_video_tpu_torch.train.{m}" for m in (
                "clip_trainer", "common", "train_clip", "eval_clip", "train_prior"))} <= set(_modules())
    # and distillation and the prior's experts
    assert {"dalle2_video_tpu_torch.train.distill",
            "dalle2_video_tpu_torch.models.moe"} <= set(_modules())
    # and quality scoring, profiling, the CLIP adapters and the reference import
    assert {"dalle2_video_tpu_torch.utils.fvd", "dalle2_video_tpu_torch.utils.profiling",
            "dalle2_video_tpu_torch.models.clip_adapter",
            "dalle2_video_tpu_torch.models.torch_import"} <= set(_modules())
    # and the latent stage
    assert {*(f"dalle2_video_tpu_torch.models.{m}" for m in ("vae", "vqvae", "discriminator")),
            "dalle2_video_tpu_torch.train.vqgan_trainer",
            "dalle2_video_tpu_torch.train.train_vqgan"} <= set(_modules())
    # and the data and model axes on torch.distributed, the prior's pipeline
    assert {f"dalle2_video_tpu_torch.parallel.{m}" for m in (
        "mesh", "collectives", "sharded", "sp_attention", "pipeline")} | {
        "dalle2_video_tpu_torch.probes.parallel_steps"} <= set(_modules())
    # and the trained-teacher quality path and the README's last entry points
    assert {*(f"dalle2_video_tpu_torch.train.{m}" for m in (
        "train_curve", "eval_quality", "demo_inpaint", "demo_longvideo", "distill_sr_demo",
        "elastic")), "dalle2_video_tpu_torch.serve.sample",
        "dalle2_video_tpu_torch.utils.grid"} <= set(_modules())


def test_every_module_imports_with_jax_blocked():
    script = f"""
import sys
BANNED = {BANNED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BANNED):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import importlib
mods = {_modules()!r}
for m in mods:
    importlib.import_module(m)
assert not [n for n in sys.modules if any(n == b or n.startswith(b + ".") for b in BANNED)]
print(len(mods))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_modules()) >= 25


def test_no_yaml_or_regex_on_the_serving_path():
    """The card's machine may lack PyYAML and regex: the built-in config
    and the byte-fallback tokenizer must import and run without them."""
    script = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("yaml", "regex") or name.startswith(("jax", "flax")):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from dalle2_video_tpu_torch.utils.config import load_config
from dalle2_video_tpu_torch.data.tokenizer import tokenize
import dalle2_video_tpu_torch.serve.__main__, dalle2_video_tpu_torch.serve.stack
cfg = load_config(None, ["frame_numbers=[90,90]"])
assert cfg["frame_numbers"] == [90, 90]
assert tokenize(["hello"]).shape == (1, 77)
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, cwd=str(PKG.parent))
    assert out.returncode == 0, out.stderr
