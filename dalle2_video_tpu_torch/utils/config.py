"""Single-plane config with dotted CLI overrides (port of
dalle2_video_tpu/utils/config.py, without the JAX platform hook).

``CELEBV_TEXT`` holds ``configs/celebv_text.yaml`` as a Python dict, already
interpolated, so the serving entry point and ``chip_smoke.py`` need no YAML
parser; a CPU test holds it equal to the parsed file. A YAML path given on
the command line is still read (PyYAML is imported only then).
"""

from __future__ import annotations

import ast
import copy
import re
from typing import Any, Dict, List, Optional, Sequence

CELEBV_TEXT: Dict[str, Any] = {
    "texts": {
        "root": "data/celebv-text/texts",
        "details_dir": "face40_details_new",
        "tokenized": "data/texts/tokenized.npy",
        "embed": "data/texts/embed.npy",
    },
    "videos": {
        "root": "data/celebv-text/videos",
        "preprocessed": "data/videos/chunked.h5",
        "embed": "data/videos/embed.npy",
    },
    "seq_len": 5,
    "fps": 30,
    "frame_size": 224,
    "dim": 512,
    "channels": 3,
    "train_name": "default",
    "train_ratio": 0.8,
    "seed": 1234,
    "loader": "grain",
    "loader_workers": 4,
    "run_dir": "runs",
    "use_wandb": False,
    "log_level": "INFO",
    "mesh": {"data": -1, "model": 1},
    "video_encoder": {
        "frame_size": 224,
        "patch_size": 56,
        "num_frames": 150,
        "dim": 512,
        "depth": 2,
        "heads": 3,
        "dim_head": 64,
    },
    "clip": {
        "batch_size": 64,
        "lr": 1.0e-3,
        "lr_scheduler": "multistep",
        "lr_multistep_milestones": [0.4, 0.6, 0.8, 0.9],
        "lr_step_gamma": 0.5,
        "epochs": 500,
        "init_temperature": 5.0,
        "openai_ckpt": None,
    },
    "unet1": {
        "dim": 64,
        "dim_mults": [1, 2, 4, 8],
        "num_resnet_blocks": 2,
        "attn_heads": 16,
        "attn_dim_head": 32,
        "attention_impl": "auto",
    },
    "unet2": {
        "dim": 8,
        "dim_mults": [1, 2, 4, 8, 16],
        "num_resnet_blocks": 2,
        "attn_heads": 16,
        "attn_dim_head": 32,
        "attention_impl": "auto",
    },
    "frame_sizes": [64, 128],
    "frame_numbers": [16, 16],
    "timesteps": 1000,
    "sample_timesteps": None,
    "sample_compute_dtype": "bfloat16",
    "learned_variance": False,
    "decoder": {"batch_size": 8, "epochs": 50, "bf16_compute": True},
    "decoder_trainer": {
        "lr": 3.0e-4,
        "wd": 1.0e-2,
        "use_ema": True,
        "ema_beta": 0.99,
        "ema_update_after_step": 1000,
        "ema_update_every": 10,
        "max_grad_norm": 0.5,
        "grad_accum": 1,
    },
    "prior": {
        "depth": 6,
        "heads": 8,
        "dim_head": 64,
        "timesteps": 1000,
        "sample_timesteps": 64,
        "batch_size": 256,
        "lr": 3.0e-4,
        "epochs": 100,
    },
    "vqgan": {
        "batch_size": 8,
        "epochs": 10,
        "frame_size": 64,
        "frames": 4,
        "latent_dim": 4,
        "base_dim": 64,
        "num_down": 2,
        "codebook_size": 512,
        "disc_base_dim": 64,
        "disc_layers": 3,
        "lr_g": 1.0e-4,
        "lr_d": 1.0e-4,
        "disc_start": 1000,
        "disc_weight": 0.8,
        "perceptual_weight": 1.0,
    },
}


def _parse_value(raw: str) -> Any:
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        if raw.lower() in ("true", "false"):
            return raw.lower() == "true"
        if raw.lower() in ("null", "none"):
            return None
        return raw


def apply_overrides(cfg: Dict[str, Any], overrides: Sequence[str]) -> Dict[str, Any]:
    cfg = copy.deepcopy(cfg)
    for tok in overrides:
        if "=" not in tok:
            raise ValueError(f"override {tok!r} must be key=value")
        key, raw = tok.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(raw)
    return cfg


def _interpolate(cfg: Dict[str, Any]) -> Any:
    """Resolve ${dotted.path} references. A value that IS a single
    reference keeps the referent's type; embedded references substitute
    as text."""
    ref_re = re.compile(r"\$\{([^}]+)\}")

    def lookup(path: str):
        node: Any = cfg
        for p in path.split("."):
            node = node[p]
        return resolve(node)

    def resolve(v):
        if isinstance(v, dict):
            return {k: resolve(x) for k, x in v.items()}
        if isinstance(v, list):
            return [resolve(x) for x in v]
        if isinstance(v, str):
            full = ref_re.fullmatch(v)
            if full:
                return lookup(full.group(1))
            return ref_re.sub(lambda m: str(lookup(m.group(1))), v)
        return v

    return resolve(cfg)


def load_config(path: Optional[str], overrides: Sequence[str] = ()) -> Dict[str, Any]:
    """path=None -> the built-in CELEBV_TEXT settings."""
    if path is None:
        cfg = copy.deepcopy(CELEBV_TEXT)
    else:
        import yaml  # only when a YAML file is actually given

        with open(path) as f:
            cfg = yaml.safe_load(f)
    cfg = apply_overrides(cfg, overrides)
    return _interpolate(cfg)


def config_from_argv(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """argv: [config_path?] [key=value ...]; without a path the built-in
    celebv_text settings are used."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    path = None
    overrides = []
    for tok in argv:
        if "=" in tok:
            overrides.append(tok)
        else:
            path = tok
    return load_config(path, overrides)
