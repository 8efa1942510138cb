"""Carry JAX (flax) parameters into the port's modules.

``params_from_jax(tree)`` turns a flax parameter tree of numpy arrays into a
PyTorch state dict: names are the ``.``-joined flax path, and

  * ``kernel`` (2-D, flax Dense ``(in, out)``) -> ``weight`` ``(out, in)``;
  * ``kernel`` (4-D, flax conv HWIO)          -> ``weight`` OIHW;
  * ``scale`` (LayerNorm / GroupNorm)         -> ``weight``;
  * every other leaf keeps its name and layout (``bias``, ``null_kv``,
    ``PixelShuffleUpsample3D.conv`` -- its ``(C, 4*dim_out)`` matrix, which
    the port reshapes itself --, ``token_embedding`` ...).

``load_from_jax(module, tree)`` then loads it strictly: every JAX leaf must
land on exactly one parameter of the module and every parameter must be
filled, with matching shapes, or it raises. The JAX side supplies the numpy
tree (tests); the card never needs JAX.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def params_from_jax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, arr in _flatten(tree).items():
        head, _, leaf = name.rpartition(".")
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{name}: kernel of rank {arr.ndim}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        key = f"{head}.{leaf}" if head else leaf
        if key in sd:
            raise ValueError(f"two JAX leaves map onto {key}")
        sd[key] = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    return sd


def load_from_jax(module: torch.nn.Module, tree: Mapping[str, Any]) -> torch.nn.Module:
    """Strict load; the module keeps its device and dtype."""
    sd = params_from_jax(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unused = sorted(set(sd) - set(own))
    if missing or unused:
        raise ValueError(
            f"JAX tree does not match {type(module).__name__}: "
            f"missing {missing[:8]}{'...' if len(missing) > 8 else ''}, "
            f"unused {unused[:8]}{'...' if len(unused) > 8 else ''}"
        )
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: JAX shape {tuple(v.shape)} vs {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=True)
    return module
