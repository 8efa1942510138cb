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

``load_train_state_from_jax(trainer, state)`` carries a whole JAX decoder
``TrainState`` into a ``DecoderTrainer`` the same strict way: params, EMA
shadows and steps, and the optax Adam moments ``mu`` / ``nu`` with their
``count`` as AdamW's ``exp_avg`` / ``exp_avg_sq`` / ``step``.
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


def _strict(tree: Mapping[str, Any], own: Mapping[str, torch.Tensor],
            what: str) -> "OrderedDict[str, torch.Tensor]":
    """params_from_jax(tree), checked to fill every entry of ``own`` exactly
    once with matching shapes."""
    sd = params_from_jax(tree)
    missing = sorted(set(own) - set(sd))
    unused = sorted(set(sd) - set(own))
    if missing or unused:
        raise ValueError(
            f"JAX tree does not match {what}: "
            f"missing {missing[:8]}{'...' if len(missing) > 8 else ''}, "
            f"unused {unused[:8]}{'...' if len(unused) > 8 else ''}"
        )
    for k, v in sd.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"{what} {k}: JAX shape {tuple(v.shape)} vs {tuple(own[k].shape)}")
    return sd


def load_from_jax(module: torch.nn.Module, tree: Mapping[str, Any]) -> torch.nn.Module:
    """Strict load; the module keeps its device and dtype."""
    module.load_state_dict(_strict(tree, module.state_dict(), type(module).__name__),
                           strict=True)
    return module


@torch.no_grad()
def load_train_state_from_jax(trainer, state: Mapping[str, Any]) -> None:
    """Strict load of a JAX decoder TrainState, given as numpy trees:
    ``{"params": {"unet_<i>": flax params}, "opt_states": [{"mu", "nu":
    flax trees, "count": int}] per unet, "ema": [{"params": tree, "step":
    int} or None] per unet, "steps": [int] per unet}``."""
    n = trainer.num_unets
    for key in ("opt_states", "ema", "steps"):
        if len(state[key]) != n:
            raise ValueError(f"{key}: {len(state[key])} entries for {n} unets")
    if set(state["params"]) != {f"unet_{i}" for i in range(n)}:
        raise ValueError(f"params hold {sorted(state['params'])}, not unet_0..unet_{n - 1}")
    for i, unet in enumerate(trainer.decoder.unets):
        load_from_jax(unet, state["params"][f"unet_{i}"])
        own = dict(unet.named_parameters())
        opt = state["opt_states"][i]
        mu = _strict(opt["mu"], own, f"unet_{i} mu")
        nu = _strict(opt["nu"], own, f"unet_{i} nu")
        adam = trainer.optimizers[i]
        adam.state.clear()
        step = float(np.asarray(opt["count"]))
        for k, p in own.items():
            adam.state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                             "exp_avg": mu[k].to(p), "exp_avg_sq": nu[k].to(p)}
        ema = state["ema"][i]
        if (ema is None) != (trainer.ema[i] is None):
            raise ValueError(f"unet_{i}: EMA present in one of state and trainer only")
        if ema is not None:
            shadow = _strict(ema["params"], trainer.ema[i].params, f"unet_{i} ema")
            for k, v in shadow.items():
                trainer.ema[i].params[k].copy_(v)
            trainer.ema[i].step = int(np.asarray(ema["step"]))
    trainer.steps = [int(np.asarray(s)) for s in state["steps"]]
    trainer.decoder._sampling_unets.clear()
