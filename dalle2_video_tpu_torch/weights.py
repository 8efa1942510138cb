"""Carry JAX (flax) parameters into the port's modules.

``params_from_jax(tree)`` turns a flax parameter tree of numpy arrays into a
PyTorch state dict: names are the ``.``-joined flax path, and

  * ``kernel`` (2-D, flax Dense ``(in, out)``) -> ``weight`` ``(out, in)``;
  * ``kernel`` (4-D, flax conv HWIO)          -> ``weight`` OIHW;
  * ``kernel`` (3-D, flax 1-D conv (k, in, out), the temporal conv of
    ``arch: temporal_conv``)                    -> ``weight`` (out, in, k);
  * ``scale`` (LayerNorm / GroupNorm)         -> ``weight``;
  * every other leaf keeps its name and layout (``bias``, ``null_kv``,
    ``PixelShuffleUpsample3D.conv`` -- its ``(C, 4*dim_out)`` matrix, which
    the port reshapes itself --, ``token_embedding`` ...).

``load_from_jax(module, tree)`` then loads it strictly: every JAX leaf must
land on exactly one parameter of the module and every parameter must be
filled, with matching shapes, or it raises. So a unet built for per-frame
video embeds (``video_frame_to_token``, ``null_video_frame_token``) refuses
a tree initialised for global ones (``video_to_tokens``,
``null_video_embed``) and the other way round, and the text parameters
(``text_to_cond``, ``null_text_embed``; the prior's ``enc_proj``,
``null_text_encodings``) come across by name like the rest. The JAX side
supplies the numpy tree (tests); the card never needs JAX.

``load_train_state_from_jax(trainer, state)`` carries a whole JAX decoder
``TrainState`` into a ``DecoderTrainer`` the same strict way: params, EMA
shadows and steps, and the optax Adam moments ``mu`` / ``nu`` with their
``count`` as AdamW's ``exp_avg`` / ``exp_avg_sq`` / ``step``.
``load_clip_train_state_from_jax`` does the same for a ``ClipTrainState``
into a ``ClipTrainer`` (the ViViT's params, the temperature, the moments of
both, the step), ``load_prior_train_state_from_jax`` for the prior's
training state (params, Adam moments, EMA shadow) into a ``PriorTrainer``,
``load_distill_state_from_jax`` a ``DistillState`` (student, EMA, Adam
moments, step) into a ``DistillTrainer``. A VAE's tree nests one flax
``params`` collection per part (``{"encoder": {"params": ...}, "vq": ...,
"decoder": ...}``): those levels drop out of the names, so ``load_from_jax``
takes ``ConvVAE`` / ``VQVAE`` (and ``PatchDiscriminator``) trees as they
are; a latent stage's ``vae_{i}`` rides in the decoder's and the distill
states, and ``load_vqgan_train_state_from_jax`` carries a
``VQGanTrainState`` (both Adam states with their counts, ``vq_ema``, step)
into a ``VQGanTrainer``.

The prior's stacked layout (``scan_layers``: flax nn.scan's ``layers``
subtree, every leaf with a leading depth axis) converts slice by slice and
stays stacked; the mixture-of-experts leaves ``experts_w1`` / ``experts_w2``
((e, d, h) and (e, h, d), stacked or not) keep their layout, the router is
a Dense kernel like any other.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

# the subtree name of flax nn.scan's stacked layers (the prior's
# ``scan_layers``): its leaves carry a leading depth axis
STACKED = "layers"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            # a nested flax collection (a VAE part's {"params": ...}) adds
            # no name
            out.update(_flatten(v, prefix if k == "params" else name))
        else:
            out[name] = np.asarray(v)
    return out


def _leaf_from_jax(name: str, arr: np.ndarray):
    head, _, leaf = name.rpartition(".")
    if leaf == "kernel":
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        else:
            raise ValueError(f"{name}: kernel of rank {arr.ndim}")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    return (f"{head}.{leaf}" if head else leaf), arr


def params_from_jax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name, arr in _flatten(tree).items():
        if STACKED in name.split("."):
            # the nn.scan layout: each slice of the leading depth axis is
            # one layer's leaf
            slices = [_leaf_from_jax(name, a) for a in arr]
            key, arr = slices[0][0], np.stack([a for _, a in slices])
        else:
            key, arr = _leaf_from_jax(name, arr)
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


def _set_adam(optimizer: torch.optim.Optimizer, own: Mapping[str, torch.Tensor],
              mu: Mapping[str, torch.Tensor], nu: Mapping[str, torch.Tensor],
              count) -> None:
    """optax scale_by_adam's mu, nu and count as the torch Adam / AdamW
    state of the parameters ``own`` (by name)."""
    optimizer.state.clear()
    step = float(np.asarray(count))
    for k, p in own.items():
        # copies: the optimiser updates its moments in place and must never
        # write into memory the caller still reads (a JAX state's buffers)
        optimizer.state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                              "exp_avg": mu[k].to(p, copy=True),
                              "exp_avg_sq": nu[k].to(p, copy=True)}


def _load_ema(ema, tree, what: str) -> None:
    if (tree is None) != (ema is None):
        raise ValueError(f"{what}: EMA present in one of state and trainer only")
    if tree is not None:
        for k, v in _strict(tree["params"], ema.params, what).items():
            ema.params[k].copy_(v)
        ema.step = int(np.asarray(tree["step"]))


@torch.no_grad()
def load_clip_train_state_from_jax(trainer, state: Mapping[str, Any]) -> None:
    """Strict load of a JAX ClipTrainState, given as numpy trees:
    ``{"vivit_params": flax params, "temperature": scalar, "opt_state":
    {"mu": {"vivit": tree, "temp": scalar}, "nu": ..., "count": int},
    "step": int}``."""
    load_from_jax(trainer.vivit, state["vivit_params"])
    trainer.temperature.copy_(torch.as_tensor(np.asarray(state["temperature"])))
    own = dict(trainer.vivit.named_parameters())
    opt = state["opt_state"]
    moments = []
    for m in ("mu", "nu"):
        if set(opt[m]) != {"vivit", "temp"}:
            raise ValueError(f"opt_state {m} holds {sorted(opt[m])}, not vivit and temp")
        sd = dict(_strict(opt[m]["vivit"], own, f"vivit {m}"))
        sd["temperature"] = torch.tensor(np.asarray(opt[m]["temp"]), dtype=torch.float32)
        moments.append(sd)
    _set_adam(trainer.optimizer, {**own, "temperature": trainer.temperature}, *moments,
              opt["count"])
    trainer.step = int(np.asarray(state["step"]))


@torch.no_grad()
def load_prior_train_state_from_jax(trainer, state: Mapping[str, Any]) -> None:
    """Strict load of the JAX prior's training state, given as numpy trees:
    ``{"params": flax params, "opt_state": {"mu", "nu": trees, "count":
    int}, "ema": {"params": tree, "step": int} or None, "step": int}``. The
    trees are whole; a trainer placed on a mesh keeps each rank's blocks
    (``PriorTrainer.local``)."""
    net = trainer.prior.network
    own = dict(net.named_parameters())
    whole = {k: torch.empty(trainer.whole_shape(k, p), device="meta") for k, p in own.items()}

    def local(tree, what):
        return {k: trainer.local(k, v) for k, v in _strict(tree, whole, what).items()}

    net.load_state_dict(local(state["params"], "prior params"), strict=True)
    opt = state["opt_state"]
    _set_adam(trainer.optimizer, own, local(opt["mu"], "prior mu"),
              local(opt["nu"], "prior nu"), opt["count"])
    if (state["ema"] is None) != (trainer.ema is None):
        raise ValueError("prior ema: EMA present in one of state and trainer only")
    if trainer.ema is not None:
        for k, v in local(state["ema"]["params"], "prior ema").items():
            trainer.ema.params[k].copy_(v)
        trainer.ema.step = int(np.asarray(state["ema"]["step"]))
    trainer.step = int(np.asarray(state["step"]))


@torch.no_grad()
def load_train_state_from_jax(trainer, state: Mapping[str, Any]) -> None:
    """Strict load of a JAX decoder TrainState, given as numpy trees:
    ``{"params": {"unet_<i>": flax params[, "vae_<i>": a latent stage's VAE
    tree]}, "opt_states": [{"mu", "nu":
    flax trees, "count": int}] per unet, "ema": [{"params": tree, "step":
    int} or None] per unet, "steps": [int] per unet}``. A state the JAX
    ``shard_state`` placed (ZeRO-1, tensor-parallel columns) gives the same
    trees (``np.asarray`` gathers a sharded leaf); load it into the trainer
    on one device, then place it on the mesh with
    ``parallel.sharded.shard_state``."""
    n = trainer.num_unets
    for key in ("opt_states", "ema", "steps"):
        if len(state[key]) != n:
            raise ValueError(f"{key}: {len(state[key])} entries for {n} unets")
    vaes = trainer.decoder.vaes
    want = {f"unet_{i}" for i in range(n)} | {f"vae_{i}" for i in range(n)
                                               if vaes[i].is_latent}
    if set(state["params"]) != want:
        raise ValueError(f"params hold {sorted(state['params'])}, not {sorted(want)}")
    for i, vae in enumerate(vaes):
        if vae.is_latent:
            load_from_jax(vae, state["params"][f"vae_{i}"])
    for i, unet in enumerate(trainer.decoder.unets):
        load_from_jax(unet, state["params"][f"unet_{i}"])
        own = dict(unet.named_parameters())
        opt = state["opt_states"][i]
        _set_adam(trainer.optimizers[i], own, _strict(opt["mu"], own, f"unet_{i} mu"),
                  _strict(opt["nu"], own, f"unet_{i} nu"), opt["count"])
        _load_ema(trainer.ema[i], state["ema"][i], f"unet_{i} ema")
    trainer.steps = [int(np.asarray(s)) for s in state["steps"]]
    trainer.decoder._sampling_unets.clear()


@torch.no_grad()
def load_distill_state_from_jax(trainer, state: Mapping[str, Any]) -> None:
    """Strict load of a JAX DistillState into a ``DistillTrainer`` after its
    ``init_state`` (the template), given as numpy trees: ``{"student": flax
    params, "ema": flax params, "opt_state": {"mu", "nu": trees, "count":
    int}, "step": int}``, and on a latent stage ``"vae_<i>"``: the
    teacher's VAE (the JAX teacher params' subtree), into the decoder's."""
    if trainer.student is None:
        raise ValueError("init_state first: the state loads into its template")
    vae_key = f"vae_{trainer.i}"
    vae = trainer.decoder.vaes[trainer.i]
    if (vae_key in state) != vae.is_latent:
        raise ValueError(f"{vae_key}: a latent stage's state carries its VAE, a pixel "
                         "stage's none")
    if vae.is_latent:
        load_from_jax(vae, state[vae_key])
    for key in ("student", "ema"):
        own = getattr(trainer, key)
        for k, v in _strict(state[key], own, f"distill {key}").items():
            own[k].copy_(v)
    opt = state["opt_state"]
    own = trainer.student
    _set_adam(trainer.optimizer, own, _strict(opt["mu"], own, "distill mu"),
              _strict(opt["nu"], own, "distill nu"), opt["count"])
    trainer.step = int(np.asarray(state["step"]))


@torch.no_grad()
def load_vqgan_train_state_from_jax(trainer, state: Mapping[str, Any]) -> None:
    """Strict load of a JAX VQGanTrainState into a ``VQGanTrainer``, given
    as numpy trees: ``{"vae_params": VQVAE tree, "disc_params": flax
    params, "opt_g": {"mu", "nu": trees, "count": int}, "opt_d": ...,
    "step": int, "vq_ema": {"cluster_size", "embed_avg"} or None}``. With
    ``codebook_ema`` the codebook is a buffer outside the optimiser: its
    JAX moments must be zero (it never has a gradient) and are dropped."""
    load_from_jax(trainer.vae, state["vae_params"])
    load_from_jax(trainer.disc, state["disc_params"])
    for opt, module, key in ((trainer.opt_g, trainer.vae, "opt_g"),
                             (trainer.opt_d, trainer.disc, "opt_d")):
        own = dict(module.named_parameters())
        full = {**own, **dict(module.named_buffers())}
        moments = []
        for m in ("mu", "nu"):
            sd = _strict(state[key][m], full, f"{key} {m}")
            for k in set(sd) - set(own):
                if bool(sd.pop(k).any()):
                    raise ValueError(f"{key} {m} {k}: non-zero moments of a buffer")
            moments.append(sd)
        _set_adam(opt, own, *moments, state[key]["count"])
    trainer.step = int(np.asarray(state["step"]))
    ema = state["vq_ema"]
    if (ema is None) != (trainer.vq_ema is None):
        raise ValueError("vq_ema present in one of state and trainer only")
    if ema is not None:
        if set(ema) != {"cluster_size", "embed_avg"}:
            raise ValueError(f"vq_ema holds {sorted(ema)}")
        trainer.vq_ema = {k: torch.as_tensor(np.array(v, np.float32)).to(trainer.device)
                          for k, v in ema.items()}
