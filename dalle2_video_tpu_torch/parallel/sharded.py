"""Sharded train and sample steps on ``torch.distributed`` (port of
dalle2_video_tpu/parallel/sharded.py).

Strategy, as the JAX package's (its GSPMD partitioner replaced by explicit
collectives, ``parallel/collectives.py``):
  * batch rows -> ``data`` (DP): each rank runs the trainer's ``backward``
    on its rows (with its rows of the global batch's draws:
    ``utils/keys.py::batch_draw``), the gradients and the loss are
    all-reduced and averaged over the data axis (never over ``model``),
    then every rank runs the trainer's ``apply_update`` on the same numbers
    (clip over the full gradient, a non-finite step skipped on every rank
    alike, the schedule, the EMA);
  * optimiser state -> ZeRO-1 by the JAX rule (``_leaf_zero1_spec``: a
    leaf's largest axis divisible by the data size; small leaves
    replicated), merged with the tensor-parallel column placement over
    ``model`` (``_leaf_tp_spec``) as ``state_shardings``' ``opt_spec``
    merges them: each rank keeps the Adam moments of its block of each
    leaf, updates that block, and the blocks are all-gathered over the
    world so every rank holds every parameter whole for its use (the port
    gathers a tensor-parallel leaf's columns after each update rather than
    computing column-parallel: the step equals the data-parallel one);
  * parameters and EMA shadows whole on every rank.

A ZeRO-1 state saves in the single-device format (``ShardedOptimizer.
state_dict`` gathers the moments: call it on every rank, write on rank 0)
and loads from it at any world size. The sampler factories split a
dispatched group's rows over the data axis and gather the output.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dalle2_video_tpu_torch.parallel.collectives import (
    all_gather_cat,
    all_gather_list,
    all_reduce_,
    all_reduce_sum,
    broadcast_,
)
from dalle2_video_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, active_mesh
from dalle2_video_tpu_torch.utils.keys import RowKeys

Spec = Tuple[Optional[str], ...]  # a mesh axis name (or None) per leading dim


def _leaf_zero1_spec(leaf, data_size: int) -> Spec:
    """ZeRO-1-style spec: shard the largest axis divisible by the data-axis
    size; replicate scalars / small leaves."""
    shape = tuple(getattr(leaf, "shape", ()))
    best_axis, best_len = None, 0
    for ax, ln in enumerate(shape):
        if ln % data_size == 0 and ln > best_len:
            best_axis, best_len = ax, ln
    if best_axis is None or best_len < data_size:
        return ()
    return tuple(DATA_AXIS if ax == best_axis else None for ax in range(best_axis + 1))


def zero1_sharding_tree(tree: Mapping[str, Any], mesh: Mesh) -> Dict[str, Spec]:
    """Spec per leaf of an optimiser-state tree: ZeRO-1 partitioning."""
    return {k: _leaf_zero1_spec(v, mesh.data) for k, v in tree.items()}


def _leaf_tp_spec(leaf, model_size: int, min_width: int = 128) -> Spec:
    """Megatron-style column parallelism: the output-feature (last) axis of
    wide kernels over ``model``; ``min_width`` keeps kernels too narrow to
    be worth the collectives whole."""
    shape = tuple(getattr(leaf, "shape", ()))
    if len(shape) >= 2 and shape[-1] % model_size == 0 and shape[-1] >= min_width:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


def state_shardings(params: Mapping[str, torch.Tensor], mesh: Mesh, tp: bool = False,
                    tp_min_width: int = 128) -> Dict[str, Dict[str, Spec]]:
    """Specs per leaf of a unet's state: ``params`` and ``ema`` replicated
    (or, with ``tp``, tensor-parallel columns over ``model``); ``opt_states``
    the same, plus ZeRO-1 over ``data`` on an axis the columns leave free.
    The port applies only the ``opt_states`` specs: a column spec shards a
    leaf's moments over ``model``, while its parameter and compute stay
    whole on every rank."""
    use_tp = tp and mesh.model > 1

    def param_spec(leaf) -> Spec:
        return _leaf_tp_spec(leaf, mesh.model, tp_min_width) if use_tp else ()

    def opt_spec(leaf) -> Spec:
        nd = leaf.ndim
        t = list(param_spec(leaf)) + [None] * (nd - len(param_spec(leaf)))
        z = list(_leaf_zero1_spec(leaf, mesh.data))
        z += [None] * (nd - len(z))
        t = [a if a is not None else b for a, b in zip(t, z)]
        while t and t[-1] is None:
            t.pop()
        return tuple(t)

    return {"params": {k: param_spec(v) for k, v in params.items()},
            "opt_states": {k: opt_spec(v) for k, v in params.items()},
            "ema": {k: param_spec(v) for k, v in params.items()}}


def block_slices(shape: Sequence[int], spec: Spec, mesh: Mesh, rank: int) -> Tuple[slice, ...]:
    """The slices of ``rank``'s block of a leaf of ``shape`` under ``spec``."""
    coords = mesh.coords(rank)
    out = []
    for dim, n in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        if axis is None:
            out.append(slice(None))
        else:
            per = n // mesh.shape[axis]
            out.append(slice(coords[axis] * per, (coords[axis] + 1) * per))
    return tuple(out)


class ShardedOptimizer:
    """A torch optimiser (AdamW for the decoder) over this rank's blocks of
    its parameters (``specs``: one per parameter, in the optimiser's order):
    ``step`` copies each parameter's block and gradient block, steps the
    inner optimiser on the blocks, and all-gathers the sharded blocks over
    the world into every parameter (replicated leaves are updated whole on
    every rank, identically). ``param_groups`` and ``state`` are the inner
    optimiser's (blocks), so the trainer sets the lr and reads the update
    count as on one device. Built from an optimiser whose state it takes
    over (sliced)."""

    def __init__(self, optimizer: torch.optim.Optimizer, mesh: Mesh, specs: Sequence[Spec]):
        self.mesh = mesh
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        if len(specs) != len(self.params):
            raise ValueError(f"{len(specs)} specs for {len(self.params)} parameters")
        if len({p.dtype for p in self.params}) != 1:
            raise ValueError("a sharded optimiser's parameters must share one dtype")
        self.specs = [tuple(s) for s in specs]
        # leaves split over an axis of more than one rank, and the rest
        split = [any(a is not None and mesh.shape[a] > 1 for a in s) for s in self.specs]
        self.sharded = [i for i, on in enumerate(split) if on]
        self.whole = [i for i, on in enumerate(split) if not on]
        self._slices = [[block_slices(p.shape, s, mesh, r) for r in range(mesh.world)]
                        for p, s in zip(self.params, self.specs)]
        self.blocks = [p.detach()[sl[mesh.rank]].clone() for p, sl in
                       zip(self.params, self._slices)]
        it = iter(self.blocks)
        # each group carries every hyperparameter of the optimiser's
        groups = [dict(g, params=[next(it) for _ in g["params"]]) for g in optimizer.param_groups]
        self.inner = type(optimizer)(groups)
        self.inner.defaults = dict(optimizer.defaults)
        self.load_state_dict(optimizer.state_dict())

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=set_to_none)

    def moment_bytes(self) -> int:
        """Bytes of optimiser state this rank holds (every tensor of the
        inner state but the step counts)."""
        return sum(v.numel() * v.element_size() for st in self.inner.state.values()
                   for k, v in st.items() if torch.is_tensor(v) and k != "step")

    def _gather(self, local: Sequence[torch.Tensor], write: Callable[[int, int, torch.Tensor],
                                                                      None]) -> None:
        """All-gather this rank's blocks of the sharded leaves (``local``, in
        ``self.sharded`` order) over the world; ``write(leaf, rank, block)``
        places every rank's."""
        if not local:
            return
        flat = torch.cat([t.reshape(-1) for t in local])
        parts = ([flat] if self.mesh.world_group is None
                 else all_gather_list(flat, self.mesh.world_group))
        for r, part in enumerate(parts):
            off = 0
            for j in self.sharded:
                n = self.blocks[j].numel()
                write(j, r, part[off:off + n].view(self.blocks[j].shape))
                off += n

    @torch.no_grad()
    def step(self) -> None:
        for p, b, sl in zip(self.params, self.blocks, self._slices):
            b.copy_(p[sl[self.mesh.rank]])
            b.grad = None if p.grad is None else p.grad[sl[self.mesh.rank]].contiguous()
        self.inner.step()
        for j in self.whole:
            self.params[j].copy_(self.blocks[j])
        self._gather([self.blocks[j] for j in self.sharded],
                     lambda j, r, blk: self.params[j][self._slices[j][r]].copy_(blk))

    def state_dict(self) -> Dict[str, Any]:
        """The single-device optimiser's state dict (every moment gathered
        whole). Collective: every rank calls it."""
        sd = self.inner.state_dict()
        state = {i: dict(st) for i, st in sd["state"].items()}
        keys = sorted({k for j in self.sharded for k, v in state.get(j, {}).items()
                       if torch.is_tensor(v) and v.shape == self.blocks[j].shape
                       and k != "step"})
        for key in keys:
            full = {j: torch.empty_like(self.params[j], dtype=state[j][key].dtype)
                    for j in self.sharded}
            self._gather([state[j][key] for j in self.sharded],
                         lambda j, r, blk: full[j][self._slices[j][r]].copy_(blk))
            for j in self.sharded:
                state[j][key] = full[j]
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, state_dict: Mapping[str, Any]) -> None:
        """From the single-device format: this rank's block of each moment."""
        state = {}
        for i, st in state_dict["state"].items():
            p, sl = self.params[int(i)], self._slices[int(i)][self.mesh.rank]
            state[i] = {k: (v[sl].clone() if torch.is_tensor(v) and v.shape == p.shape
                            and k != "step" else v) for k, v in st.items()}
        self.inner.load_state_dict({"state": state,
                                    "param_groups": state_dict["param_groups"]})


@torch.no_grad()
def broadcast_tensors(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values into ``tensors`` on every rank (one flat broadcast
    per dtype): the replicated state starts equal everywhere."""
    if mesh.world_group is None:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        broadcast_(flat, dist.get_global_rank(mesh.world_group, 0), mesh.world_group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def shard_state(trainer, mesh: Mesh, tp: bool = False, tp_min_width: int = 128):
    """Place a DecoderTrainer's state on the mesh (JAX ``shard_state``, with
    ZeRO-1 always on): the parameters and EMA shadows made equal to rank
    0's, and each unet's optimiser a ``ShardedOptimizer`` by
    ``state_shardings``' opt specs, taking over its moments (``tp`` /
    ``tp_min_width`` shard the moments of wide leaves over ``model`` too; the
    parameters stay whole). On a one-rank mesh the state stays as it is.
    Returns the trainer."""
    if mesh.world == 1:
        return trainer
    for i, unet in enumerate(trainer.decoder.unets):
        named = dict(unet.named_parameters())
        tensors = [p.data for p in named.values()]
        if trainer.ema[i] is not None:
            tensors += list(trainer.ema[i].params.values())
        broadcast_tensors(tensors, mesh)
        specs = state_shardings(named, mesh, tp, tp_min_width)["opt_states"]
        name_of = {id(p): k for k, p in named.items()}
        opt = trainer.optimizers[i]
        if isinstance(opt, ShardedOptimizer):
            raise ValueError(f"unet {i + 1}: its state is already sharded")
        order = [name_of[id(p)] for g in opt.param_groups for p in g["params"]]
        trainer.optimizers[i] = ShardedOptimizer(opt, mesh, [specs[k] for k in order])
    return trainer


# ---------------------------------------------------------------------- #
def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of x over the axis (no gradient)."""
    if group is None:
        return x
    return all_reduce_sum(x, group) / dist.get_world_size(group)


@torch.no_grad()
def reduce_gradients(params: Sequence[torch.Tensor], group, *, mean: bool = True) -> None:
    """Every parameter's ``grad`` all-reduced over ``group`` in one flat
    buffer: averaged (``mean``: each rank's grad is of its rows' mean loss)
    or summed (each rank's grad is its part of one global loss). A
    parameter with no gradient (the same on every rank) is left out."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
    if mean:
        flat /= dist.get_world_size(group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()


def shard_draws(draws, mesh: Mesh):
    """This rank's rows of the global batch's injected draws (a dict, or a
    list of them under grad_accum): each tensor or array with a batch axis
    cut into ``mesh.data`` blocks; scalars (the whole-batch coins) kept."""
    if draws is None or mesh.data == 1:
        return draws
    if isinstance(draws, (list, tuple)):
        return [shard_draws(d, mesh) for d in draws]

    def take(v):
        if isinstance(v, (torch.Tensor, np.ndarray)) and v.ndim >= 1:
            per = v.shape[0] // mesh.data
            if per * mesh.data != v.shape[0]:
                raise ValueError(f"draw of {v.shape[0]} rows over a data axis of {mesh.data}")
            return v[mesh.data_index * per:(mesh.data_index + 1) * per]
        return v
    return {k: take(v) for k, v in draws.items()}


def make_sharded_train_step(trainer, mesh: Mesh, unet_number: int = 1, *,
                            with_embed: bool = True, with_text: bool = False):
    """One data-parallel train step of ``trainer`` (a DecoderTrainer, its
    state placed by ``shard_state``) over the mesh. Returns
    ``step(video[, video_embed][, text_encodings], draws=None) -> loss``:
    the arrays are this rank's rows of the global batch (``shard_batch`` or
    a loader sharded by data index), ``draws`` the global batch's (as
    ``DecoderTrainer.train_step`` takes them); the loss is the global
    batch's mean, the same on every rank."""
    params = list(trainer.decoder.unets[unet_number - 1].parameters())

    def step(video, *conds, draws=None):
        video_embed = conds[0] if with_embed else None
        text = (conds[1] if with_embed else conds[0]) if with_text else None
        with active_mesh(mesh):
            loss = trainer.backward(video, video_embed=video_embed, text_encodings=text,
                                    unet_number=unet_number, draws=shard_draws(draws, mesh))
            loss = all_reduce_mean(loss, mesh.data_group)
            reduce_gradients(params, mesh.data_group)
            return trainer.apply_update(unet_number, loss)

    return step


def make_sharded_train_steps_scan(trainer, mesh: Mesh, unet_number: int = 1, *,
                                  with_embed: bool = True, with_text: bool = False):
    """K sharded steps in one call (the JAX ``train_steps_scan``): arrays
    (K, b, ...) of this rank's rows per step, ``draws`` None or K dicts;
    returns the K losses."""
    step = make_sharded_train_step(trainer, mesh, unet_number, with_embed=with_embed,
                                   with_text=with_text)

    def scan(videos, *conds, draws=None):
        k = videos.shape[0]
        return torch.stack([step(videos[j], *(c[j] for c in conds),
                                 draws=None if draws is None else draws[j]) for j in range(k)])

    return scan


def make_sharded_distill_step(trainer, mesh: Mesh):
    """The data-parallel distill step: ``trainer`` (a DistillTrainer after
    ``init_state``) with its teacher, student, EMA and Adam state replicated
    (made equal to rank 0's here), the batch rows over the data axis.
    Returns ``step(video, video_embed=None, text_encodings=None,
    draws=None) -> loss`` as ``make_sharded_train_step``'s."""
    broadcast_tensors([*trainer.teacher.values(), *(p.data for p in trainer.student.values()),
                       *trainer.ema.values()], mesh)
    params = list(trainer.student.values())

    def step(video, *, video_embed=None, text_encodings=None, draws=None):
        with active_mesh(mesh):
            loss = trainer.backward(video, video_embed=video_embed,
                                    text_encodings=text_encodings,
                                    draws=shard_draws(draws, mesh))
            loss = all_reduce_mean(loss, mesh.data_group)
            reduce_gradients(params, mesh.data_group)
            return trainer.apply_update(loss)

    return step


# ---------------------------------------------------------------------- #
def _rows(a, start: int, size: int):
    return a.take(start, size) if isinstance(a, RowKeys) else a[start:start + size]


def _gather_rows(out, mesh: Mesh):
    """Every rank's rows of a sampler's output, whole on every rank (on the
    mesh's device for the collective; numpy comes back as numpy)."""
    if isinstance(out, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(out)).to(mesh.device)
        return all_gather_cat(t, mesh.data_group, dim=0).cpu().numpy()
    return all_gather_cat(out.contiguous(), mesh.data_group, dim=0)


def make_sharded_sample_stage(decoder, mesh: Mesh, stage_index: int, **fixed):
    """One cascade stage's sampler over the data axis: ``run(keys,
    video_embed, prev_video=None)`` with the global batch's row keys and
    arrays; each rank samples its rows, the stage's output whole on every
    rank."""
    def run(keys, video_embed, prev_video=None):
        b = len(keys)
        if b % mesh.data:
            raise ValueError(f"batch {b} must be a multiple of the data axis ({mesh.data})")
        per, i = b // mesh.data, mesh.data_index
        with active_mesh(mesh):
            out = decoder.sample_stage(
                stage_index, keys.take(i * per, per), batch_size=per,
                video_embed=_rows(video_embed, i * per, per),
                prev_video=None if prev_video is None else _rows(prev_video, i * per, per),
                **fixed)
        return _gather_rows(out, mesh)

    return run


def make_data_parallel_sampler(sample_fn: Callable, mesh: Mesh):
    """A batched sampler split over the mesh's data axis.

    ``sample_fn(*rows, **fixed) -> (b, ...)`` takes arguments that all have
    the batch first (prompts, seeds, row keys, inpainting arrays); every
    rank calls the wrapper with the whole group, samples its rows and gets
    the whole output back. Batch sizes must be multiples of the data axis
    (``data_parallel_buckets``). With per-row keys (utils/keys.py) a row's
    draws are its seed's alone, so a row's video does not depend on the
    rank that sampled it."""
    def wrapped(*arrays, **fixed):
        b = len(arrays[0])
        if b % mesh.data:
            raise ValueError(f"serving batch {b} must be a multiple of the data axis "
                             f"({mesh.data})")
        per, i = b // mesh.data, mesh.data_index
        with active_mesh(mesh):
            out = sample_fn(*(_rows(a, i * per, per) for a in arrays), **fixed)
        return _gather_rows(out, mesh)

    return wrapped


def data_parallel_buckets(buckets: Sequence[int], data: int) -> Tuple[int, ...]:
    """Serving buckets rounded up to multiples of the data axis (padding
    fills the extra rows), as scripts/serve.py rounds them."""
    return tuple(sorted({-(-int(b) // data) * data for b in buckets}))
