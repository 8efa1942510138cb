"""Pipeline parallelism: the GPipe fill-drain schedule over the mesh's model
axis (port of dalle2_video_tpu/parallel/pipeline.py).

Each of the S ranks of a model row holds one stage: L/S contiguous layers
of a stacked parameter set (every leaf with a leading layer axis, the
prior's ``scan_layers`` layout). ``pipeline_apply`` streams M microbatches
through the stages in M + S - 1 ticks: at tick t, stage 0 reads microbatch
t, every other stage what ``collectives.ppermute_`` brought from the stage
before it at the tick before, and the last stage finishes microbatch
t - (S - 1). A stage skips the fill and drain ticks in which it holds no
real microbatch (the JAX program computes them and throws them away; it
still takes part in every tick's ring transfer). The last stage's outputs
reach every rank by a masked sum over the axis. The bubble is (S - 1) / M
of a step.

The JAX version gets its backward from autodiff through ``shard_map``.
Here one ``torch.autograd.Function`` runs the schedule and arranges each
cotangent by hand:
  * the output is consumed replicated on every rank, so the masked sum's
    backward is the identity: the one cotangent reaches the last stage's
    outputs only, and is not summed S times;
  * the backward runs the ticks in reverse: the inverse permute carries
    each stage's input cotangent back to the stage before it, so every
    rank's permutes pair up in one order;
  * stage 0 alone reads the input ``x`` and every stage reads the
    ``broadcast_args``: their cotangents are summed over the axis (with
    ``batch_axis``, the broadcast arguments' over that axis too), so the
    replicated parameters before the pipeline get the same gradient on
    every rank;
  * with ``batch_axis`` the stage parameters' gradients are summed over
    that axis (each rank ran its rows through the same stage).

``pipeline_sharding_tree`` (the stages' placement as specs per parameter
name), ``stage_slices`` (a rank's stage of a whole stack, for callers that
hold every layer) and the layout converters ``stack_transformer_params`` /
``unstack_transformer_params`` complete the module.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from dalle2_video_tpu_torch.parallel.collectives import (
    all_reduce_,
    ppermute_,
    shard_replicated,
)
from dalle2_video_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from dalle2_video_tpu_torch.parallel.sharded import Spec

# the stacked layers' module name (flax nn.scan's subtree, the prior's
# ``transformer.layers``)
LAYERS = "layers"


def _zeros(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros(t.shape, dtype=t.dtype, device=t.device)


class _Schedule:
    """The fill-drain schedule of one call: the stage function, the ring,
    and (when recording for the backward) each active tick's local graph."""

    def __init__(self, layer_fn, names: Sequence[str], mesh: Mesh, microbatches: int, axis: str,
                 batch_axis: Optional[str]):
        self.layer_fn, self.names, self.m = layer_fn, list(names), microbatches
        self.stages, self.stage = mesh.shape[axis], mesh.index(axis)
        self.group = mesh.group(axis)
        # the batch axis's group where it spans more than one rank
        self.batch_group = (mesh.group(batch_axis) if batch_axis is not None
                            and mesh.shape[batch_axis] > 1 else None)
        self.ticks = self.m + self.stages - 1
        self.saved: Dict[int, tuple] = {}

    def active(self, t: int) -> bool:
        return 0 <= t - self.stage < self.m

    def run_stage(self, params: Sequence[torch.Tensor], x, bcast):
        for i in range(params[0].shape[0]):
            x = self.layer_fn({k: p[i] for k, p in zip(self.names, params)}, x, *bcast)
        return x

    def forward(self, x, params, bcast, record: bool):
        m, s, last = self.m, self.stage, self.stages - 1
        xs = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        outs = _zeros(xs)
        if record:
            self.leaves = [p.detach().requires_grad_(True) for p in params]
            self.bleaves = [b.detach().requires_grad_(True) for b in bcast]
        buf = None
        for t in range(self.ticks):
            if self.active(t):
                inp = xs[t] if s == 0 else buf
                if record:
                    leaf = inp.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = self.run_stage(self.leaves, leaf, self.bleaves)
                    self.saved[t] = (leaf, y)
                    y = y.detach()
                else:
                    y = self.run_stage(params, inp, bcast)
                if s == last:
                    outs[t - last] = y
            else:
                y = torch.zeros_like(xs[0])
            if t < self.ticks - 1:  # the last tick's transfer would reach no one
                buf = ppermute_(y, self.group, 1)
        if self.stages > 1:  # only the last stage holds outputs: the masked sum
            all_reduce_(outs, self.group)
        return outs.reshape(x.shape)

    def backward(self, g_out, need_x: bool):
        m, s, last = self.m, self.stage, self.stages - 1
        g = g_out.reshape((m, g_out.shape[0] // m) + tuple(g_out.shape[1:])).contiguous()
        # contiguous accumulators: NCCL reduces no strided tensor (the
        # relative-position bias arrives as a permuted view)
        g_params = [_zeros(p) for p in self.leaves]
        g_bcast = [_zeros(b) for b in self.bleaves]
        g_x = torch.zeros_like(g) if need_x else None
        g_in = torch.zeros_like(g[0])  # this stage's input cotangent at tick t + 1
        g_y = None
        for t in reversed(range(self.ticks)):
            if t < self.ticks - 1:  # the inverse of tick t's transfer
                g_y = ppermute_(g_in if s > 0 else torch.zeros_like(g_in), self.group, -1)
            g_in = torch.zeros_like(g[0])
            if not self.active(t):
                continue
            leaf, y = self.saved.pop(t)
            grads = torch.autograd.grad(y, [leaf, *self.leaves, *self.bleaves],
                                        g[t - last] if s == last else g_y, allow_unused=True)
            if grads[0] is not None:
                g_in = grads[0]
            for acc, gr in zip(g_params + g_bcast, grads[1:]):
                if gr is not None:
                    acc += gr
            if s == 0 and need_x:
                g_x[t] = g_in
        if need_x and self.stages > 1:  # stage 0 alone read x
            all_reduce_(g_x, self.group)
        for gb in g_bcast:  # every stage read the broadcast arguments
            if self.stages > 1:
                all_reduce_(gb, self.group)
            if self.batch_group is not None:
                all_reduce_(gb, self.batch_group)
        if self.batch_group is not None:
            for gp in g_params:
                all_reduce_(gp, self.batch_group)
        return (None if g_x is None else g_x.reshape(g_out.shape)), g_params, g_bcast


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, n_params, x, *tensors):
        ctx.sched = sched
        return sched.forward(x, tensors[:n_params], tensors[n_params:], record=True)

    @staticmethod
    def backward(ctx, g):
        g_x, g_params, g_bcast = ctx.sched.backward(g, ctx.needs_input_grad[2])
        return (None, None, g_x, *g_params, *g_bcast)


def pipeline_apply(layer_fn: Callable[..., torch.Tensor], stage_params: Mapping[str, torch.Tensor],
                   x: torch.Tensor, mesh: Mesh, *, microbatches: int, axis: str = MODEL_AXIS,
                   batch_axis: Optional[str] = None, broadcast_args: Sequence = ()
                   ) -> torch.Tensor:
    """Apply this rank's stage of an S-stage GPipe pipeline to ``x``.

    ``layer_fn(layer_params, x, *broadcast_args) -> x`` applies ONE layer
    (``layer_params``: each stage parameter's slice at that layer) and keeps
    x's shape. ``stage_params`` are this rank's stage: each leaf with a
    leading axis of L/S layers (``stage_slices`` cuts them from a whole
    stack). ``x`` (b, ...) is the whole batch on every rank of the axis
    (with ``batch_axis``, this rank's rows of it); b must divide by
    ``microbatches``. Returns x after all L layers on every rank of the
    axis, the same function as the layers applied in turn."""
    if microbatches < 1:
        raise ValueError("microbatches must be >= 1")
    if x.shape[0] % microbatches:
        raise ValueError(f"local batch {x.shape[0]} not divisible by microbatches "
                         f"{microbatches}")
    names = list(stage_params)
    params = [stage_params[k] for k in names]
    if not params or len({p.shape[0] for p in params}) != 1 or params[0].shape[0] < 1:
        raise ValueError("stage parameters need one leading layer axis of at least 1")
    bcast = list(broadcast_args)
    sched = _Schedule(layer_fn, names, mesh, microbatches, axis, batch_axis)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params, *bcast)):
        return _Pipeline.apply(sched, len(params), x, *params, *bcast)
    with torch.no_grad():
        return sched.forward(x, params, bcast, record=False)


def stage_slices(stacked: Mapping[str, torch.Tensor], mesh: Mesh,
                 axis: str = MODEL_AXIS) -> Dict[str, torch.Tensor]:
    """This rank's stage of a whole stack held by every rank of the axis
    (JAX ``pipeline_apply``'s replicated input, cut by its P(axis) in-spec):
    the rank's L/S contiguous layers; their backward gathers every stage's
    cotangent, so the whole stack's gradient is the same on every rank."""
    stages = mesh.shape[axis]
    n_layers = next(iter(stacked.values())).shape[0]
    if n_layers % stages != 0:
        raise ValueError(f"{n_layers} layers not divisible by {stages} stages")
    group = mesh.group(axis) if stages > 1 else None
    return {k: shard_replicated(v, group, 0) for k, v in stacked.items()}


def pipeline_sharding_tree(named: Mapping[str, torch.Tensor], mesh: Mesh,
                           axis: str = MODEL_AXIS) -> Dict[str, Spec]:
    """Spec per parameter name of a pipelined model (JAX
    ``pipeline_sharding_tree``): a leaf under a ``layers`` module is split
    over ``axis`` on its leading layer dim when that divides, everything
    else replicated. The same specs place the Adam moments and the EMA
    shadow (both keyed by parameter name)."""
    size = mesh.shape[axis]

    def spec(name, leaf) -> Spec:
        if LAYERS in name.split(".") and leaf.ndim >= 1 and leaf.shape[0] % size == 0:
            return (axis,)
        return ()

    return {k: spec(k, v) for k, v in named.items()}


def stack_transformer_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A CausalTransformer's state dict in the per-layer layout (``attn{i}.*``,
    ``ff{i}.*``) -> the stacked layout (``layers.attn.*``, ``layers.ff.*``,
    each with a leading depth axis); other entries kept."""
    depth = sum(1 for k in {k.split(".", 1)[0] for k in sd} if k.startswith("attn"))
    if not depth:
        raise ValueError("not a per-layer CausalTransformer state dict")
    out: Dict[str, torch.Tensor] = {}
    per: Dict[str, List[Optional[torch.Tensor]]] = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        kind = "attn" if head.startswith("attn") else "ff" if head.startswith("ff") else None
        if kind is None or not head[len(kind):].isdigit():
            out[k] = v
            continue
        per.setdefault(f"{LAYERS}.{kind}.{rest}", [None] * depth)[int(head[len(kind):])] = v
    for k, vs in per.items():
        if any(v is None for v in vs):
            raise ValueError(f"{k}: a layer is missing")
        out[k] = torch.stack(vs)
    return out


def unstack_transformer_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The stacked layout -> the per-layer layout (the inverse of
    ``stack_transformer_params``)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if head != LAYERS:
            out[k] = v
            continue
        kind, _, leaf = rest.partition(".")
        for i in range(v.shape[0]):
            out[f"{kind}{i}.{leaf}"] = v[i]
    return out
