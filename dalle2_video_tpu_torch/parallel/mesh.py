"""The (data, model) mesh on ``torch.distributed`` (port of
dalle2_video_tpu/parallel/mesh.py).

One process per GPU (``torchrun``): the mesh is a 2-D grid of the
``world`` ranks, rank r at (data index r // model, model index r % model)
as the JAX mesh reshapes its devices, with one process group per data row
(the ``model`` axis: tensor- and sequence-parallel collectives) and one per
model column (the ``data`` axis: the gradient mean, ZeRO-1), made whenever a process
group is up (at world size 1 too, so one rank's run goes through the
backend's collectives). Every group
takes the mesh's ``backend``: NCCL for CUDA and gloo for the CPU by
default; gloo on CUDA only when asked (two ranks sharing one card).

  - ``data``  axis: batch rows (DP) and the optimiser state's shards
    (ZeRO-1);
  - ``model`` axis: tensor-parallel columns and sequence-parallel tokens.

Without a process group the mesh is one rank's, with no groups: its
collectives are no-ops.
``maybe_init_distributed`` joins torchrun's process group from its
environment; a failed NCCL initialisation raises (no fallback to gloo or
to one device).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# trace-time mesh discovery for mesh-aware layers (sequence-parallel
# attention, the global-batch draws and the flash backward's route): the
# sharded step factories run the model under ``with active_mesh(mesh):``
_ACTIVE_MESH: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data, model) grid: the axis sizes, its
    coordinates, its device, and the process groups of its row and column
    (None without a process group)."""

    data: int
    model: int
    rank: int
    device: torch.device
    backend: Optional[str]
    data_group: Any = None
    model_group: Any = None
    world_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def index(self, axis: str) -> int:
        return {DATA_AXIS: self.data_index, MODEL_AXIS: self.model_index}[axis]

    def group(self, axis: str):
        return {DATA_AXIS: self.data_group, MODEL_AXIS: self.model_group}[axis]

    def coords(self, rank: int) -> Dict[str, int]:
        return {DATA_AXIS: rank // self.model, MODEL_AXIS: rank % self.model}


@contextlib.contextmanager
def active_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Set the mesh get_active_mesh() returns for the duration."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def global_batch(b: int) -> int:
    """The batch a local batch of ``b`` rows belongs to: b times the active
    mesh's data axis (the batch the JAX program traces under a data mesh)."""
    mesh = get_active_mesh()
    return b if mesh is None else b * mesh.data


def resolve_mesh_shape(mesh_cfg: Optional[Dict[str, Any]], world: int):
    """(data, model) of a config's ``mesh`` ({data: -1} = world / model) on
    ``world`` ranks; raises, with both numbers, where they differ."""
    mesh_cfg = mesh_cfg or {}
    model = int(mesh_cfg.get("model", 1))
    data = int(mesh_cfg.get("data", -1))
    if model < 1 or world % model:
        raise ValueError(f"mesh model={model} does not divide the {world} launched ranks")
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} = {data * model} devices, but {world} "
                         f"ranks were launched (torchrun --nproc_per_node); a mesh never "
                         f"shrinks to fewer devices")
    return data, model


def default_backend(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def create_mesh(data: Optional[int] = None, model: int = 1, *,
                device: Any = "cpu", backend: Optional[str] = None) -> Mesh:
    """The (data, model) mesh over every launched rank (``data`` None: all
    of them). Called by every rank in the same order: it creates the row
    and column process groups collectively."""
    device = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    data, model = resolve_mesh_shape({"data": -1 if data is None else data, "model": model},
                                     world)
    if not dist.is_initialized():
        return Mesh(1, 1, 0, device, backend)
    backend = backend or dist.get_backend()
    rows = [[i * model + j for j in range(model)] for i in range(data)]
    cols = [[i * model + j for i in range(data)] for j in range(model)]
    model_group = data_group = None
    for ranks in rows:  # every rank creates every group, in one order
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            model_group = g
    for ranks in cols:
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            data_group = g
    world_group = dist.new_group(list(range(world)), backend=backend)
    return Mesh(data, model, rank, device, backend, data_group=data_group,
                model_group=model_group, world_group=world_group)


def shard_batch(mesh: Mesh, batch, axis: int = 0):
    """This rank's rows of a global batch (every tensor / array of the tree
    cut along ``axis`` into ``mesh.data`` blocks; the data index's block),
    on the mesh's device."""
    def take(x):
        if x is None:
            return None
        x = torch.as_tensor(x)
        n = x.shape[axis]
        if n % mesh.data:
            raise ValueError(f"batch {n} is not a multiple of the data axis ({mesh.data})")
        per = n // mesh.data
        return x.narrow(axis, mesh.data_index * per, per).to(mesh.device)
    return _tree_map(take, batch)


def shard_with(mesh: Mesh, batch):
    """The per-process variant of ``shard_batch``: a rank's loader (sharded
    with ``shard_index=mesh.data_index``) already yields only its rows,
    which go to the mesh's device as they are (copies that do not block)."""
    return _tree_map(lambda x: None if x is None else torch.as_tensor(x).to(
        mesh.device, non_blocking=True), batch)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def launched_world() -> int:
    """The world size torchrun launched (1 without torchrun)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank_device(device: Any = None) -> torch.device:
    """A rank's device: ``device`` when the caller names one, else
    ``cuda:LOCAL_RANK`` (torchrun's environment; cuda:0 without it)."""
    if device is not None:
        return torch.device(device)
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")


def maybe_init_distributed(enabled: bool = False, *, device: Any = "cpu",
                           backend: Optional[str] = None, timeout_s: float = 600.0) -> bool:
    """Join torchrun's process group (MASTER_ADDR / MASTER_PORT, RANK,
    WORLD_SIZE from its environment) when ``enabled``; a no-op otherwise or
    when already joined. The backend defaults to NCCL on CUDA and gloo on
    the CPU. Returns whether a process group is up."""
    if not enabled:
        return dist.is_initialized()
    if dist.is_initialized():
        return True
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"distributed run asked for, but {var} is not set: launch "
                               f"with torchrun (python -m torch.distributed.run)")
    device = torch.device(device)
    backend = backend or default_backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=device if backend == "nccl" else None)
    return True
