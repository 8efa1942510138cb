"""The data and model axes on ``torch.distributed`` (port of
dalle2_video_tpu/parallel/): the mesh (``mesh.py``), differentiable
collectives (``collectives.py``), the sharded train / sample steps with
ZeRO-1 and tensor-parallel placement (``sharded.py``) and
sequence-parallel attention (``sp_attention.py``). The prior's GPipe
pipeline (JAX ``pipeline.py``) is not ported."""

from dalle2_video_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    active_mesh,
    create_mesh,
    get_active_mesh,
    maybe_init_distributed,
    shard_batch,
    shard_with,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "active_mesh",
    "create_mesh",
    "get_active_mesh",
    "maybe_init_distributed",
    "shard_batch",
    "shard_with",
]
