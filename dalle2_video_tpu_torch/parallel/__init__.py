"""The data and model axes on ``torch.distributed`` (port of
dalle2_video_tpu/parallel/): the mesh (``mesh.py``), differentiable
collectives (``collectives.py``), the sharded train / sample steps with
ZeRO-1 and tensor-parallel placement (``sharded.py``),
sequence-parallel attention (``sp_attention.py``) and the prior's GPipe
pipeline (``pipeline.py``; its expert parallelism is ``models/moe.py``'s)."""

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
