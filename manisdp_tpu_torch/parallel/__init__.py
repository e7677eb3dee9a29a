"""Several ranks on ``torch.distributed`` (PyTorch port of
manisdp_tpu/parallel): device meshes, the model-sharded MaxCut RTR, the
data-parallel MaxCut batch, the sharded constraint operator behind
``mesh=`` of the primal AL drivers and the row-sharded SOS-dual tensor
operator (``symdual_sharded.ShardedSymDualOp``)."""

from .distributed import init_distributed, spawn_ranks
from .mesh import batched_maxcut_solve, make_mesh, sharded_maxcut_solve

__all__ = ["make_mesh", "sharded_maxcut_solve", "batched_maxcut_solve",
           "init_distributed", "spawn_ranks"]
