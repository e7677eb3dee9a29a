"""Several ranks on ``torch.distributed`` (PyTorch port of
manisdp_tpu/parallel): device meshes, the data-parallel MaxCut batch and
the sharded constraint operator behind ``mesh=`` of the primal AL
drivers."""

from .distributed import init_distributed, spawn_ranks
from .mesh import batched_maxcut_solve, make_mesh

__all__ = ["make_mesh", "batched_maxcut_solve", "init_distributed",
           "spawn_ranks"]
