"""Device placement (counterpart of ``trlx_tpu/parallel``): the mesh over
``torch.distributed`` ranks (:mod:`~trlx_tpu_torch.parallel.mesh`), the
partition rules (:mod:`~trlx_tpu_torch.parallel.sharding`), the collectives
(:mod:`~trlx_tpu_torch.parallel.collectives`), the ZeRO storage and the
overlapped FSDP step (:mod:`~trlx_tpu_torch.parallel.fsdp`), the stacked
layouts and the GPipe schedule over the ``pipe`` axis
(:mod:`~trlx_tpu_torch.parallel.pipeline`) and the island carve."""

from trlx_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    MESH_AXES,
    IslandPlacement,
    Mesh,
    carve_islands,
    dp_size,
    initialize_distributed,
    make_mesh,
    mesh_from_config,
    put_batch,
)

__all__ = ["BATCH_AXES", "MESH_AXES", "IslandPlacement", "Mesh", "carve_islands", "dp_size",
           "initialize_distributed", "make_mesh", "mesh_from_config", "put_batch"]
