"""Device placement (counterpart of ``trlx_tpu/parallel``): the island carve
of the Sebulba split. The JAX package's meshes and shardings come with the
scale-out slice."""

from trlx_tpu_torch.parallel.mesh import IslandPlacement, carve_islands

__all__ = ["IslandPlacement", "carve_islands"]
