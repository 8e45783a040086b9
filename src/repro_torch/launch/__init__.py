"""Launch layer of the port: the 1-D batch mesh the sweep engines split
their batch axis over (:mod:`repro_torch.launch.mesh`)."""
from .mesh import BatchMesh, device_key, make_batch_mesh, resolve_mesh

__all__ = ["BatchMesh", "device_key", "make_batch_mesh", "resolve_mesh"]
