"""Launch layer of the port: the 1-D batch mesh the sweep engines split
their batch axis over, and the LM stack's mesh and process groups
(:mod:`repro_torch.launch.mesh`)."""
from .mesh import (BatchMesh, LMMesh, device_key, join_from_env,
                   make_batch_mesh, make_host_mesh, make_mesh,
                   make_production_mesh, resolve_mesh, spawn)

__all__ = ["BatchMesh", "LMMesh", "device_key", "join_from_env",
           "make_batch_mesh", "make_host_mesh", "make_mesh",
           "make_production_mesh", "resolve_mesh", "spawn"]
