from .mesh import Mesh, current_mesh, mesh_size_for, replicate, shard_batch

__all__ = ["Mesh", "current_mesh", "mesh_size_for", "replicate", "shard_batch"]
