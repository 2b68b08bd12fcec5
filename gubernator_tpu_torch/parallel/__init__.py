"""The sharded table on one card: the mesh backend and collective GLOBAL."""
from gubernator_tpu_torch.parallel.mesh import shard_of_hash  # noqa: F401
from gubernator_tpu_torch.parallel.sharded import MeshBackend  # noqa: F401
