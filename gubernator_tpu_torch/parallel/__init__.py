"""The sharded table over the cards: the mesh backend and collective GLOBAL."""
from gubernator_tpu_torch.parallel.mesh import shard_of_hash  # noqa: F401
from gubernator_tpu_torch.parallel.sharded import MeshBackend  # noqa: F401
