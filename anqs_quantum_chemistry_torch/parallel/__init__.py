"""Data-parallel training over a ``torch.distributed`` mesh: the ``Mesh``
and its collectives (``mesh.py``) and the bucket-sharded hash membership
(``dist_membership.py``)."""

from .mesh import Mesh, make_mesh, replicate, shard_rows

__all__ = ["Mesh", "make_mesh", "replicate", "shard_rows"]
