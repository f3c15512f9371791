"""Segment parallelism over a mesh of logical shards (``mesh.py``), its
collectives (``collectives.py``) and mesh-resident tables
(``distributed.py``, K18)."""
from .mesh import (Mesh, default_mesh, logical_mesh,  # noqa: F401
                   segment_mesh, set_default_mesh, using_mesh)
from .distributed import DistributedTable  # noqa: F401
