"""``mesh_axis_size`` — the one helper of ``repro.distributed.sharding``
the suffix-array store needs (the rest of that module shards LM
parameters)."""
from __future__ import annotations

from typing import Optional


def mesh_axis_size(mesh: Optional[object], axis_name=None) -> int:
    """Tablets of a ``launch.mesh.TabletMesh``; ``mesh=None`` means one
    device (1).  ``axis_name`` keeps the reference's signature: the mesh
    has the one axis ``"tablets"``, so every name of it gives the same
    size."""
    return 1 if mesh is None else int(mesh.size)
