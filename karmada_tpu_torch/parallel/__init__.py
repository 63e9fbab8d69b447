"""The mesh-sharded scheduling solve over a grid of torch devices."""
from .mesh import (
    AXIS_BINDINGS,
    AXIS_CLUSTERS,
    Mesh,
    MeshScheduleKernel,
    factor_mesh,
    make_hierarchical_mesh,
    make_mesh,
)

__all__ = [
    "AXIS_BINDINGS",
    "AXIS_CLUSTERS",
    "Mesh",
    "MeshScheduleKernel",
    "factor_mesh",
    "make_hierarchical_mesh",
    "make_mesh",
]
