"""The mesh plane: process groups, the mesh, and the shard primitives."""

from distel_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    build_mesh,
    init_distributed,
    launch_local,
    setup,
)
