"""Multi-device layout and the row-sharded (sp) channel (counterpart of
phaneron_tpu/parallel/): the mesh and its shardings (mesh.py), the band
executor that runs a channel program row-sharded (bands.py), the
multichip and cross-mesh ROUTE dry runs (dryrun.py) and the two-process
multihost dry run (multihost.py)."""

from .mesh import (
    Mesh,
    Sharded,
    make_mesh,
    make_multi_channel_program,
    make_sp_mesh,
    shard_channel_params,
    shard_params_sp,
)

__all__ = [
    "Mesh",
    "Sharded",
    "make_mesh",
    "make_multi_channel_program",
    "make_sp_mesh",
    "shard_channel_params",
    "shard_params_sp",
]
