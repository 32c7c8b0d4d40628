"""Scale-out layer: device meshes, sharded Monte-Carlo sweeps, collectives.

The reference has no intra-process parallelism (SURVEY.md §2.3); this layer
replaces its process-pipeline + UDP topology: data-parallel capture/Eb-N0
batches via vmap + shard_map over a Mesh, with psum-reduced BER/PER
counters.
"""
from .mesh import make_mesh  # noqa: F401
