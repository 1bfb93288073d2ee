"""Multi-chip scale-out: device meshes, sharded decode steps, corpus decode.

The reference is a single-process decoder (SURVEY.md §2.9); parallelism is a
a new capability. The axes that exist in this workload:

- ``stream`` (data parallel): independent files / logical streams.
- ``frame`` (sequence parallel): frames within one stream. Synthesis is
  frame-local; overlap-add couples only ADJACENT frames, so the shard
  boundary needs exactly one frame of halo, exchanged with
  ``jax.lax.ppermute`` between devices.
"""

from .mesh import make_mesh, sharded_decode_step

__all__ = ["make_mesh", "sharded_decode_step"]
