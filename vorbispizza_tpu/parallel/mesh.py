"""Sharded decode step over a ('stream', 'frame') device mesh.

``stream`` is data parallelism over independent streams/files; ``frame`` is
sequence parallelism over the frame axis of each stream. All synthesis
stages (floor render, coupling inverse, IMDCT, window) are frame-local, so
they shard trivially; the only cross-shard dependency is overlap-add, where
the first output hop of a shard laps with the LAST frame of the left
neighbor — one frame of halo moved with jax.lax.ppermute.

A psum over both axes folds the clip indicator into a global "has_clipped"
scalar (the analog of the reference's StreamDecoder.HasClipped), exercising
the all-reduce path.

This module is the uniform-blocksize (steady-state long-block) fast path; a
mixed-blocksize stream routes through models/pipeline.py per shard instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.coupling import inverse_couple_batch
from ..ops.floor import floor1_curves
from ..ops.imdct import imdct_window_batch

from ..decoder import CLIP_MAX


def make_mesh(n_devices: int | None = None, *, streams: int | None = None) -> Mesh:
    """A ('stream', 'frame') mesh over the available devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(
            f"requested {n_devices} devices, only {len(devs)} available"
        )
    devs = devs[:n_devices]
    if streams is None:
        # favor the frame axis (long single streams are the hard case)
        streams = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    if n_devices % streams != 0:
        raise ValueError(
            f"streams={streams} must divide n_devices={n_devices}"
        )
    frames = n_devices // streams
    return Mesh(
        np.array(devs).reshape(streams, frames), axis_names=("stream", "frame")
    )


def sharded_decode_step(
    mesh: Mesh,
    *,
    n: int,
    channels: int,
    xs: tuple[int, ...],
    multiplier: int,
    coupling_steps: tuple[tuple[int, int], ...],
    window: np.ndarray,
):
    """Build the jitted sharded synthesis step.

    Returns ``step(residues, posts, step2, used) -> (pcm, has_clipped)``:

      residues [S, F, C, n//2] f32  (pre-coupling spectra)
      posts    [S, F, C, P] i32, step2 [S, F, C, P] bool, used [S, F, C] bool
      -> pcm [S, F * n//2, C] f32 interleaved, has_clipped scalar bool

    S shards over 'stream', F over 'frame'. Frame f's output hop is
    lap(tail of frame f-1, head of frame f); each shard receives its left
    neighbor's final frame via ppermute (the first hop of the stream laps
    with zeros — the priming frame, reference StreamDecoder.cs:778).
    """
    half = n // 2
    P_posts = len(xs)
    # kept as numpy: an eager jnp.asarray here would device_put onto the
    # DEFAULT backend (e.g. a GPU) even when the mesh is CPU-only;
    # converting inside the traced function bakes it in as a constant on
    # whatever devices the jit actually targets.
    window_np = np.asarray(window, dtype=np.float32)
    axis = "frame"

    def local_step(residues, posts, step2, used):
        S, F, C, _ = residues.shape
        curves = floor1_curves(
            posts.reshape(S * F * C, P_posts),
            step2.reshape(S * F * C, P_posts),
            used.reshape(S * F * C),
            xs=xs,
            multiplier=multiplier,
            half=half,
        ).reshape(S, F, C, half)
        res = inverse_couple_batch(
            residues.reshape(S * F, C, half), coupling_steps
        ).reshape(S, F, C, half)
        spectra = res * curves
        frames = imdct_window_batch(spectra, jnp.asarray(window_np))  # [S, F, C, n]

        # halo: left neighbor's last frame laps into our first output hop
        sz = jax.lax.psum(1, axis)
        idx = jax.lax.axis_index(axis)
        last = frames[:, -1]  # [S, C, n]
        prev_last = jax.lax.ppermute(
            last, axis, [(i, (i + 1) % sz) for i in range(sz)]
        )
        prev_last = jnp.where(idx == 0, 0.0, prev_last)
        prev = jnp.concatenate(
            [prev_last[:, None], frames[:, :-1]], axis=1
        )  # frame f-1 for each local f
        pcm = prev[..., half:] + frames[..., :half]  # [S, F, C, half]
        pcm = pcm.transpose(0, 1, 3, 2).reshape(S, F * half, C)

        clipped = jnp.any(jnp.abs(pcm) > CLIP_MAX)
        has_clipped = (
            jax.lax.psum(clipped.astype(jnp.int32), ("stream", "frame")) > 0
        )
        pcm = jnp.clip(pcm, -CLIP_MAX, CLIP_MAX)
        return pcm, has_clipped

    shard = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            P("stream", "frame", None, None),
            P("stream", "frame", None, None),
            P("stream", "frame", None, None),
            P("stream", "frame", None),
        ),
        out_specs=(P("stream", "frame", None), P()),
        check_vma=False,
    )
    return jax.jit(shard)


def shard_inputs(mesh: Mesh, residues, posts, step2, used):
    """Place host arrays with the step's shardings (HBM-resident inputs)."""
    s4 = NamedSharding(mesh, P("stream", "frame", None, None))
    s3 = NamedSharding(mesh, P("stream", "frame", None))
    return (
        jax.device_put(residues, s4),
        jax.device_put(posts, s4),
        jax.device_put(step2, s4),
        jax.device_put(used, s3),
    )
