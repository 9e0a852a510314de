"""Frame-axis data parallelism: Monte-Carlo frames split across the mesh.

The reference accumulates one trace frame per ``Update()`` tick on one GPU
(``RayTraceManager.cs:179-244``, ``accumFrames`` at ``:233``). Frames are
independent MC samples, and IR accumulation is a linear sum over frames —
so distributing the frame loop across devices and ``psum``-ing the partial
sums is exact (same estimator, same frame keys). This is the "DP" axis of
this domain: each device runs the full single-frame workload (all rays,
all walls) on a disjoint slice of the frame stream.

Unlike ray-axis sharding (``parallel/rays.py``, which coarsens the
stratified emission fan per device), frame sharding keeps every frame's
full ``n_rays``-stratum fan — the sharded result is the SAME set of frames
the unsharded ``lax.scan`` would produce, just summed in a different
order (bit-differences are float-reassociation only).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.scene import Scene
from ..ops import ir as irm
from ..ops import rng as _rng
from ..ops.trace import TraceParams, trace_hits_only


def accumulate_frames_sharded(scene: Scene, params: TraceParams,
                              state: irm.IRState, key: jax.Array,
                              mesh: Mesh, *, n_rays: int, max_bounces: int,
                              sample_rate: int, n_frames: int,
                              axis: str = "rooms") -> irm.IRState:
    """Accumulate ``n_frames`` MC frames with the frame loop split across
    ``mesh[axis]``; returns ``state`` advanced by all ``n_frames`` (the
    replicated psum of per-device partial sums). Device ``d`` scans
    frames ``d*local .. (d+1)*local - 1`` with the ``frame_key(key, i)``
    stream of the unsharded engine scan.
    """
    n_dev = mesh.shape[axis]
    if n_frames % n_dev != 0:
        raise ValueError(
            f"n_frames={n_frames} not divisible by {axis}={n_dev}")
    local = n_frames // n_dev
    other_axes = tuple(a for a in mesh.axis_names if a != axis)

    # check_vma off for the same reason as parallel/rays.py: the scan
    # carry mixes replicated operands with the device-varying frame index;
    # replication of the output is established explicitly by the psum.
    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(), out_specs=P(),
             check_vma=False)
    def run():
        d = jax.lax.axis_index(axis)

        def body(acc, i):
            hits = trace_hits_only(
                scene, params, _rng.frame_key(key, d * local + i),
                n_rays=n_rays, max_bounces=max_bounces)
            return acc + irm.scatter_hits(hits, sample_rate,
                                          state.ir_length), None

        acc, _ = jax.lax.scan(body, jnp.zeros_like(state.sum),
                              jnp.arange(local, dtype=jnp.int32))
        total = jax.lax.psum(acc, axis)
        for a in other_axes:
            total = jax.lax.pmean(total, a)
        return total

    return irm.IRState(sum=state.sum + run(),
                       frames=state.frames + n_frames)
