"""Multi-source batching and mixdown (BASELINE.json config #4).

Many simultaneous sources share one scene: ``vmap`` the trace over the
source axis (the scene arrays are closed over once — the "shared BVH"),
then *mix down* by summing IRs at the listener — physically exact because
IR construction is linear in hit energy.

Across a device mesh, sources shard over the ``"rays"`` axis (shard_map)
and the mixdown is a ``jax.lax.psum`` — a collective replacing nothing in
the reference (it has no multi-source mode at all).
"""

from __future__ import annotations

from functools import partial
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.scene import Scene
from ..ops import ir as irm
from ..ops.trace import TraceParams, trace_hits_only


@partial(jax.jit, static_argnames=("n_rays", "max_bounces", "sample_rate",
                                   "ir_length"))
def trace_sources_mixdown(scene: Scene, params: TraceParams,
                          key: jax.Array, *, n_rays: int, max_bounces: int,
                          sample_rate: int, ir_length: int) -> jax.Array:
    """Trace S sources (``params.source`` shaped [S, 2], per-source gain
    allowed via broadcastable ``input_gain``) and return the summed IR
    ``[L, T, K]`` at the shared listener(s). The sources are vmapped
    through the trace with keys ``split(key, S)``.

    ``params.directivity`` may be ``[C]`` (every source shares the
    pattern) or ``[S, C]`` — PER-SOURCE aims, e.g. a steered speaker
    array; ``params.mic_directivity`` rides along unchanged."""
    sources = jnp.atleast_2d(params.source)
    n_src = sources.shape[0]
    gains = jnp.broadcast_to(jnp.asarray(params.input_gain), (n_src,))
    keys = jax.random.split(key, n_src)

    def one(src, gain, d, k):
        p = params._replace(source=src, input_gain=gain, directivity=d)
        hits = trace_hits_only(scene, p, k, n_rays=n_rays,
                               max_bounces=max_bounces)
        return irm.scatter_hits(hits, sample_rate, ir_length)

    d = params.directivity
    if d is None:
        # explicit omni row: multiplying emission by an exact 1.0 is
        # bit-identical to no pattern (keeps `one` uniform under vmap)
        d = jnp.ones((1,), jnp.float32)
    dirs = jnp.broadcast_to(jnp.atleast_2d(d), (n_src, d.shape[-1]))
    irs = jax.vmap(one)(sources, gains, dirs, keys)   # [S, L, T, K]
    return jnp.sum(irs, axis=0)


def trace_sources_mixdown_sharded(scene: Scene, params: TraceParams,
                                  key: jax.Array, mesh: Mesh, *,
                                  n_rays: int, max_bounces: int,
                                  sample_rate: int, ir_length: int,
                                  axis: str = "rays") -> jax.Array:
    """Mesh-sharded variant: sources split across ``axis``; each device
    traces its shard through :func:`trace_sources_mixdown` and the final
    mixdown is a ``psum`` across the mesh.

    ``params.source`` must be [S, 2] with S divisible by the axis size.
    Returns the replicated summed IR [L, T, K].
    """
    n_axis = mesh.shape[axis]
    sources = jnp.atleast_2d(params.source)
    n_src = sources.shape[0]
    if n_src % n_axis != 0:
        raise ValueError(
            f"{n_src} sources not divisible by mesh axis "
            f"{axis}={n_axis}")
    # per-source gains — and per-source aims, when directivity is
    # [S, C] — shard together with the sources
    gains = jnp.broadcast_to(jnp.asarray(params.input_gain, jnp.float32),
                             (n_src,))
    d = params.directivity
    dirs = None if d is None else \
        jnp.broadcast_to(jnp.atleast_2d(d), (n_src, d.shape[-1]))
    keys = jax.random.split(key, n_axis)

    spec_in = P(axis)
    other_axes = tuple(a for a in mesh.axis_names if a != axis)

    # check_vma off: see rays.py — replication is established by the psum.
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(spec_in, spec_in, P() if dirs is None else spec_in,
                       spec_in),
             out_specs=P(), check_vma=False)
    def shard_fn(src_shard, gain_shard, dir_shard, key_shard):
        local = trace_sources_mixdown(
            scene,
            params._replace(source=src_shard, input_gain=gain_shard,
                            directivity=None if dirs is None
                            else dir_shard),
            key_shard[0],
            n_rays=n_rays, max_bounces=max_bounces,
            sample_rate=sample_rate, ir_length=ir_length)
        total = jax.lax.psum(local, axis)
        for a in other_axes:
            total = jax.lax.pmean(total, a)
        return total

    return shard_fn(sources, gains,
                    jnp.zeros((n_src, 1)) if dirs is None else dirs, keys)
