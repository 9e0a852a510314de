"""Room-dataset sweeps across a device mesh (BASELINE.json config #5).

IR dataset generation: a batch of procedurally generated rooms (a stacked
:class:`~..models.scene.Scene` pytree) is sharded over the ``"rooms"`` mesh
axis with ``shard_map``; each device runs its local rooms through the same
vmapped sweep as the single-device path, and the results are gathered back
as the ``[n_rooms, L, T, K]`` IR dataset. The reference has no batch mode
at all — its closest analogue is re-running the Unity scene per room
(SURVEY.md section 2.4).

Per-room RNG is indexed by GLOBAL room id (``room_offset``), so every room
draws the same stream whether the batch is sharded or not.
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
                                   "ir_length", "n_frames"))
def sweep_rooms(scenes: Scene, sources: jax.Array, listeners: jax.Array,
                key: jax.Array, *, n_rays: int, max_bounces: int,
                sample_rate: int, ir_length: int, n_frames: int = 1,
                listener_radius: float = 0.5, speed_of_sound: float = 343.0,
                input_gain: float = 1.0, room_offset=0, directivity=None,
                mic_directivity=None) -> jax.Array:
    """Sweep a whole room batch on one device: returns IRs
    ``[n_rooms, L, T, K]``. ``scenes`` is a stacked Scene (leading room
    axis), ``sources``/``listeners`` are ``[n_rooms, 2]`` (listeners may be
    ``[n_rooms, L, 2]``). The rooms are vmapped through the trace and
    the deposit in one program.

    ``room_offset`` (traced) is the GLOBAL index of row 0 — mesh shards
    pass their shard offset so room ``i`` traces with
    ``fold_in(key, offset + i)``.

    ``directivity`` (``[C]`` shared or ``[R, C]`` per room) and
    ``mic_directivity`` (``[C]``, ``[L, C]``, ``[R, L, C]``) apply the
    same Fourier-gain weighting as the single-scene trace."""
    n_rooms = sources.shape[0]
    room_ids = (jnp.asarray(room_offset, jnp.int32)
                + jnp.arange(n_rooms, dtype=jnp.int32))
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(room_ids)

    n_l = listeners.shape[1] if listeners.ndim == 3 else 1
    # explicit omni rows keep one_room uniform under vmap; multiplying
    # by an exact 1.0 is bit-identical to no pattern
    d = jnp.ones((1,), jnp.float32) if directivity is None \
        else jnp.asarray(directivity, jnp.float32)
    dirs = jnp.broadcast_to(jnp.atleast_2d(d), (n_rooms, d.shape[-1]))
    m = jnp.ones((1, 1), jnp.float32) if mic_directivity is None \
        else jnp.atleast_2d(jnp.asarray(mic_directivity, jnp.float32))
    if m.ndim == 2:
        m = m[None]
    mics = jnp.broadcast_to(m, (n_rooms, n_l, m.shape[-1]))

    def one_room(scene, src, lis, d_r, m_r, k):
        p = TraceParams.make(src, lis, listener_radius, speed_of_sound,
                             input_gain, directivity=d_r,
                             mic_directivity=m_r)
        state = irm.IRState.zeros(ir_length, p.listeners.shape[0],
                                  scene.n_bands)

        def body(st, i):
            hits = trace_hits_only(scene, p, jax.random.fold_in(k, i),
                                   n_rays=n_rays, max_bounces=max_bounces)
            return irm.accumulate(st, hits, sample_rate), None

        state, _ = jax.lax.scan(body, state,
                                jnp.arange(n_frames, dtype=jnp.int32))
        return state.normalized()

    return jax.vmap(one_room)(scenes, sources, listeners, dirs, mics, keys)


def sweep_rooms_sharded(scenes: Scene, sources: jax.Array,
                        listeners: jax.Array, key: jax.Array, mesh: Mesh, *,
                        n_rays: int, max_bounces: int, sample_rate: int,
                        ir_length: int, n_frames: int = 1,
                        axis: str = "rooms", **pose_kw) -> jax.Array:
    """Shard the room batch over ``mesh[axis]`` with ``shard_map``; each
    device sweeps its local rooms through :func:`sweep_rooms`, and the
    dataset is gathered from the sharded output. Room count must divide
    evenly. Per-room keys are global-id-indexed, so each room draws the
    same stream as in the unsharded sweep."""
    n_rooms = sources.shape[0]
    n_dev = mesh.shape[axis]
    if n_rooms % n_dev != 0:
        raise ValueError(f"{n_rooms} rooms not divisible by {axis}={n_dev}")
    local = n_rooms // n_dev
    other = tuple(a for a in mesh.axis_names if a != axis)
    spec = P(axis)

    # check_vma off: the per-shard room_offset (axis_index) mixes with
    # replicated operands; outputs are genuinely rooms-sharded.
    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(spec, spec, spec), out_specs=spec,
             check_vma=False)
    def run(scenes_l, src_l, lis_l):
        d = jax.lax.axis_index(axis)
        irs = sweep_rooms(scenes_l, src_l, lis_l, key, n_rays=n_rays,
                          max_bounces=max_bounces, sample_rate=sample_rate,
                          ir_length=ir_length, n_frames=n_frames,
                          room_offset=d * local,
                          **pose_kw)
        for a in other:
            irs = jax.lax.pmean(irs, a)   # no-op for size-1 extra axes
        return irs

    return run(scenes, sources, listeners)
