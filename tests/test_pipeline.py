"""Pipeline properties at small size: chunked streaming == per-chunk
reconstruction, checkpoint save/resume of an accumulation, the
diffraction + air chunk step, directive levels, per-key determinism and
frame independence of the accumulation.

Reference contract: the ``FixedUpdate`` chunk clock + ``ProcessChunk``
dispatch (``RayTraceManager.cs:64-123``) — the chunked overlap-add output
is exactly the sum of its per-chunk crossfaded convolutions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import realisticaudioraytracing2d_tpu as art
from realisticaudioraytracing2d_tpu.engine import trace_accumulate
from realisticaudioraytracing2d_tpu.models.materials import AudioMaterial
from realisticaudioraytracing2d_tpu.models.scene import SceneBuilder
from realisticaudioraytracing2d_tpu.ops import directivity as dv
from realisticaudioraytracing2d_tpu.ops import ir as irm
from realisticaudioraytracing2d_tpu.ops import rng as _rng
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams
from realisticaudioraytracing2d_tpu.streaming import (Streamer,
                                                      _crossfaded_wet,
                                                      init_stream,
                                                      stream_chunk)
from realisticaudioraytracing2d_tpu.utils.audio_io import noise_burst

SR = 8000


def _small_cfg(n_bands=1):
    cfg = art.smoll_room_config(n_bands=n_bands, ray_count=1024)
    return dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, sample_rate=SR, reverb_duration=0.3))


@pytest.mark.parametrize("n_bands", [1, 2])
def test_chunked_stream_matches_per_chunk_reconstruction(n_bands):
    """The streamer's ring output equals the host overlap-add of the same
    per-chunk crossfaded convolutions, with per-chunk IRs retraced with
    the same chunk keys — drift in ring indexing, crossfade ramps or
    state donation shows up as a mismatch."""
    room = art.rooms.smoll_room(n_bands=n_bands)
    cfg = _small_cfg(n_bands)
    params = art.Engine(room.scene, cfg).params(room.source, room.listener)
    n, t = cfg.audio.chunk_samples, cfg.audio.ir_length
    total = 4
    key = jax.random.PRNGKey(11)
    dry = jnp.asarray(noise_burst(total * n / SR, SR, seed=5))
    wet = np.asarray(Streamer(room.scene, cfg, key).stream_clip(
        dry, lambda i: params, loop=False, total_chunks=total))[0]
    assert wet.shape == (total * n,) and np.abs(wet).max() > 0

    acc = np.zeros(total * n + n + t)
    prev = None
    for i in range(total):
        cur = trace_accumulate(
            room.scene, params, irm.IRState.zeros(t, 1, n_bands),
            _rng.frame_key(key, i), n_rays=cfg.sim.ray_count,
            max_bounces=cfg.sim.max_bounces, sample_rate=SR).normalized()
        piece = dry[i * n:(i + 1) * n]
        w = np.asarray(_crossfaded_wet(
            piece[None, :], cur if prev is None else prev, cur))[0]
        acc[i * n:i * n + len(w)] += w
        prev = cur
    np.testing.assert_allclose(wet, acc[:total * n], rtol=2e-3, atol=2e-5)


def test_checkpoint_resume_of_accumulation(tmp_path):
    """Preemption recovery (the CLI's --ir-in/--ir-out contract): save
    after 4 frames, reload bit-exactly, resume 4 more with a fresh key;
    the result is the saved sum plus the 4 new frames."""
    from realisticaudioraytracing2d_tpu.utils.checkpoint import (
        load_ir_state, save_ir_state)
    room = art.rooms.smoll_room()
    p = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    key = jax.random.PRNGKey(21)
    kw = dict(n_rays=1024, max_bounces=5, sample_rate=SR)
    t = 2400
    half = trace_accumulate(room.scene, p, irm.IRState.zeros(t, 1, 1), key,
                            n_frames=4, **kw)
    path = str(tmp_path / "ckpt.npz")
    save_ir_state(path, half)
    loaded = load_ir_state(path)
    assert int(loaded.frames) == 4
    np.testing.assert_array_equal(np.asarray(half.sum),
                                  np.asarray(loaded.sum))
    k2 = jax.random.fold_in(key, 4)
    resumed = trace_accumulate(room.scene, p, loaded, k2, n_frames=4, **kw)
    fresh = trace_accumulate(room.scene, p, irm.IRState.zeros(t, 1, 1), k2,
                             n_frames=4, **kw)
    assert int(resumed.frames) == 8
    assert float(fresh.sum.sum()) > 0
    np.testing.assert_allclose(np.asarray(resumed.sum),
                               np.asarray(half.sum) + np.asarray(fresh.sum),
                               rtol=1e-5, atol=1e-9)


OPAQUE = AudioMaterial(absorption=0.9, scattering=0.5, transmission=0.0,
                       ior=1.0)


def test_stream_chunk_diffraction_and_air():
    # the barrier shadow is exactly silent in the plain chunk step; the
    # in-jit diffraction fill lights it, and air absorption attenuates it
    b = SceneBuilder(n_bands=1)
    b.add_segment((0.0, -4.0), (0.0, 4.0), (1.0, 0.0), OPAQUE)
    scene = b.build()
    p = TraceParams.make(np.float32([-3.0, 0.0]), np.float32([3.0, 0.0]),
                         listener_radius=0.5)
    dry = jnp.ones(256, jnp.float32)
    key = jax.random.PRNGKey(0)
    kw = dict(n_rays=256, max_bounces=2, sample_rate=SR)
    out_plain, _ = stream_chunk(scene, p, init_stream(1024, 256), dry,
                                key, **kw)
    assert float(jnp.abs(out_plain).sum()) == 0.0
    out_diff, _ = stream_chunk(scene, p, init_stream(1024, 256), dry,
                               key, diffraction=True, **kw)
    e_diff = float(jnp.abs(out_diff).sum())
    assert e_diff > 0.0 and np.isfinite(e_diff)
    out_air, _ = stream_chunk(scene, p, init_stream(1024, 256), dry, key,
                              diffraction=True,
                              air_alpha=jnp.asarray([5.0]), **kw)
    assert 0.0 < float(jnp.abs(out_air).sum()) < e_diff


def _far_field_energy(directivity, mic):
    m = AudioMaterial(absorption=1.0, scattering=0.0, transmission=0.0,
                      ior=1.0)
    b = SceneBuilder(n_bands=1)
    b.add_segment((500.0, -1.0), (500.0, 1.0), (1.0, 0.0), m)
    p = TraceParams.make(np.float32([0.0, 0.0]), np.float32([5.0, 0.0]),
                         listener_radius=0.5, directivity=directivity,
                         mic_directivity=mic)
    st = trace_accumulate(b.build(), p, irm.IRState.zeros(2048),
                          jax.random.PRNGKey(0), n_rays=2048,
                          max_bounces=2, sample_rate=SR)
    return float(np.asarray(st.sum).sum())


def test_directive_source_and_mic_levels():
    # on-axis cardioid = 2x omni (mean-1 normalization); a source or mic
    # facing away from the other end of the direct path hears ~nothing
    omni = _far_field_energy(None, None)
    assert _far_field_energy(dv.cardioid(0.0), None) \
        == pytest.approx(2 * omni, rel=0.05)
    assert _far_field_energy(dv.cardioid(np.pi), None) < 0.02 * omni
    assert _far_field_energy(None, dv.cardioid(0.0)) < 0.02 * omni


@pytest.mark.parametrize("n_bands", [1, 4])
def test_accumulation_deterministic_per_key(n_bands):
    # same key -> bit-identical IR across calls
    room = art.rooms.smoll_room(n_bands=n_bands)
    p = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    kw = dict(n_rays=2048, max_bounces=4, sample_rate=SR, n_frames=3)

    def run():
        return np.asarray(trace_accumulate(
            room.scene, p, irm.IRState.zeros(2400, 1, n_bands),
            jax.random.PRNGKey(3), **kw).sum)

    a = run()
    assert a.sum() > 0
    np.testing.assert_array_equal(a, run())


def test_frames_are_independent_samples():
    # each frame folds its index into the key: a 2-frame sum is not twice
    # a 1-frame sum (a key-reuse bug would duplicate whole frames)
    room = art.rooms.smoll_room()
    p = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    kw = dict(n_rays=2048, max_bounces=4, sample_rate=SR)
    key = jax.random.PRNGKey(5)
    one = trace_accumulate(room.scene, p, irm.IRState.zeros(2400, 1, 1),
                           key, n_frames=1, **kw)
    two = trace_accumulate(room.scene, p, irm.IRState.zeros(2400, 1, 1),
                           key, n_frames=2, **kw)
    assert float(one.sum.sum()) > 0
    assert not np.allclose(np.asarray(two.sum), 2 * np.asarray(one.sum))
