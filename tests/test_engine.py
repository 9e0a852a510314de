"""End-to-end engine tests: the minimum slice of SURVEY.md section 7.2
(scene -> trace -> IR accumulate -> convolve -> audio out) plus a golden-IR
regression on the SmollRoom fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import realisticaudioraytracing2d_tpu as art
from realisticaudioraytracing2d_tpu.engine import (Engine, bake_audio,
                                                   trace_accumulate)
from realisticaudioraytracing2d_tpu.ops import ir as irm
from realisticaudioraytracing2d_tpu.utils.audio_io import click_clip


@pytest.fixture(scope="module")
def small_setup():
    room = art.rooms.smoll_room()
    cfg = art.smoll_room_config(ray_count=1024)
    # short IR to keep CPU tests fast
    import dataclasses
    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, reverb_duration=0.25))
    eng = Engine(room.scene, cfg)
    return room, cfg, eng


def test_end_to_end_bake(small_setup):
    room, cfg, eng = small_setup
    p = eng.params(room.source, room.listener)
    state = eng.trace_frames(p, jax.random.PRNGKey(0), n_frames=2)
    assert int(state.frames) == 2
    ir = np.asarray(state.normalized())
    assert ir.sum() > 0

    dry = jnp.asarray(click_clip(0.1, cfg.audio.sample_rate))
    wet = np.asarray(eng.bake(dry, state))
    assert wet.shape == (dry.shape[0] + cfg.audio.ir_length,)
    assert np.abs(wet).max() == pytest.approx(1.0, rel=1e-4)  # normalized
    # click at 0.05 s + direct path delay ~0.0627 s -> first energy there
    first = np.nonzero(np.abs(wet) > 1e-6)[0][0]
    t_direct = 0.05 + (np.linalg.norm(room.source - room.listener)
                       - 0.5) / 343.0
    assert first / cfg.audio.sample_rate == pytest.approx(t_direct, abs=0.01)


def test_accumulation_is_linear_mean_of_frames(small_setup):
    # The 8-frame accumulated sum equals the sum of the 8 single-frame
    # scatters (deterministic linearity of Monte-Carlo accumulation).
    room, cfg, eng = small_setup
    p = eng.params(room.source, room.listener)
    key = jax.random.PRNGKey(1)
    s8 = eng.trace_frames(p, key, n_frames=8)
    assert int(s8.frames) == 8
    from realisticaudioraytracing2d_tpu.ops.rng import frame_key
    from realisticaudioraytracing2d_tpu.ops.trace import trace_hits_only
    total = np.zeros_like(np.asarray(s8.sum))
    for i in range(8):
        hits = trace_hits_only(room.scene, p, frame_key(key, i),
                               n_rays=cfg.sim.ray_count,
                               max_bounces=cfg.sim.max_bounces)
        total += np.asarray(irm.scatter_hits(hits, cfg.audio.sample_rate,
                                             cfg.audio.ir_length))
    np.testing.assert_allclose(np.asarray(s8.sum), total, rtol=1e-5,
                               atol=1e-7)


def test_accumulate_is_resumable(small_setup):
    # Functional checkpoint/resume: accumulating 2 frames then 2 more equals
    # 4 frames with the same per-frame keys.
    room, cfg, eng = small_setup
    p = eng.params(room.source, room.listener)
    key = jax.random.PRNGKey(5)
    s4 = eng.trace_frames(p, key, n_frames=4)
    s2 = eng.trace_frames(p, key, n_frames=2)
    # resume: frames 2..3 use fold_in(key, 2), fold_in(key, 3)
    from realisticaudioraytracing2d_tpu.ops.rng import frame_key
    from realisticaudioraytracing2d_tpu.ops.trace import trace_hits_only
    st = s2
    for i in [2, 3]:
        hits = trace_hits_only(room.scene, p, frame_key(key, i),
                               n_rays=cfg.sim.ray_count,
                               max_bounces=cfg.sim.max_bounces)
        st = irm.accumulate(st, hits, cfg.audio.sample_rate)
    np.testing.assert_allclose(np.asarray(st.sum), np.asarray(s4.sum),
                               rtol=1e-6)
    assert int(st.frames) == 4


def test_golden_ir_smoll_room():
    """Golden regression: fixed seed, fixed config -> stable IR statistics.

    Guards the full trace+scatter numerics. (Exact hash would be too
    brittle across jax versions; we pin robust statistics tightly.)
    """
    room = art.rooms.smoll_room()
    p = art.TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    state = trace_accumulate(
        room.scene, p, irm.IRState.zeros(72000, 1, 1),
        jax.random.PRNGKey(42), n_rays=4096, max_bounces=5,
        sample_rate=48000, n_frames=2)
    ir = np.asarray(state.normalized())[0, :, 0]
    nz = np.nonzero(ir)[0]
    # Geometric direct-path bin is ~3011 ((22.02-0.5)/343*48000), but the
    # slant wall's fast medium (Material ior=0.6 -> in-wall speed c/0.6)
    # lets transmitted paths arrive a little earlier — observed 2955.
    assert 2900 <= nz[0] <= 3015
    assert 3000 <= ir.argmax() <= 3120          # observed 3058
    assert ir.sum() == pytest.approx(0.2073, rel=0.1)
    # reverb decays: energy in first half dominates last quarter
    q = len(ir) // 4
    assert ir[:2 * q].sum() > 10 * ir[3 * q:].sum()


def test_bake_multi_listener(small_setup):
    room, cfg, eng2 = small_setup
    eng = Engine(room.scene, cfg, n_listeners=2)
    ears = np.stack([room.listener, room.listener + [0.4, 0.0]])
    p = eng.params(room.source, ears)
    state = eng.trace_frames(p, jax.random.PRNGKey(0), n_frames=1)
    dry = jnp.asarray(click_clip(0.1, cfg.audio.sample_rate,
                                 click_times=(0.02,)))
    wet = np.asarray(eng.bake(dry, state, normalize=False))
    assert np.abs(wet).max() > 0
    assert wet.shape[0] == 2
    assert not np.allclose(wet[0], wet[1])


def test_big_room_end_to_end():
    """Big Room fixture: 10x geometry with inputGain=100 compensating the
    inverse-square losses (Big Room.unity:161). The gain must bring the
    captured energy to the same order as SmollRoom's."""
    import dataclasses

    big = art.rooms.big_room()
    cfg = art.big_room_config(ray_count=4096)
    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, sample_rate=8000,
                                       reverb_duration=1.5))
    eng = Engine(big.scene, cfg)
    p = eng.params(big.source, big.listener)
    st = eng.trace_frames(p, jax.random.PRNGKey(0), n_frames=2)
    ir = np.asarray(st.normalized())[0, :, 0]
    assert ir.sum() > 0
    # first arrival >= straight-line distance/c (no faster-than-geometry)
    nz = np.nonzero(ir)[0]
    d = np.linalg.norm(big.source - big.listener)
    # Material slant wall has ior 0.6 -> slightly early arrivals possible,
    # and border ior 0.01 shortcuts are blocked by wallDepth gating.
    assert nz[0] >= (d - 50) / 343.0 * 8000 * 0.5
    # energy comparable to a SmollRoom trace (gain compensates 10x scale)
    small = art.rooms.smoll_room()
    cfg_s = art.smoll_room_config(ray_count=4096)
    cfg_s = dataclasses.replace(
        cfg_s, audio=dataclasses.replace(cfg_s.audio, sample_rate=8000,
                                         reverb_duration=1.5))
    eng_s = Engine(small.scene, cfg_s)
    st_s = eng_s.trace_frames(eng_s.params(small.source, small.listener),
                              jax.random.PRNGKey(0), n_frames=2)
    e_big = float(st.normalized().sum())
    e_small = float(st_s.normalized().sum())
    assert 0.02 < e_big / e_small < 50


def test_sample_scene_end_to_end():
    # The repaired SampleScene fixture (open room, 3 walls): the direct
    # source->listener path is unobstructed, so the first IR energy lands
    # at (dist - listenerRadius)/c. Rays escaping the open side must not
    # crash or deposit energy (leakage fixture).
    import dataclasses
    room = art.rooms.sample_scene()
    cfg = art.sample_scene_config(ray_count=2048)
    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, reverb_duration=0.25))
    assert cfg.audio.sample_rate == 44100
    eng = Engine(room.scene, cfg)
    p = eng.params(room.source, room.listener)
    state = eng.trace_frames(p, jax.random.PRNGKey(3), n_frames=2)
    ir = np.asarray(state.normalized())[0, :, 0]
    assert ir.sum() > 0
    first = np.nonzero(ir)[0][0]
    t_direct = (np.linalg.norm(room.source - room.listener) - 0.5) / 343.0
    assert first / cfg.audio.sample_rate == pytest.approx(t_direct,
                                                          abs=0.005)
    # Open room, unobstructed short direct path: the direct-arrival region
    # dominates the IR (unlike SmollRoom, where the source hides behind the
    # transmissive slant wall), and the reverb tail decays.
    peak = int(np.argmax(ir))
    assert abs(peak - first) < int(0.01 * cfg.audio.sample_rate)
    head, tail = ir[:len(ir) // 2].sum(), ir[len(ir) // 2:].sum()
    assert tail < head


def test_incremental_accumulation_reduces_variance():
    # Monte-Carlo core claim: frame-averaged IRs converge — the variance
    # of the normalized IR across independent 8-frame estimates is well
    # below the variance across 1-frame estimates (re-added from round 1
    # with a sound estimator: compare dispersion of independent replicas
    # instead of a brittle fixed threshold).
    room = art.rooms.smoll_room()
    p = art.TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    kw = dict(n_rays=512, max_bounces=4, sample_rate=8000)

    def replicas(n_frames, n_rep, key0):
        outs = []
        for r in range(n_rep):
            st = trace_accumulate(
                room.scene, p, irm.IRState.zeros(2048, 1, 1),
                jax.random.PRNGKey(key0 + r), n_frames=n_frames, **kw)
            outs.append(np.asarray(st.normalized())[0, :, 0])
        return np.stack(outs)

    one = replicas(1, 6, 100)
    eight = replicas(8, 6, 500)
    # dispersion of the total-energy estimator
    v1 = one.sum(axis=1).var()
    v8 = eight.sum(axis=1).var()
    assert v8 < v1 / 2, (v1, v8)  # ~8x expected; 2x is a safe floor
    # means agree (unbiasedness)
    assert abs(one.sum(axis=1).mean() - eight.sum(axis=1).mean()) \
        < 4 * np.sqrt(v1 / 6)


def _removed_option_calls():
    from realisticaudioraytracing2d_tpu.models.rooms import random_rooms
    from realisticaudioraytracing2d_tpu.ops.trace import trace
    from realisticaudioraytracing2d_tpu.parallel.frames import (
        accumulate_frames_sharded)
    from realisticaudioraytracing2d_tpu.parallel.mesh import make_mesh
    from realisticaudioraytracing2d_tpu.parallel.multisource import (
        trace_sources_mixdown, trace_sources_mixdown_sharded)
    from realisticaudioraytracing2d_tpu.parallel.rays import (
        trace_rays_sharded)
    from realisticaudioraytracing2d_tpu.parallel.sweep import (
        sweep_rooms, sweep_rooms_sharded)

    room = art.rooms.smoll_room()
    p = art.TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    key = jax.random.PRNGKey(0)
    kw = dict(n_rays=64, max_bounces=2, sample_rate=8000)
    ir_kw = dict(kw, ir_length=512)
    rooms = random_rooms(2, seed=0, n_obstacles=1)
    mesh = make_mesh((2,), ("rooms",), devices=jax.devices()[:2])
    rays_mesh = make_mesh((2,), ("rays",), devices=jax.devices()[:2])
    return {
        "trace_accumulate": lambda: trace_accumulate(
            room.scene, p, irm.IRState.zeros(512), key, backend="fused",
            **kw),
        "trace_use_pallas": lambda: trace(room.scene, p, key, n_rays=64,
                                          max_bounces=2, use_pallas=True),
        "sweep_rooms": lambda: sweep_rooms(*rooms, key, backend="fused",
                                           **ir_kw),
        "sweep_rooms_sharded": lambda: sweep_rooms_sharded(
            *rooms, key, mesh, backend="fused", **ir_kw),
        "mixdown": lambda: trace_sources_mixdown(
            room.scene, p, key, backend="fused", **ir_kw),
        "mixdown_sharded": lambda: trace_sources_mixdown_sharded(
            room.scene, p._replace(source=np.tile(room.source, (2, 1))),
            key, rays_mesh, backend="fused", **ir_kw),
        "rays_sharded": lambda: trace_rays_sharded(
            room.scene, p, key, rays_mesh, backend="fused", **ir_kw),
        "frames_sharded": lambda: accumulate_frames_sharded(
            room.scene, p, irm.IRState.zeros(512), key, mesh, n_frames=2,
            backend="fused", **kw),
    }


@pytest.mark.parametrize("entry", [
    "trace_accumulate", "trace_use_pallas", "sweep_rooms",
    "sweep_rooms_sharded", "mixdown", "mixdown_sharded", "rays_sharded",
    "frames_sharded"])
def test_removed_kernel_option_raises(entry):
    # one trace path: asking for the retired kernel routes is an error,
    # never a silent fallback
    with pytest.raises(TypeError):
        _removed_option_calls()[entry]()
