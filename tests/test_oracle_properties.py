"""Properties of the one trace path (``ops/trace.py`` + ``ops/ir.py``),
stated against the path itself: listener independence, directivity
weighting, spatial steering, and sharded == unsharded on every mesh axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realisticaudioraytracing2d_tpu import spatial as sp
from realisticaudioraytracing2d_tpu.engine import trace_accumulate
from realisticaudioraytracing2d_tpu.models.materials import AudioMaterial
from realisticaudioraytracing2d_tpu.models.rooms import (random_rooms,
                                                         smoll_room)
from realisticaudioraytracing2d_tpu.models.scene import SceneBuilder
from realisticaudioraytracing2d_tpu.ops import directivity as dv
from realisticaudioraytracing2d_tpu.ops import rng as _rng
from realisticaudioraytracing2d_tpu.ops.geometry import PI
from realisticaudioraytracing2d_tpu.ops.ir import IRState, scatter_hits
from realisticaudioraytracing2d_tpu.ops.trace import (TraceParams,
                                                      trace_hits_only)
from realisticaudioraytracing2d_tpu.parallel.frames import (
    accumulate_frames_sharded)
from realisticaudioraytracing2d_tpu.parallel.mesh import make_mesh
from realisticaudioraytracing2d_tpu.parallel.multisource import (
    trace_sources_mixdown, trace_sources_mixdown_sharded)
from realisticaudioraytracing2d_tpu.parallel.rays import trace_rays_sharded
from realisticaudioraytracing2d_tpu.parallel.sweep import (
    sweep_rooms, sweep_rooms_sharded)

KW = dict(n_rays=512, max_bounces=4, sample_rate=8000)
IR_LEN = 8000
LISTENERS = np.asarray([[0.0, -3.68], [0.5, -3.68], [-6.0, 2.0],
                        [8.0, -1.0], [3.0, 1.0], [-3.0, -2.0],
                        [6.0, 3.0], [-8.0, -1.0]], np.float32)


def _ir(scene, p, key, n_frames=1, **kw):
    kw = {**KW, **kw}
    st = trace_accumulate(scene, p, IRState.zeros(
        IR_LEN, p.listeners.shape[0], scene.n_bands), key,
        n_frames=n_frames, **kw)
    return np.asarray(st.sum)


def echo_scene():
    # reflective wall at x=10; source at origin, listener at (5, 0):
    # direct sound from -x, the wall echo from +x
    m = AudioMaterial(absorption=0.1, scattering=0.0, transmission=0.0,
                      ior=1.0)
    b = SceneBuilder(n_bands=1)
    b.add_segment((10.0, -20.0), (10.0, 20.0), (-1.0, 0.0), m)
    return b.build()


def _echo_params(**kw):
    return TraceParams.make(np.float32([0.0, 0.0]), np.float32([5.0, 0.0]),
                            listener_radius=0.5, **kw)


@pytest.mark.parametrize("n_bands", [1, 4])
@pytest.mark.parametrize("n_listeners", [1, 2, 4, 8])
def test_listeners_trace_independently(n_listeners, n_bands):
    # ray physics never reads the listener table, so L listeners at once
    # deposit exactly what each listener traced alone does
    room = smoll_room(n_bands=n_bands)
    lis = LISTENERS[:n_listeners]
    key = jax.random.PRNGKey(3)
    p = TraceParams.make(room.source, lis, 0.5, 343.0, 1.0)
    together = _ir(room.scene, p, key)
    assert together.shape == (n_listeners, IR_LEN, n_bands)
    for i in range(n_listeners):
        alone = _ir(room.scene, p._replace(listeners=p.listeners[i:i + 1]),
                    key)
        np.testing.assert_array_equal(together[i:i + 1], alone)
    assert (together.sum(axis=(1, 2)) > 0).any()


@pytest.mark.parametrize("which", ["source", "mic", "both"])
def test_omni_coded_patterns_equal_omni(which):
    # an explicit omni pattern takes the directive code path yet changes
    # nothing: the gain is exactly 1 per ray and per hit
    room = smoll_room()
    key = jax.random.PRNGKey(0)
    p = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    one = jnp.asarray([1.0], jnp.float32)
    coded = p._replace(
        directivity=one if which in ("source", "both") else None,
        mic_directivity=one[None] if which in ("mic", "both") else None)
    a = _ir(room.scene, p, key)
    assert a.sum() > 0
    np.testing.assert_array_equal(a, _ir(room.scene, coded, key))


@pytest.mark.parametrize("aim", [0.0, 1.0, 2.5])
def test_cardioid_pair_sums_to_omni(aim):
    # per hit (1 + cos(t - a)) + (1 - cos(t - a)) = 2; the NEE cutoff runs
    # before mic weighting, so all three traces keep the same paths
    room = smoll_room()
    key = jax.random.PRNGKey(1)
    p = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    omni = _ir(room.scene, p, key)
    front = _ir(room.scene, p._replace(
        mic_directivity=jnp.asarray(dv.cardioid(aim))), key)
    back = _ir(room.scene, p._replace(
        mic_directivity=jnp.asarray(dv.cardioid(aim + np.pi))), key)
    assert omni.sum() > 0
    rel = np.linalg.norm(front + back - 2 * omni) / np.linalg.norm(2 * omni)
    assert rel < 1e-5, rel


@pytest.mark.parametrize("pattern", [dv.cardioid(0.0), dv.cardioid(2.0),
                                     dv.figure_eight(0.3)],
                         ids=["cardioid0", "cardioid2", "figure8"])
def test_source_directivity_weights_emission(pattern):
    # bounce-0 direct captures are decided by geometry alone, so a
    # directive source keeps them and scales each by g(emission angle)
    scene = echo_scene()
    key = jax.random.PRNGKey(2)
    n_rays, bounces = 1024, 2
    omni = trace_hits_only(scene, _echo_params(), key, n_rays=n_rays,
                           max_bounces=bounces)
    dirp = trace_hits_only(scene, _echo_params(directivity=pattern), key,
                           n_rays=n_rays, max_bounces=bounces)
    jitter, _ = _rng.bounce_uniforms(key, bounces, n_rays)
    angle = (jnp.arange(n_rays, dtype=jnp.float32) + jitter) / n_rays \
        * (2.0 * PI)
    g = np.asarray(dv.evaluate(jnp.asarray(pattern), angle))
    v0 = np.asarray(omni.valid[0, 0, :, 0])
    np.testing.assert_array_equal(v0, np.asarray(dirp.valid[0, 0, :, 0]))
    assert v0.sum() > 0
    e_o = np.asarray(omni.energy[0, 0, :, 0, 0])[v0]
    e_d = np.asarray(dirp.energy[0, 0, :, 0, 0])[v0]
    np.testing.assert_allclose(e_d, e_o * g[v0], rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("aim", [0.0, 1.1, 2.5, -2.0])
def test_spatial_steer_equals_traced_cardioid(aim):
    # steering the 3-mic spatial IR == tracing that cardioid directly
    scene = echo_scene()
    key = jax.random.PRNGKey(1)
    kw = dict(n_rays=4096, max_bounces=2)
    p = _echo_params()
    s = sp.spatial_from_ir(jnp.asarray(_ir(scene, sp.spatial_params(p), key,
                                           **kw)))
    want = _ir(scene, p._replace(
        mic_directivity=jnp.asarray(dv.cardioid(aim))), key, **kw)
    got = np.asarray(s.steer(aim))
    assert want.sum() > 0
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


@pytest.mark.parametrize("n_src", [2, 3])
def test_mixdown_per_source_aims_matches_manual_sum(n_src):
    # mixdown with [S, C] aims == the sum of per-source scatters traced
    # with the same split keys
    room = smoll_room()
    key = jax.random.PRNGKey(0)
    p = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    srcs = jnp.asarray([[0.0, -3.0], [1.0, -3.0], [-1.0, -2.5]][:n_src],
                       jnp.float32)
    # pad the 3-coeff cardioids with zero 2nd-harmonic terms to stack
    # them with the 5-coeff figure-eight (zero coefficients are exact)
    aims = jnp.stack([jnp.pad(jnp.asarray(dv.cardioid(0.0)), (0, 2)),
                      jnp.asarray(dv.figure_eight(1.0)),
                      jnp.pad(jnp.asarray(dv.cardioid(2.0)), (0, 2))
                      ][:n_src]).astype(jnp.float32)
    pm = p._replace(source=srcs, directivity=aims)
    mix = np.asarray(trace_sources_mixdown(room.scene, pm, key,
                                           ir_length=IR_LEN, **KW))
    keys = jax.random.split(key, n_src)
    want = 0
    for i in range(n_src):
        hits = trace_hits_only(room.scene,
                               p._replace(source=srcs[i],
                                          directivity=aims[i]),
                               keys[i], n_rays=KW["n_rays"],
                               max_bounces=KW["max_bounces"])
        want = want + np.asarray(scatter_hits(hits, 8000, IR_LEN))
    assert want.sum() > 0
    np.testing.assert_allclose(mix, want, atol=1e-6)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sweep_directive_sharded_matches_unsharded(n_dev):
    # directive patterns ride the sharded sweep untouched (per-room keys
    # are global-room-id indexed)
    room = smoll_room()
    key = jax.random.PRNGKey(0)
    n_rooms = 2 * n_dev
    scenes = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (n_rooms,) + x.shape),
        room.scene)
    srcs = jnp.broadcast_to(jnp.asarray(room.source)[None], (n_rooms, 2))
    lis = jnp.broadcast_to(jnp.asarray(room.listener)[None], (n_rooms, 2))
    kw = dict(n_rays=256, max_bounces=4, sample_rate=8000, ir_length=IR_LEN,
              directivity=jnp.asarray(dv.cardioid(0.5)),
              mic_directivity=jnp.asarray(dv.cardioid(2.0)))
    a = np.asarray(sweep_rooms(scenes, srcs, lis, key, **kw))
    mesh = make_mesh((n_dev,), ("rooms",), devices=jax.devices()[:n_dev])
    b = np.asarray(sweep_rooms_sharded(scenes, srcs, lis, key, mesh, **kw))
    assert a.sum() > 0
    np.testing.assert_array_equal(a, b)


SH = dict(n_rays=256, max_bounces=3, sample_rate=8000)
SH_IR = 2048


def _sharded_case(kind, n_dev):
    """(sharded result, reference) for one mesh axis."""
    devs = jax.devices()[:n_dev]
    room = smoll_room()
    p = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    key = jax.random.PRNGKey(17)
    if kind == "rays":
        mesh = make_mesh((n_dev,), ("rays",), devices=devs)
        got = trace_rays_sharded(room.scene, p, key, mesh,
                                 ir_length=SH_IR, **SH)
        want = 0
        for d in range(n_dev):
            hits = trace_hits_only(room.scene, p, jax.random.fold_in(key, d),
                                   n_rays=SH["n_rays"] // n_dev,
                                   max_bounces=SH["max_bounces"])
            want = want + np.asarray(scatter_hits(hits, 8000, SH_IR))
        return np.asarray(got), want
    if kind == "frames":
        mesh = make_mesh((n_dev,), ("rooms",), devices=devs)
        st0 = IRState.zeros(SH_IR, 1, 1)
        got = accumulate_frames_sharded(room.scene, p, st0, key, mesh,
                                        n_frames=2 * n_dev, **SH)
        want = trace_accumulate(room.scene, p, st0, key,
                                n_frames=2 * n_dev, **SH)
        assert int(got.frames) == 2 * n_dev
        return np.asarray(got.sum), np.asarray(want.sum)
    if kind == "sweep":
        scenes, srcs, lis = random_rooms(2 * n_dev, seed=4, n_obstacles=1)
        mesh = make_mesh((n_dev,), ("rooms",), devices=devs)
        kw = dict(SH, ir_length=SH_IR)
        return (np.asarray(sweep_rooms_sharded(scenes, srcs, lis, key, mesh,
                                               **kw)),
                np.asarray(sweep_rooms(scenes, srcs, lis, key, **kw)))
    srcs = np.tile(np.asarray(room.source), (n_dev, 1)).astype(np.float32)
    srcs[:, 0] += np.linspace(-2, 2, n_dev)
    mesh = make_mesh((1, n_dev), ("rooms", "rays"), devices=devs)
    got = trace_sources_mixdown_sharded(room.scene, p._replace(source=srcs),
                                        key, mesh, ir_length=SH_IR, **SH)
    keys = jax.random.split(key, n_dev)
    want = 0
    for i in range(n_dev):
        want = want + np.asarray(trace_sources_mixdown(
            room.scene, p._replace(source=srcs[i:i + 1]), keys[i],
            ir_length=SH_IR, **SH))
    return np.asarray(got), want


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("kind", ["rays", "frames", "sweep", "multisource"])
def test_sharded_equals_unsharded(kind, n_dev):
    got, want = _sharded_case(kind, n_dev)
    assert np.asarray(want).sum() > 0
    if kind == "sweep":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
