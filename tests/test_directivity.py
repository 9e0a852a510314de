"""Source directivity (ops/directivity.py + emission weighting)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from realisticaudioraytracing2d_tpu.config import smoll_room_config
from realisticaudioraytracing2d_tpu.engine import Engine, trace_accumulate
from realisticaudioraytracing2d_tpu.models.materials import AudioMaterial
from realisticaudioraytracing2d_tpu.models.rooms import smoll_room
from realisticaudioraytracing2d_tpu.models.scene import SceneBuilder
from realisticaudioraytracing2d_tpu.ops import directivity as dv
from realisticaudioraytracing2d_tpu.ops.ir import IRState
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams


def test_evaluate_matches_presets():
    theta = jnp.linspace(0, 2 * np.pi, 64)
    g = np.asarray(dv.evaluate(jnp.asarray(dv.cardioid(0.3)), theta))
    np.testing.assert_allclose(g, 1 + np.cos(np.asarray(theta) - 0.3),
                               atol=1e-5)
    g8 = np.asarray(dv.evaluate(jnp.asarray(dv.figure_eight(0.0)), theta))
    np.testing.assert_allclose(g8, 2 * np.cos(np.asarray(theta)) ** 2,
                               atol=1e-5)


def test_from_function_recovers_cardioid():
    c = dv.from_function(lambda t: 1 + np.cos(t - 0.7), n_harmonics=4)
    np.testing.assert_allclose(c[:3], dv.cardioid(0.7), atol=1e-6)
    np.testing.assert_allclose(c[3:], 0.0, atol=1e-6)


def test_from_function_rejects_negative():
    with pytest.raises(ValueError):
        dv.from_function(lambda t: np.cos(t))


def far_field():
    # single distant wall so the scene is non-empty; effectively free field
    m = AudioMaterial(absorption=1.0, scattering=0.0, transmission=0.0,
                      ior=1.0)
    b = SceneBuilder(n_bands=1)
    b.add_segment((500.0, -1.0), (500.0, 1.0), (1.0, 0.0), m)
    return b.build()


def run(scene, directivity, listener, rays=4096):
    p = TraceParams.make(np.float32([0.0, 0.0]), np.float32(listener),
                         listener_radius=0.5, directivity=directivity)
    st = trace_accumulate(scene, p, IRState.zeros(2048), jax.random.PRNGKey(0),
                          n_rays=rays, max_bounces=2, sample_rate=8000)
    return float(np.asarray(st.sum).sum())


def test_omni_none_equals_unit_coeff():
    scene = far_field()
    assert run(scene, None, (5.0, 0.0)) == pytest.approx(
        run(scene, dv.omni(), (5.0, 0.0)), rel=1e-6)


def test_cardioid_front_vs_back():
    scene = far_field()
    aim = dv.cardioid(0.0)   # aimed at +x
    front = run(scene, aim, (5.0, 0.0))
    back = run(scene, aim, (-5.0, 0.0))
    assert front > 0
    # g(pi) = 0 for the cardioid: the back listener only gets the tiny
    # near-null strata around pi
    assert back < 0.02 * front


def test_figure_eight_null_perpendicular():
    scene = far_field()
    f8 = dv.figure_eight(0.0)
    on_axis = run(scene, f8, (5.0, 0.0))
    null = run(scene, f8, (0.0, 5.0))
    assert null < 0.02 * on_axis


def test_linearity_in_pattern_scale():
    scene = far_field()
    e1 = run(scene, dv.cardioid(0.0), (5.0, 0.0))
    e2 = run(scene, 2.0 * dv.cardioid(0.0), (5.0, 0.0))
    assert e2 == pytest.approx(2 * e1, rel=1e-5)


def test_cardioid_front_matches_omni_level():
    # Mean-1 normalization: a cardioid's on-axis direct level is ~2x
    # omni (g(0) = 2), same total radiated power.
    scene = far_field()
    omni_e = run(scene, None, (5.0, 0.0))
    card_e = run(scene, dv.cardioid(0.0), (5.0, 0.0))
    assert card_e == pytest.approx(2 * omni_e, rel=0.05)


def test_engine_params_passthrough_and_room_trace():
    room = smoll_room()
    cfg = smoll_room_config(ray_count=2000)
    eng = Engine(room.scene, cfg)
    p = eng.params(room.source, room.listener,
                   directivity=dv.cardioid(np.pi / 4))
    st = eng.trace_frames(p, jax.random.PRNGKey(0), n_frames=2)
    assert float(np.asarray(st.sum).sum()) > 0


# ---- microphone (listener) pickup patterns --------------------------------


def run_mic(scene, mic, listener, rays=4096, aimfn=None):
    p = TraceParams.make(np.float32([0.0, 0.0]), np.float32(listener),
                         listener_radius=0.5, mic_directivity=mic)
    st = trace_accumulate(scene, p, IRState.zeros(2048),
                          jax.random.PRNGKey(0), n_rays=rays,
                          max_bounces=2, sample_rate=8000)
    return float(np.asarray(st.sum).sum())


def test_mic_cardioid_facing_source_vs_away():
    scene = far_field()
    # listener at (5, 0); sound arrives FROM -x, so a mic aimed at pi
    # (toward the source) hears it at g(pi...)=2, aimed at 0 hears ~0
    toward = run_mic(scene, dv.cardioid(np.pi), (5.0, 0.0))
    away = run_mic(scene, dv.cardioid(0.0), (5.0, 0.0))
    omni_e = run_mic(scene, None, (5.0, 0.0))
    assert toward == pytest.approx(2 * omni_e, rel=0.05)
    assert away < 0.02 * omni_e


def test_mic_hears_echo_not_direct():
    # A cardioid mic aimed at a reflective wall (away from the source)
    # must capture the NEE echo but suppress the direct path: the echo's
    # arrival bin dominates.
    m = AudioMaterial(absorption=0.1, scattering=0.0, transmission=0.0,
                      ior=1.0)
    b = SceneBuilder(n_bands=1)
    b.add_segment((10.0, -20.0), (10.0, 20.0), (-1.0, 0.0), m)
    scene = b.build()
    p_omni = TraceParams.make(np.float32([0.0, 0.0]),
                              np.float32([5.0, 0.0]), listener_radius=0.5)
    p_mic = p_omni._replace(
        mic_directivity=jnp.asarray(dv.cardioid(0.0)))  # aimed at wall
    def ir_of(p):
        st = trace_accumulate(scene, p, IRState.zeros(2048),
                              jax.random.PRNGKey(0), n_rays=8192,
                              max_bounces=2, sample_rate=8000)
        return np.asarray(st.sum)[0, :, 0]
    ir_omni, ir_mic = ir_of(p_omni), ir_of(p_mic)
    direct_bin = int(np.floor(5.0 / 343.0 * 8000))      # ~4.5 m to rim
    echo_bin = int(np.floor(15.0 / 343.0 * 8000))       # 10 + 5 via wall
    b_direct = slice(max(0, direct_bin - 3), direct_bin + 4)
    b_echo = slice(echo_bin - 3, echo_bin + 4)
    assert ir_omni[b_direct].sum() > 0 and ir_mic[b_echo].sum() > 0
    # direct suppressed by the mic, echo boosted (g(0 deg aim, from +x) = 2)
    assert ir_mic[b_direct].sum() < 0.05 * ir_omni[b_direct].sum()
    assert ir_mic[b_echo].sum() > 1.5 * ir_omni[b_echo].sum()


def test_mic_per_listener_patterns():
    # An XY pair: two coincident-ish mics with different aims hear
    # different levels from the same field.
    scene = far_field()
    mics = np.stack([dv.cardioid(np.pi), dv.cardioid(0.0)])   # [2, 3]
    p = TraceParams.make(np.float32([0.0, 0.0]),
                         np.float32([[5.0, 0.1], [5.0, -0.1]]),
                         listener_radius=0.5, mic_directivity=mics)
    st = trace_accumulate(scene, p, IRState.zeros(2048, 2),
                          jax.random.PRNGKey(0), n_rays=4096,
                          max_bounces=2, sample_rate=8000)
    per_l = np.asarray(st.sum).sum(axis=(1, 2))
    assert per_l[0] > 50 * max(per_l[1], 1e-12)


def test_mic_weights_diffraction_paths():
    from realisticaudioraytracing2d_tpu.models.materials import AudioMaterial
    from realisticaudioraytracing2d_tpu.ops import diffraction
    op = AudioMaterial(absorption=0.9, scattering=0.5, transmission=0.0,
                       ior=1.0)
    b = SceneBuilder(n_bands=1)
    b.add_segment((0.0, -4.0), (0.0, 4.0), (1.0, 0.0), op)
    scene = b.build()
    base = TraceParams.make(np.float32([-3.0, 0.0]), np.float32([3.0, 0.0]),
                            listener_radius=0.5)
    ir_omni = np.asarray(diffraction.diffraction_ir(
        scene, base, sample_rate=8000, ir_length=4000))
    # bent paths arrive from the barrier tips (roughly -x at the
    # listener): a cardioid aimed +x (away) suppresses them
    p_away = base._replace(mic_directivity=jnp.asarray(dv.cardioid(0.0)))
    ir_away = np.asarray(diffraction.diffraction_ir(
        scene, p_away, sample_rate=8000, ir_length=4000))
    p_toward = base._replace(
        mic_directivity=jnp.asarray(dv.cardioid(np.pi)))
    ir_toward = np.asarray(diffraction.diffraction_ir(
        scene, p_toward, sample_rate=8000, ir_length=4000))
    # tips at (0, +-4) seen from (3, 0): incoming angle has
    # cos = -3/5, so g_away = 1 - 0.6 = 0.4 and g_toward = 1.6 exactly
    assert ir_away.sum() == pytest.approx(0.4 * ir_omni.sum(), rel=1e-3)
    assert ir_toward.sum() == pytest.approx(1.6 * ir_omni.sum(), rel=1e-3)
