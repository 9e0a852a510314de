"""End-to-end demo: trace the SmollRoom, render debug views, bake and
stream a synthetic clip, and write all artifacts to ./demo_out/.

Run:  python examples/demo.py  [--cpu]
(--cpu forces the CPU backend; without it the default device runs it)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (default: the default device)")
parser.add_argument("--out", default="demo_out")
args = parser.parse_args()

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import realisticaudioraytracing2d_tpu as art  # noqa: E402
from realisticaudioraytracing2d_tpu.utils import audio_io, viz  # noqa: E402

os.makedirs(args.out, exist_ok=True)
key = jax.random.PRNGKey(0)

# --- scene + engine ---------------------------------------------------------
room = art.rooms.smoll_room()
cfg = art.smoll_room_config(ray_count=4096)
eng = art.Engine(room.scene, cfg)
params = eng.params(room.source, room.listener)

# --- trace + debug views ----------------------------------------------------
t0 = time.perf_counter()
state = eng.trace_frames(params, key, n_frames=8)
jax.block_until_ready(state)
print(f"traced 8 frames x 4096 rays in {time.perf_counter() - t0:.2f}s "
      f"(incl. compile)")

_, dbg = eng.trace_debug(params, key, n_debug=64)
viz.save_image(os.path.join(args.out, "scene.png"),
               viz.render_scene(room.scene, room.source, room.listener,
                                room.listener_radius, dbg,
                                draw_normals=True))
viz.save_image(os.path.join(args.out, "ir.png"),
               viz.ir_waveform_image(state.sum[0], state.frames))
print("wrote scene.png, ir.png")

# --- offline bake -----------------------------------------------------------
dry = audio_io.click_clip(1.0, cfg.audio.sample_rate,
                          click_times=(0.1, 0.5))
wet = np.asarray(eng.bake(jax.numpy.asarray(dry), state))
audio_io.write_wav(os.path.join(args.out, "bake.wav"), wet,
                   cfg.audio.sample_rate)
print("wrote bake.wav (two clicks through the room reverb)")

# --- streaming with a moving listener ---------------------------------------
streamer = art.Streamer(room.scene, cfg, key)
dry2 = audio_io.noise_burst(0.8, cfg.audio.sample_rate, seed=2)


def moving(i):
    # listener walks +x at 2 m/s
    pos = room.listener + np.array([2.0 * i * cfg.audio.chunk_duration, 0.0],
                                   np.float32)
    return eng.params(room.source, pos)


t0 = time.perf_counter()
wet2 = np.asarray(streamer.stream_clip(jax.numpy.asarray(dry2), moving))
dt = time.perf_counter() - t0
audio_io.write_wav(os.path.join(args.out, "stream.wav"), wet2[0],
                   cfg.audio.sample_rate)
xrt = (wet2.shape[-1] / cfg.audio.sample_rate) / dt
print(f"wrote stream.wav ({xrt:.2f}x realtime incl. compile)")

# --- inverse problems (differentiable acoustics) ------------------------------
# Localization needs a line-of-sight first arrival (SmollRoom's source
# hides behind the transmissive slant wall — see diff.localize_source),
# so this section runs in a shoebox, the validated regime.
from realisticaudioraytracing2d_tpu import diff  # noqa: E402
from realisticaudioraytracing2d_tpu.models.materials import \
    AudioMaterial  # noqa: E402
from realisticaudioraytracing2d_tpu.models.rooms import \
    shoebox_room  # noqa: E402
from realisticaudioraytracing2d_tpu.ops.trace import TraceParams  # noqa: E402

box = shoebox_room(4.0, 4.0, wall_material=AudioMaterial(absorption=0.3,
                                                         scattering=0.4))
p_box = TraceParams.make(source=(-1.0, 0.4), listeners=(1.0, 0.3),
                         listener_radius=0.5)
tiny = diff.simulate_ir(box, p_box, key, n_rays=256, max_bounces=4,
                        sample_rate=8000, ir_length=512, soft=True)
t0 = time.perf_counter()
loc = diff.localize_source(box, p_box, tiny, key, n_rays=256,
                           max_bounces=4, sample_rate=8000, n_starts=4,
                           steps=120)
pos = np.asarray(loc.position)
print(f"localized a shoebox source at ({pos[0]:+.2f}, {pos[1]:+.2f}) from "
      f"one listener's IR in {time.perf_counter() - t0:.1f}s (true "
      f"(-1.00, +0.40))")

# --- banded (frequency-dependent) variant ------------------------------------
room_b = art.rooms.smoll_room(n_bands=8)
cfg_b = art.smoll_room_config(ray_count=2048, n_bands=8)
eng_b = art.Engine(room_b.scene, cfg_b)
state_b = eng_b.trace_frames(eng_b.params(room_b.source, room_b.listener),
                             key, n_frames=4)
viz.save_image(os.path.join(args.out, "spectrogram.png"),
               viz.ir_spectrogram_image(state_b.sum[0], state_b.frames))
wet_b = np.asarray(eng_b.bake(jax.numpy.asarray(dry), state_b))
audio_io.write_wav(os.path.join(args.out, "bake_banded.wav"), wet_b,
                   cfg_b.audio.sample_rate)
print("wrote spectrogram.png, bake_banded.wav (8-band HF-rolloff materials)")

# --- room-acoustics analysis + physics addenda (docs/ACOUSTICS.md) ------------
from realisticaudioraytracing2d_tpu import analysis  # noqa: E402
from realisticaudioraytracing2d_tpu.ops import air, directivity  # noqa: E402

sr_b = cfg_b.audio.sample_rate
ir_b = state_b.normalized()
wet_ir = air.apply_air_absorption(
    ir_b, sr_b, air.iso9613_alpha(air.band_frequencies(8)))
m_dry = analysis.analyze_ir(ir_b, sr_b)
m_wet = analysis.analyze_ir(wet_ir, sr_b)
print(f"SmollRoom band 0/7 RT60(T20): "
      f"{m_dry['rt60_t20_s'][0, 0]:.3f}/{m_dry['rt60_t20_s'][0, 7]:.3f} s "
      f"(with air absorption: {m_wet['rt60_t20_s'][0, 0]:.3f}/"
      f"{m_wet['rt60_t20_s'][0, 7]:.3f} s); "
      f"D50 {m_dry['d50'][0, 0]:.2f}, direct "
      f"{m_dry['direct_distance_m'][0, 0]:.1f} m")
viz.save_image(os.path.join(args.out, "edc.png"),
               viz.decay_curve_image(np.asarray(ir_b)[0]))

state_card = eng_b.trace_frames(
    eng_b.params(room_b.source, room_b.listener,
                 directivity=directivity.cardioid(0.0)), key, n_frames=4)
e_omni = float(np.asarray(state_b.sum).sum())
e_card = float(np.asarray(state_card.sum).sum())
print(f"cardioid source aimed +x vs omni: {e_card / e_omni:.2f}x captured "
      f"energy (same total radiated power); wrote edc.png")

print(f"done -> {args.out}/")
