"""Command-line interface: ``trace``, ``bake``, ``stream``, ``sweep``,
``bench``.

The headless counterpart of the reference's interactive keyboard API
(Space = stream/bake toggle, R = reset — ``RayTraceManager.cs:55-61``):
each subcommand runs one pipeline end to end and writes files (WAV, PNG,
NPZ) instead of playing/drawing live.

Usage examples::

    python -m realisticaudioraytracing2d_tpu.cli trace --room smoll \
        --out ir.png --scene-out scene.png
    python -m realisticaudioraytracing2d_tpu.cli bake --room smoll \
        --in dry.wav --out wet.wav --frames 16
    python -m realisticaudioraytracing2d_tpu.cli stream --room big \
        --in dry.wav --out wet.wav --move-listener 1.0,0.0
    python -m realisticaudioraytracing2d_tpu.cli sweep --rooms 64 \
        --out dataset.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def load_scene_json(spec, default_bands: int = 1):
    """Build a RoomSetup from the exported-collider JSON schema.

    The schema mirrors the reference's collider flattening inputs
    (SceneHelper.cs:29-76): a list of colliders, each with a transform
    (position/angle/scale), a type-specific shape (box: size+offset;
    polygon: paths; circle: radius+offset+resolution) and a material
    (absorption/scattering/transmission/ior, optionally band_absorption).
    Top-level: source, listener (or listeners), listener_radius, n_bands,
    and optional ``directivity`` / ``mic_directivity`` patterns (a spec
    string like "cardioid:30", explicit Fourier coefficients, or — for
    mics — a per-listener list of spec strings).
    ``boxes: [...]`` is accepted as shorthand for box colliders.
    """
    import numpy as np

    from .models.materials import AudioMaterial
    from .models.rooms import RoomSetup
    from .models.scene import SceneBuilder, Transform2D

    n_bands = int(spec.get("n_bands", default_bands))
    b = SceneBuilder(n_bands=n_bands)

    def tf_of(c):
        return Transform2D(position=tuple(c.get("position", (0, 0))),
                           angle=float(c.get("angle", 0.0)),
                           scale=tuple(c.get("scale", (1, 1))))

    def mat_of(c):
        m = dict(c.get("material", {}))
        if "band_absorption" in m and m["band_absorption"] is not None:
            m["band_absorption"] = tuple(m["band_absorption"])
        return AudioMaterial(**m)

    colliders = list(spec.get("colliders", []))
    colliders += [dict(c, type="box") for c in spec.get("boxes", [])]
    if not colliders:
        raise SystemExit("scene json has no colliders/boxes")
    for c in colliders:
        kind = c.get("type", "box")
        if kind == "box":
            b.add_box(mat_of(c), tf_of(c), size=tuple(c.get("size", (1, 1))),
                      offset=tuple(c.get("offset", (0, 0))))
        elif kind == "polygon":
            b.add_polygon([np.asarray(p, np.float64) for p in c["paths"]],
                          mat_of(c), tf_of(c))
        elif kind == "circle":
            b.add_circle(mat_of(c), tf_of(c),
                         radius=float(c.get("radius", 0.5)),
                         offset=tuple(c.get("offset", (0, 0))),
                         resolution=int(c.get("resolution", 32)))
        else:
            raise SystemExit(f"unknown collider type {kind!r}")
    listener = spec.get("listeners", spec.get("listener"))

    def pattern_of(key):
        # "cardioid:30" / "figure8" / explicit coefficient list;
        # mic patterns also accept a list of per-listener specs
        v = spec.get(key)
        if v is None:
            return None
        if isinstance(v, str):
            return _parse_pattern(v)
        v = list(v)
        if v and isinstance(v[0], str):
            pats = [_parse_pattern(x) for x in v]
            width = max(len(p) for p in pats)
            return np.stack([np.pad(p, (0, width - len(p)))
                             for p in pats])
        return np.asarray(v, np.float32)

    return RoomSetup(
        scene=b.build(),
        source=np.asarray(spec["source"], np.float32),
        listener=np.asarray(listener, np.float32),
        listener_radius=float(spec.get("listener_radius", 0.5)),
        directivity=pattern_of("directivity"),
        mic_directivity=pattern_of("mic_directivity"))


def _build_room(args):
    from .models import rooms as rooms_mod
    from .models.materials import AudioMaterial
    from .models.rooms import RoomSetup
    from .models.scene import SceneBuilder, Transform2D

    if args.scene_json:
        with open(args.scene_json) as f:
            spec = json.load(f)
        return load_scene_json(spec, default_bands=args.bands)
    if args.room == "smoll":
        return rooms_mod.smoll_room(n_bands=args.bands)
    if args.room == "big":
        return rooms_mod.big_room(n_bands=args.bands)
    if args.room == "sample":
        return rooms_mod.sample_scene(n_bands=args.bands)
    raise SystemExit(f"unknown room {args.room!r}")


def _config(args):
    from .config import (big_room_config, sample_scene_config,
                         smoll_room_config)
    maker = {"big": big_room_config,
             "sample": sample_scene_config}.get(args.room,
                                                smoll_room_config)
    cfg = maker(n_bands=args.bands, ray_count=args.rays)
    sim = dataclasses.replace(cfg.sim, max_bounces=args.bounces)
    audio = dataclasses.replace(cfg.audio, sample_rate=args.sample_rate,
                                reverb_duration=args.reverb)
    return dataclasses.replace(cfg, sim=sim, audio=audio)


def _common(p):
    p.add_argument("--room", default="smoll",
                   choices=["smoll", "big", "sample"])
    p.add_argument("--scene-json", default=None,
                   help="JSON scene file overriding --room")
    p.add_argument("--rays", type=int, default=15000)
    p.add_argument("--bounces", type=int, default=5)
    p.add_argument("--bands", type=int, default=1)
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--reverb", type=float, default=1.5)
    p.add_argument("--frames", type=int, default=8,
                   help="Monte-Carlo trace frames to accumulate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stereo", default=None, metavar="SEP",
                   help="stereo output with two ear listeners SEP apart")
    p.add_argument("--directivity", default=None, metavar="PATTERN",
                   help="source directivity: omni (default), "
                        "cardioid[:AIM_DEG], figure8[:AIM_DEG] — "
                        "weighted at emission (jnp path)")
    p.add_argument("--mic-directivity", default=None, metavar="PATTERN",
                   help="listener pickup pattern (same syntax); "
                        "weighted by arrival angle at each capture")
    p.add_argument("--stereo-aim", type=float, default=None, metavar="DEG",
                   help="with --stereo: record through an XY cardioid "
                        "pair aimed at +-DEG (overrides "
                        "--mic-directivity)")


def _parse_pattern(spec):
    if spec is None or spec == "omni":
        return None
    from .ops import directivity as dv
    name, _, aim = spec.partition(":")
    aim_rad = float(aim) * np.pi / 180.0 if aim else 0.0
    try:
        return {"cardioid": dv.cardioid,
                "figure8": dv.figure_eight}[name](aim_rad)
    except KeyError:
        raise SystemExit(f"unknown directivity {name!r}; pick "
                         "omni/cardioid/figure8")


def _directivity_arr(args, room=None):
    """--directivity coefficients; falls back to the scene JSON's
    shipped pattern when the flag is absent."""
    flag = _parse_pattern(getattr(args, "directivity", None))
    if flag is not None:
        return flag
    return getattr(room, "directivity", None)


def _mic_directivity_arr(args, room=None):
    aim = getattr(args, "stereo_aim", None)
    if aim is not None:
        if getattr(args, "stereo", None) is None:
            raise SystemExit("--stereo-aim needs --stereo")
        from .ops import directivity as dv
        a = float(aim) * np.pi / 180.0
        # left ear listens left (+aim), right ear right (-aim)
        return np.stack([dv.cardioid(a), dv.cardioid(-a)])
    flag = _parse_pattern(getattr(args, "mic_directivity", None))
    if flag is not None:
        return flag
    return getattr(room, "mic_directivity", None)


def _air_args(p):
    p.add_argument("--diffraction", action="store_true",
                   help="add edge diffraction (Maekawa knife-edge "
                        "shadow-zone fill; traced scenes only, ignored "
                        "with analyze --ir-in)")
    p.add_argument("--diffraction-order", type=int, default=1,
                   choices=[1, 2],
                   help="2 adds edge-to-edge double diffraction "
                        "(rounds thick obstacles; O(W^3), room-scale "
                        "scenes)")
    p.add_argument("--air", action="store_true",
                   help="apply ISO 9613-1 atmospheric absorption to the "
                        "IR (per-band via log-spaced band centers)")
    p.add_argument("--air-temp", type=float, default=20.0, metavar="C")
    p.add_argument("--air-humidity", type=float, default=50.0,
                   metavar="PCT")


def _air_alpha_arr(args, n_bands):
    """Per-band ISO 9613-1 alpha [K] (dB/m) for --air, else None."""
    if not getattr(args, "air", False):
        return None
    import jax.numpy as jnp

    from .ops import air
    freqs = air.band_frequencies(n_bands)
    alpha = air.iso9613_alpha(freqs, args.air_temp, args.air_humidity)
    print("air absorption: " + ", ".join(
        f"{f:.0f} Hz {a * 1000:.1f} dB/km" for f, a in zip(freqs, alpha)))
    return jnp.asarray(alpha, jnp.float32)


def _apply_air(state, sample_rate, speed_of_sound, args):
    """Fold atmospheric absorption into an IRState's accumulated sum
    (linear, so equivalent to attenuating each normalized IR)."""
    if not getattr(args, "air", False):
        return state
    from .ops import air
    n_bands = state.sum.shape[-1]
    freqs = air.band_frequencies(n_bands)
    alpha = air.iso9613_alpha(freqs, args.air_temp, args.air_humidity)
    print("air absorption: " + ", ".join(
        f"{f:.0f} Hz {a * 1000:.1f} dB/km" for f, a in zip(freqs, alpha)))
    return state._replace(sum=air.apply_air_absorption(
        state.sum, sample_rate, alpha, speed_of_sound))


def _apply_diffraction(state, scene, trace_params, sample_rate, args):
    """Add the deterministic first-order edge-diffraction IR (Maekawa
    knife-edge shadow-zone fill, ops/diffraction.py) to an IRState. The
    term has no Monte-Carlo variance, so it scales by the frame count in
    the accumulated sum."""
    if not getattr(args, "diffraction", False):
        return state
    import jax.numpy as jnp

    from .ops.diffraction import diffraction_ir
    d_ir = diffraction_ir(scene, trace_params, sample_rate=sample_rate,
                          ir_length=state.ir_length,
                          order=args.diffraction_order)
    print(f"diffraction: added {float(d_ir.sum()):.3g} shadow-zone "
          f"energy/frame over {int((np.asarray(d_ir) > 0).any(axis=(1, 2)).sum())}"
          f"/{d_ir.shape[0]} listeners")
    frames = jnp.maximum(1, state.frames).astype(jnp.float32)
    return state._replace(sum=state.sum + frames * d_ir)


def cmd_trace(args):
    import jax

    from .engine import Engine
    from .utils import viz

    room = _build_room(args)
    cfg = _config(args)
    listeners, n_l = _listeners(args, room)
    eng = Engine(room.scene, cfg, n_listeners=n_l)
    p = eng.params(room.source, listeners,
                   directivity=_directivity_arr(args, room),
                   mic_directivity=_mic_directivity_arr(args, room))
    key = jax.random.PRNGKey(args.seed)
    state = None
    start_frame = 0
    if args.ir_in:
        # resume Monte-Carlo accumulation from a checkpoint (preemption
        # recovery for long runs); frame keys continue past the saved count
        from .utils.checkpoint import load_ir_state
        state = load_ir_state(args.ir_in)
        start_frame = int(state.frames)
        key = jax.random.fold_in(key, start_frame)
        print(f"resuming from {args.ir_in} at frame {start_frame}")
    t0 = time.perf_counter()
    raw_state = eng.trace_frames(p, key, n_frames=args.frames, state=state)
    # Diffraction/air are linear views on the IR: displayed/printed
    # outputs get them, but --ir-out checkpoints the RAW accumulation so
    # a resume can't double-apply them. Diffraction first — air also
    # attenuates the diffracted paths.
    state = _apply_diffraction(raw_state, room.scene, p,
                               cfg.audio.sample_rate, args)
    state = _apply_air(state, cfg.audio.sample_rate,
                       cfg.sim.speed_of_sound, args)
    ir = np.asarray(state.normalized())[0, :, 0]  # readback = sync barrier
    dt = time.perf_counter() - t0
    print(f"traced {args.frames} frames x {args.rays} rays in {dt:.3f}s; "
          f"IR energy {ir.sum():.5f}, peak bin {ir.argmax()} "
          f"({ir.argmax() / cfg.audio.sample_rate * 1e3:.2f} ms)")
    wf_gain = 1000.0 if args.gain is None else args.gain
    if args.out:
        img = viz.ir_waveform_image(state.sum[0], state.frames,
                                    gain=wf_gain)
        viz.save_image(args.out, img)
        print(f"wrote {args.out}")
    if args.spectro_out:
        if room.scene.n_bands > 1:
            img = viz.ir_spectrogram_image(state.sum[0], state.frames,
                                           gain=args.gain)
        else:
            # scalar IR: derive the legacy muffled spectrogram
            from .ops import legacy
            from .ops.trace import trace_hits_only
            hits = trace_hits_only(room.scene, p, key,
                                   n_rays=cfg.sim.ray_count,
                                   max_bounces=cfg.sim.max_bounces)
            lst = legacy.LegacyIRState.zeros(
                cfg.audio.ir_length // legacy.DEFAULT_WINDOW_SIZE, n_l)
            lst = legacy.accumulate_legacy(lst, hits,
                                           cfg.audio.sample_rate)
            img = viz.ir_spectrogram_image(lst.sum[0], lst.frames,
                                           gain=args.gain)
        viz.save_image(args.spectro_out, img)
        print(f"wrote {args.spectro_out}")
    if args.scene_out:
        _, dbg = eng.trace_debug(p, key, n_debug=args.debug_rays)
        lis0 = np.asarray(listeners, np.float32).reshape(-1, 2)[0]
        extra = viz.diffraction_polylines(
            room.scene, p, order=args.diffraction_order) \
            if args.diffraction else None
        img = viz.render_scene(room.scene, room.source, lis0,
                               room.listener_radius, dbg,
                               extra_paths=extra)
        viz.save_image(args.scene_out, img)
        print(f"wrote {args.scene_out}")
    if args.ir_out:
        from .utils.checkpoint import save_ir_state
        save_ir_state(args.ir_out, raw_state)
        print(f"wrote {args.ir_out}")
    if args.spatial_out:
        _write_spatial(args, room, cfg, p, key)


def _write_spatial(args, room, cfg, p, key):
    """Trace the 3-virtual-mic spatial capture and write W/X/Y +
    direction-of-arrival channels (npz); print the arrival table."""
    from . import spatial as spm
    if p.mic_directivity is not None:
        raise SystemExit("--spatial-out replaces --mic-directivity "
                         "(steer the spatial IR afterwards instead)")
    sp_ir, _ = spm.trace_spatial(
        room.scene, p, key, n_rays=cfg.sim.ray_count,
        max_bounces=cfg.sim.max_bounces,
        sample_rate=cfg.audio.sample_rate,
        ir_length=cfg.audio.ir_length, n_frames=args.frames)
    np.savez(args.spatial_out,
             w=np.asarray(sp_ir.w), x=np.asarray(sp_ir.x),
             y=np.asarray(sp_ir.y),
             arrival_angle=np.asarray(sp_ir.arrival_angle()),
             diffuseness=np.asarray(sp_ir.diffuseness()),
             sample_rate=cfg.audio.sample_rate)
    print(f"wrote {args.spatial_out}")
    arrivals = spm.dominant_arrivals(sp_ir, cfg.audio.sample_rate)
    for i, a in enumerate(arrivals):
        print(f"  arrival {i}: t={a['time_s'] * 1e3:7.2f} ms  "
              f"from {np.degrees(a['bearing_rad']):7.1f} deg  "
              f"diffuseness {a['diffuseness']:.3f}  "
              f"energy {a['energy']:.4g}")


def _listeners(args, room):
    """Listener array + count: honors --stereo (ear pair +-sep/2 on x)
    and multi-listener scene JSON (``listeners: [[..], [..]]``)."""
    base = np.asarray(room.listener, np.float32)
    if getattr(args, "stereo", None) is not None:
        if base.ndim > 1:
            base = base.reshape(-1, 2)[0]
        sep = float(args.stereo)
        ears = np.stack([base - [sep / 2, 0.0],
                         base + [sep / 2, 0.0]]).astype(np.float32)
        return ears, 2
    if base.ndim > 1:
        return base.reshape(-1, 2), base.reshape(-1, 2).shape[0]
    return base, 1


def cmd_bake(args):
    import jax
    import jax.numpy as jnp

    from .engine import Engine
    from .ops.convolve import load_samples
    from .utils.audio_io import (builtin_clip_path, read_audio,
                                 write_audio)

    room = _build_room(args)
    cfg = _config(args)
    listeners, n_l = _listeners(args, room)
    eng = Engine(room.scene, cfg, n_listeners=n_l)
    p = eng.params(room.source, listeners,
                   directivity=_directivity_arr(args, room),
                   mic_directivity=_mic_directivity_arr(args, room))
    x, rate = read_audio(args.infile or builtin_clip_path())
    dry = np.asarray(load_samples(jnp.asarray(x), rate,
                                  cfg.audio.sample_rate))
    if getattr(args, "binaural", None) is not None:
        if args.legacy:
            raise SystemExit("--binaural is not available with --legacy")
        if getattr(args, "stereo", None) is not None \
                or p.mic_directivity is not None:
            raise SystemExit("--binaural replaces --stereo and "
                             "--mic-directivity (it assigns the ear "
                             "patterns itself)")
        if n_l != 1:
            raise SystemExit("--binaural needs exactly one listener "
                             "(one head)")
        from . import spatial as spm
        from .engine import trace_accumulate
        from .ops import ir as irm
        from .ops.convolve import apply_ir, peak_normalize
        spp = spm.spatial_params(p)
        state = irm.IRState.zeros(cfg.audio.ir_length,
                                  spp.listeners.shape[0],
                                  room.scene.n_bands)
        state = trace_accumulate(room.scene, spp, state,
                                 jax.random.PRNGKey(args.seed),
                                 n_rays=cfg.sim.ray_count,
                                 max_bounces=cfg.sim.max_bounces,
                                 sample_rate=cfg.audio.sample_rate,
                                 n_frames=args.frames)
        state = _apply_diffraction(state, room.scene, spp,
                                   cfg.audio.sample_rate, args)
        state = _apply_air(state, cfg.audio.sample_rate,
                           cfg.sim.speed_of_sound, args)
        sp_ir = spm.spatial_from_ir(state.normalized())
        lft, rgt = sp_ir.binaural(cfg.audio.sample_rate,
                                  facing=float(np.radians(args.binaural)),
                                  head_radius=args.head_radius,
                                  speed_of_sound=cfg.sim.speed_of_sound)
        ears = jnp.concatenate([lft, rgt], axis=0)       # [2, T, K]
        t0 = time.perf_counter()
        wet = apply_ir(jnp.asarray(dry), ears)
        if not args.no_normalize:
            wet = peak_normalize(wet)
        wet = np.asarray(wet)
        dt = time.perf_counter() - t0
        write_audio(args.out, wet.T, cfg.audio.sample_rate)
        xrt = (len(dry) / cfg.audio.sample_rate) / dt
        print(f"binaural bake (facing {args.binaural:.0f} deg, head "
              f"{args.head_radius * 100:.1f} cm): {len(dry)} samples in "
              f"{dt:.3f}s ({xrt:.1f}x realtime) -> {args.out}")
        return
    if args.legacy:
        # legacy frequency-binned pipeline (RayTraceManagerComplex +
        # RaytraceOcclusion2D parity): muffled time x freq IR rendered
        # back to the time domain, then convolved
        from .ops import legacy
        from .ops.convolve import apply_ir, peak_normalize
        from .ops.rng import frame_key
        from .ops.trace import trace_hits_only
        key = jax.random.PRNGKey(args.seed)
        w = legacy.DEFAULT_WINDOW_SIZE
        lst = legacy.LegacyIRState.zeros(cfg.audio.ir_length // w, n_l, w)
        for i in range(args.frames):
            hits = trace_hits_only(room.scene, p, frame_key(key, i),
                                   n_rays=cfg.sim.ray_count,
                                   max_bounces=cfg.sim.max_bounces)
            lst = legacy.accumulate_legacy(lst, hits,
                                           cfg.audio.sample_rate)
        ir_td = legacy.legacy_ir_to_time_domain(
            lst.normalized(), cfg.audio.sample_rate, cfg.audio.ir_length,
            w)                                     # [L, T]
        t0 = time.perf_counter()
        wet = apply_ir(jnp.asarray(dry), ir_td[..., None])
        if not args.no_normalize:
            wet = peak_normalize(wet)
        wet = np.asarray(wet if n_l > 1 else wet[0])
        dt = time.perf_counter() - t0
    else:
        state = eng.trace_frames(p, jax.random.PRNGKey(args.seed),
                                 n_frames=args.frames)
        state = _apply_diffraction(state, room.scene, p,
                                   cfg.audio.sample_rate, args)
        state = _apply_air(state, cfg.audio.sample_rate,
                           cfg.sim.speed_of_sound, args)
        t0 = time.perf_counter()
        wet = np.asarray(eng.bake(jnp.asarray(dry), state,
                                  normalize=not args.no_normalize))
        dt = time.perf_counter() - t0
    write_audio(args.out, wet.T if wet.ndim > 1 else wet,
              cfg.audio.sample_rate)
    xrt = (len(dry) / cfg.audio.sample_rate) / dt
    print(f"baked {len(dry)} samples in {dt:.3f}s ({xrt:.1f}x realtime) "
          f"-> {args.out}")


def cmd_stream(args):
    import jax
    import jax.numpy as jnp

    from .engine import Engine
    from .ops.convolve import load_samples
    from .streaming import Streamer
    from .utils.audio_io import (builtin_clip_path, read_audio,
                                 write_audio)

    room = _build_room(args)
    cfg = _config(args)
    listeners, n_l = _listeners(args, room)
    eng = Engine(room.scene, cfg, n_listeners=n_l)
    x, rate = read_audio(args.infile or builtin_clip_path())
    dry = jnp.asarray(load_samples(jnp.asarray(x), rate,
                                   cfg.audio.sample_rate))
    chunk_dt = cfg.audio.chunk_duration
    poses = _trajectory_poses(args, eng, room, listeners, chunk_dt)
    binaural, facing_fn = _binaural_setup(args, room, n_l, chunk_dt)
    poses, facing_fn, scene_fn, control_fn = _pose_feed_wrap(
        args, poses, facing_fn, room=room, binaural=binaural)
    streamer = Streamer(room.scene, cfg, jax.random.PRNGKey(args.seed),
                        n_listeners=n_l,
                        frames_per_chunk=args.frames_per_chunk,
                        diffraction=(args.diffraction
                                     and args.diffraction_order),
                        air_alpha=_air_alpha_arr(args, room.scene.n_bands),
                        binaural=binaural,
                        head_radius=getattr(args, "head_radius", 0.0875),
                        **_arrival_kwargs(args))
    on_chunk = None
    if args.viz_every:
        viz_cb = _viz_callback(args.out, args.viz_every)
        on_chunk = lambda i, st: viz_cb(i, st.prev_ir)  # noqa: E731
    t0 = time.perf_counter()
    doppler = _doppler_arg(args)
    if args.duration is not None:
        # timed stream: the clip wraps at its end while config.audio.loop
        # is set (RayTraceManager.cs:74-77), else pads with silence
        total_chunks = max(1, int(round(args.duration / chunk_dt)))
        wet = np.asarray(streamer.stream_clip(dry, poses,
                                              scene_fn=scene_fn,
                                              total_chunks=total_chunks,
                                              on_chunk=on_chunk,
                                              facing_fn=facing_fn,
                                              doppler=doppler,
                                              control_fn=control_fn))
    else:
        # play the clip once and flush the reverb tail
        wet = np.asarray(streamer.stream_clip(dry, poses, loop=False,
                                              scene_fn=scene_fn,
                                              on_chunk=on_chunk,
                                              facing_fn=facing_fn,
                                              doppler=doppler,
                                              control_fn=control_fn))
    dt = time.perf_counter() - t0
    if args.viz_every:
        viz_cb.flush()
    n_out = streamer.n_listeners
    write_audio(args.out, wet.T if n_out > 1 else wet[0],
              cfg.audio.sample_rate)
    xrt = (wet.shape[-1] / cfg.audio.sample_rate) / dt
    print(f"streamed {wet.shape[-1]} samples in {dt:.2f}s "
          f"({xrt:.2f}x realtime) -> {args.out}")


def _binaural_setup(args, room, n_l: int, chunk_dt: float):
    """Shared ``--binaural`` validation + per-chunk head-facing builder
    for the stream/live commands. Returns ``(enabled, facing_fn)``;
    ``facing_fn(i)`` is radians at chunk ``i`` (``--head-turn`` deg/s
    rotation, traced so it recompiles nothing)."""
    binaural = getattr(args, "binaural", None)
    if binaural is None:
        return False, None
    if getattr(args, "stereo", None) is not None \
            or _mic_directivity_arr(args, room) is not None:
        raise SystemExit("--binaural replaces --stereo and "
                         "--mic-directivity (it assigns the ear "
                         "patterns itself)")
    if n_l != 1:
        raise SystemExit("--binaural needs exactly one listener "
                         "(one head)")
    base = float(np.radians(binaural))
    turn = float(np.radians(getattr(args, "head_turn", 0.0))) * chunk_dt
    return True, (lambda i: base + turn * i)


def _arrival_kwargs(args):
    """Per-arrival Doppler tuning flags -> Streamer/LivePlayer kwargs
    (the streaming._ARRIVAL_* constants are the single source of the
    defaults; docs/ACOUSTICS.md documents them)."""
    from .streaming import (_ARRIVAL_MATCH_BINS, _ARRIVAL_TAPS,
                            _ARRIVAL_WINDOW_S)
    return dict(
        arrival_taps=getattr(args, "arrival_taps", _ARRIVAL_TAPS),
        arrival_window_s=getattr(args, "arrival_window",
                                 _ARRIVAL_WINDOW_S),
        arrival_match_bins=getattr(args, "arrival_match_bins",
                                   _ARRIVAL_MATCH_BINS))


def _arrival_args(p):
    from .streaming import (_ARRIVAL_MATCH_BINS, _ARRIVAL_TAPS,
                            _ARRIVAL_WINDOW_S)
    p.add_argument("--arrival-taps", type=int, default=_ARRIVAL_TAPS,
                   metavar="N",
                   help="per-arrival Doppler: tracked early arrivals per "
                        f"listener (default {_ARRIVAL_TAPS}; raise for "
                        "scenes with many comparable early reflections)")
    p.add_argument("--arrival-window", type=float,
                   default=_ARRIVAL_WINDOW_S, metavar="S",
                   help="per-arrival Doppler: early IR window the taps "
                        f"may live in, seconds (default "
                        f"{_ARRIVAL_WINDOW_S})")
    p.add_argument("--arrival-match-bins", type=float,
                   default=_ARRIVAL_MATCH_BINS, metavar="B",
                   help="per-arrival Doppler: max IR-bin drift matched "
                        f"chunk-to-chunk (default "
                        f"{_ARRIVAL_MATCH_BINS:.0f} = ~0.5 m at 48 kHz)")


def _doppler_arg(args):
    """``--doppler`` / ``--doppler-per-arrival`` -> the ``doppler=``
    value (the flags are an argparse mutually-exclusive group — the two
    modes are different physics, rejected at parse time)."""
    per = getattr(args, "doppler_per_arrival", False)
    return "per_arrival" if per else args.doppler


def _trajectory_poses(args, eng, room, listeners, chunk_dt):
    """``--move-listener``/``--move-source`` linear-drift trajectory as a
    ``params_fn(chunk) -> TraceParams``. ONE definition shared by
    ``stream`` and ``live`` so the two pipelines cannot diverge on
    trajectory semantics (they already share the physics via
    DopplerFeed/wet_chunk)."""
    vel = np.asarray([float(v) for v in args.move_listener.split(",")]) \
        if args.move_listener else np.zeros(2)
    svel = np.asarray([float(v) for v in args.move_source.split(",")]) \
        if args.move_source else np.zeros(2)

    def poses(i):
        drift = (vel * i * chunk_dt).astype(np.float32)
        sdrift = (svel * i * chunk_dt).astype(np.float32)
        return eng.params(np.asarray(room.source, np.float32) + sdrift,
                          listeners + drift,
                          directivity=_directivity_arr(args, room),
                          mic_directivity=_mic_directivity_arr(args, room))

    return poses


def _pose_feed_wrap(args, poses, facing_fn, room=None, binaural=False):
    """Wrap the trajectory's ``poses``/``facing_fn`` with a
    ``--pose-feed`` JSON-lines channel (file being appended to, or ``-``
    = stdin) — live steering of a running stream/live pipeline, the
    reference's edit-the-scene-while-it-plays loop
    (RayTraceManager.cs:50-61,67). Returns ``(poses, facing_fn,
    scene_fn, control_fn)``: the feed also re-poses named colliders
    (``obstacle`` lines re-flatten through the room's SceneBuilder, same
    padded wall count — RayTraceManager.cs:67,246-250) and carries the
    runtime verbs (``stop``/``reset_ir`` = Space/R,
    RayTraceManager.cs:55-61). A well-formed ``facing`` override on a
    non-binaural stream has nowhere to go — it is surfaced with a
    one-time warning instead of silently dropped."""
    path = getattr(args, "pose_feed", None)
    if not path:
        return poses, facing_fn, None, None
    from .posefeed import PoseFeed

    feed = PoseFeed.open(path)
    if room is not None and getattr(room, "builder", None) is not None:
        feed.bind_scene(room.builder)
    base_facing = facing_fn if facing_fn is not None \
        else (lambda i: 0.0)
    warned = []

    def fed_poses(i):
        p = feed.params(poses(i), i)
        if not binaural and not warned \
                and feed.facing(None, i) is not None:
            import warnings
            warnings.warn(
                "pose feed 'facing' override ignored: this stream is not "
                "binaural (add --binaural to steer the head)",
                stacklevel=2)
            warned.append(True)
        return p

    fed_facing = (lambda i: feed.facing(base_facing(i), i)) \
        if binaural else None
    base_scene = room.scene if room is not None else None
    fed_scene = (lambda i: feed.scene(base_scene, i)) \
        if base_scene is not None else None
    return fed_poses, fed_facing, fed_scene, feed.control


def _viz_callback(out_path, every: int):
    """Periodic live-IR raster dump: every ``every`` chunks, write the
    current chunk's normalized IR waveform as ``<out stem>_ir_NNNN.png``
    — the reference's on-screen DrawIR blit during playback
    (RayTraceManager.cs:252-258), as files.

    The device readback + raster + PNG encode run on a single worker
    thread so a realtime live producer is not charged for host-side
    image work inside its chunk budget; call ``cb.flush()`` after the
    run to drain pending writes."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from .utils import viz

    stem = os.path.splitext(out_path)[0]
    pool = ThreadPoolExecutor(max_workers=1)

    def write(i, ir_host):
        img = viz.ir_waveform_image(ir_host, 1)
        path = f"{stem}_ir_{i:04d}.png"
        viz.save_image(path, img)
        print(f"wrote {path}")

    def cb(i, cur_ir):
        if i % every:
            return
        # snapshot on the producer thread: the streaming loop donates its
        # IR buffers, so a deferred device read would see a deleted array
        pool.submit(write, i, np.asarray(cur_ir)[0].copy())

    cb.flush = lambda: pool.shutdown(wait=True)
    return cb


def cmd_live(args):
    """Producer/consumer live pipeline: the streaming producer + an audio
    thread draining the native ring at DSP-buffer cadence — the
    ``AudioManager.OnAudioFilterRead`` contract (AudioManager.cs:56-69)
    driven end to end, with underruns reported instead of hidden."""
    import jax
    import jax.numpy as jnp

    from .engine import Engine
    from .live import LivePlayer
    from .ops.convolve import load_samples
    from .utils.audio_io import (builtin_clip_path, read_audio, write_audio)

    room = _build_room(args)
    cfg = _config(args)
    listeners, n_l = _listeners(args, room)
    eng = Engine(room.scene, cfg, n_listeners=n_l)
    x, rate = read_audio(args.infile or builtin_clip_path())
    dry = jnp.asarray(load_samples(jnp.asarray(x), rate,
                                   cfg.audio.sample_rate))
    total_chunks = max(1, int(round(args.duration
                                    / cfg.audio.chunk_duration)))
    binaural, facing_fn = _binaural_setup(args, room, n_l,
                                          cfg.audio.chunk_duration)
    chunk_dt = cfg.audio.chunk_duration
    poses = _trajectory_poses(args, eng, room, listeners, chunk_dt)
    poses, facing_fn, scene_fn, control_fn = _pose_feed_wrap(
        args, poses, facing_fn, room=room, binaural=binaural)
    player = LivePlayer(room.scene, cfg, jax.random.PRNGKey(args.seed),
                        n_listeners=n_l,
                        frames_per_chunk=args.frames_per_chunk,
                        dsp_buffer=args.dsp_buffer,
                        diffraction=(args.diffraction
                                     and args.diffraction_order),
                        air_alpha=_air_alpha_arr(args, room.scene.n_bands),
                        binaural=binaural,
                        head_radius=getattr(args, "head_radius", 0.0875),
                        **_arrival_kwargs(args))
    on_chunk = _viz_callback(args.out or "live.wav", args.viz_every) \
        if args.viz_every else None
    sink = None
    if args.play:
        from .native import AudioSink
        try:
            sink = AudioSink(cfg.audio.sample_rate, player.n_listeners,
                             device=args.play_device)
        except RuntimeError as e:
            raise SystemExit(
                f"--play: {e} (run without --play to record to a WAV)")
    try:
        rep = player.run(dry, total_chunks=total_chunks,
                         realtime=args.realtime or sink is not None,
                         params_fn=poses, scene_fn=scene_fn,
                         on_chunk=on_chunk, facing_fn=facing_fn,
                         doppler=_doppler_arg(args), sink=sink,
                         control_fn=control_fn)
    finally:
        if sink is not None:
            sink.close()
    if on_chunk is not None:
        on_chunk.flush()
    if args.out:
        n_out = player.n_listeners
        write_audio(args.out, rep.audio.T if n_out > 1 else rep.audio[0],
                  cfg.audio.sample_rate)
    print(f"live: {rep.summary()}" + (f" -> {args.out}" if args.out else ""))


def cmd_sweep(args):
    import jax

    if getattr(args, "stereo", None) is not None:
        print("note: --stereo is ignored by sweep (mono listeners per room)")

    from .models.rooms import random_rooms
    from .parallel.mesh import make_mesh
    from .parallel.sweep import sweep_rooms, sweep_rooms_sharded

    scenes, sources, listeners = random_rooms(args.rooms, seed=args.seed,
                                              n_bands=args.bands)
    ir_len = int(args.sample_rate * args.reverb)
    kw = dict(n_rays=args.rays, max_bounces=args.bounces,
              sample_rate=args.sample_rate, ir_length=ir_len,
              n_frames=args.frames)
    t0 = time.perf_counter()
    if args.sharded and len(jax.devices()) > 1:
        mesh = make_mesh((len(jax.devices()), 1))
        irs = sweep_rooms_sharded(scenes, sources, listeners,
                                  jax.random.PRNGKey(args.seed), mesh, **kw)
    else:
        irs = sweep_rooms(scenes, sources, listeners,
                          jax.random.PRNGKey(args.seed), **kw)
    irs = np.asarray(irs)
    dt = time.perf_counter() - t0
    np.savez_compressed(args.out, irs=irs, sources=sources,
                        listeners=listeners)
    print(f"swept {args.rooms} rooms in {dt:.2f}s "
          f"({args.rooms / dt:.1f} rooms/s) -> {args.out} "
          f"irs shape {irs.shape}")
    if args.metrics_out:
        from .analysis import analyze_dataset
        metrics = analyze_dataset(irs, args.sample_rate)  # already
        # frame-normalized by sweep_rooms
        np.savez_compressed(args.metrics_out, **metrics)
        rt = metrics["rt60_t20_s"]
        print(f"metrics -> {args.metrics_out}; RT60(T20) median "
              f"{np.nanmedian(rt):.3f}s over {np.isfinite(rt).sum()}"
              f"/{rt.size} decays spanning the fit window")


def cmd_fit(args):
    """Inverse material estimation: fit this scene's per-group materials to
    a target IR (an ``--ir-out`` checkpoint from ``trace``, or any IRState
    npz) by gradient descent through the ray tracer (`diff.fit_materials`).
    Writes a JSON report of fitted per-group materials."""
    import jax

    from . import diff
    from .engine import Engine
    from .utils.checkpoint import load_ir_state

    room = _build_room(args)
    cfg = _config(args)
    listeners, n_l = _listeners(args, room)
    target_state = load_ir_state(args.target)
    target = np.asarray(target_state.normalized())
    if target.shape[0] != n_l:
        raise SystemExit(
            f"target IR has {target.shape[0]} listeners; this setup has "
            f"{n_l} (use --stereo / scene JSON listeners to match)")
    if target.shape[-1] != room.scene.n_bands:
        raise SystemExit(
            f"target IR has {target.shape[-1]} bands; scene has "
            f"{room.scene.n_bands} (set --bands to match)")

    eng = Engine(room.scene, cfg, n_listeners=n_l)
    p = eng.params(room.source, listeners,
                   directivity=_directivity_arr(args, room),
                   mic_directivity=_mic_directivity_arr(args, room))
    groups, n_groups = diff.infer_material_groups(room.scene)
    fields = tuple(f for f in args.fields.split(",") if f)
    unknown = set(fields) - {"absorption", "scattering", "transmission",
                             "ior"}
    if unknown:
        raise SystemExit(f"unknown --fields {sorted(unknown)}; pick from "
                         "absorption/scattering/transmission/ior")

    t0 = time.perf_counter()
    result = diff.fit_materials(
        room.scene, p, target, jax.random.PRNGKey(args.seed),
        n_rays=args.rays if args.fit_rays is None else args.fit_rays, max_bounces=args.bounces,
        sample_rate=cfg.audio.sample_rate, frames=args.fit_frames,
        groups=groups, fields=fields, loss=args.loss,
        steps=args.steps, lr=args.lr,
        soft=args.soft or "ior" in fields)
    dt = time.perf_counter() - t0

    absorption, scattering, transmission, ior = (
        np.asarray(x) for x in result.params.constrained())
    losses = np.asarray(result.losses, np.float64)
    mask = np.asarray(room.scene.mask)
    report = {
        "loss": args.loss, "steps": args.steps,
        "loss_start": float(losses[:5].mean()),
        "loss_end": float(losses[-5:].mean()),
        "fields": list(fields),
        "groups": [],
    }
    for g in range(n_groups):
        walls = np.flatnonzero((groups == g) & mask)
        if walls.size == 0:
            continue  # padding-only group
        report["groups"].append({
            "group": g, "n_walls": int(walls.size),
            "first_wall": int(walls[0]),
            "absorption": [round(float(a), 4) for a in absorption[g]],
            "scattering": round(float(scattering[g]), 4),
            "transmission": round(float(transmission[g]), 4),
            "ior": round(float(ior[g]), 4),
        })
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"fit {len(report['groups'])} material groups in {dt:.1f}s "
          f"({args.steps} steps); loss {report['loss_start']:.4f} -> "
          f"{report['loss_end']:.4f} -> {args.out}")


def cmd_locate(args):
    """Acoustic source localization: recover the source position from a
    target IR by multi-start gradient descent through the differentiable
    ray tracer (`diff.localize_source`). The scene's configured source is
    ignored for fitting and reported only as a comparison when the target
    was simulated in the same scene."""
    import jax

    from . import diff
    from .engine import Engine
    from .utils.checkpoint import load_ir_state

    room = _build_room(args)
    cfg = _config(args)
    listeners, n_l = _listeners(args, room)
    target_state = load_ir_state(args.target)
    target = np.asarray(target_state.normalized())
    if target.shape[0] != n_l:
        raise SystemExit(
            f"target IR has {target.shape[0]} listeners; this setup has "
            f"{n_l} (use --stereo / scene JSON listeners to match)")
    if target.shape[-1] != room.scene.n_bands:
        raise SystemExit(
            f"target IR has {target.shape[-1]} bands; scene has "
            f"{room.scene.n_bands} (set --bands to match)")

    eng = Engine(room.scene, cfg, n_listeners=n_l)
    p = eng.params(room.source, listeners,
                   directivity=_directivity_arr(args, room),
                   mic_directivity=_mic_directivity_arr(args, room))

    bounds = None
    if args.bounds:
        vals = [float(v) for v in args.bounds.split(",")]
        if len(vals) != 4:
            raise SystemExit("--bounds wants xmin,ymin,xmax,ymax")
        bounds = np.asarray([[vals[0], vals[1]], [vals[2], vals[3]]],
                            np.float32)

    t0 = time.perf_counter()
    result = diff.localize_source(
        room.scene, p, target, jax.random.PRNGKey(args.seed),
        n_rays=args.rays if args.fit_rays is None else args.fit_rays,
        max_bounces=args.bounces,
        sample_rate=cfg.audio.sample_rate, n_starts=args.starts,
        steps=args.steps, lr=args.lr, n_sources=args.sources,
        bounds=bounds)
    dt = time.perf_counter() - t0

    pos = np.atleast_2d(np.asarray(result.position))
    best = [[round(float(v), 4) for v in row] for row in pos]
    if args.sources == 1:
        best = best[0]
    report = {
        "position": best,
        "loss": round(float(result.loss), 6),
        "configured_source": [round(float(v), 4)
                              for v in np.asarray(room.source)],
        "starts": [
            {"position": np.round(np.asarray(sp, np.float64), 4).tolist(),
             "loss": round(float(loss), 6)}
            for sp, loss in zip(np.asarray(result.positions),
                                np.asarray(result.losses))],
    }
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    where = (f"({best[0]}, {best[1]})" if args.sources == 1 else
             " + ".join(f"({x}, {y})" for x, y in best))
    print(f"located source at {where} in {dt:.1f}s "
          f"({args.starts} starts x {args.steps} steps, "
          f"loss {report['loss']:.4f}) -> {args.out}")


def cmd_analyze(args):
    """Room-acoustics report (RT60/EDT/C50/C80/D50/centre time/first
    arrival) from an IR — either a saved IRState npz (``--ir-in``) or a
    fresh trace of the configured room. Optionally plots the Schroeder
    decay curve (``--edc-out``)."""
    from . import analysis

    if args.ir_in:
        from .utils.checkpoint import load_ir_state
        state = load_ir_state(args.ir_in)
        sample_rate = args.sample_rate
        src = args.ir_in
        state = _apply_air(state, sample_rate, args.speed_of_sound, args)
    else:
        import jax

        from .engine import Engine
        room = _build_room(args)
        cfg = _config(args)
        listeners, n_l = _listeners(args, room)
        eng = Engine(room.scene, cfg, n_listeners=n_l)
        state = eng.trace_frames(eng.params(room.source, listeners,
                                 directivity=_directivity_arr(args, room),
                   mic_directivity=_mic_directivity_arr(args, room)),
                                 jax.random.PRNGKey(args.seed),
                                 n_frames=args.frames)
        state = _apply_diffraction(state, room.scene,
                                   eng.params(room.source, listeners,
                   directivity=_directivity_arr(args, room),
                   mic_directivity=_mic_directivity_arr(args, room)),
                                   cfg.audio.sample_rate, args)
        state = _apply_air(state, cfg.audio.sample_rate,
                           cfg.sim.speed_of_sound, args)
        sample_rate = cfg.audio.sample_rate
        src = f"traced {args.room} ({args.frames} frames x {args.rays} rays)"

    ir = state.normalized()
    metrics = analysis.analyze_ir(ir, sample_rate,
                                  speed_of_sound=args.speed_of_sound)
    n_listeners, _, n_bands = ir.shape
    report = {"source": src, "sample_rate": sample_rate,
              "ir_length": int(state.ir_length), "listeners": []}
    for li in range(n_listeners):
        bands = []
        for k in range(n_bands):
            bands.append({m: (None if np.isnan(v[li, k]) else
                              round(float(v[li, k]), 6))
                          for m, v in metrics.items()})
        report["listeners"].append({"listener": li, "bands": bands})
    text = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}")
    else:
        print(text)
    b0 = report["listeners"][0]["bands"][0]
    rt = b0["rt60_t20_s"]
    print(f"listener 0 band 0: RT60(T20) "
          f"{'n/a (decay exceeds IR length)' if rt is None else f'{rt:.3f} s'}"
          f", C50 {b0['c50_db']:.1f} dB, D50 {b0['d50']:.3f}, "
          f"direct {b0['direct_time_s'] * 1e3:.2f} ms "
          f"({b0['direct_distance_m']:.2f} m)")
    if args.edc_out:
        from .utils import viz
        img = viz.decay_curve_image(np.asarray(ir)[0])
        viz.save_image(args.edc_out, img)
        print(f"wrote {args.edc_out}")


def cmd_bench(args):
    import bench  # repo-root bench.py
    bench.main()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="realisticaudioraytracing2d_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("trace", help="trace IR + debug images")
    _common(p)
    p.add_argument("--out", default=None, help="IR waveform PNG")
    p.add_argument("--spectro-out", default=None,
                   help="time x frequency spectrogram PNG (banded IR, or "
                        "legacy muffle model for scalar IRs)")
    p.add_argument("--scene-out", default=None, help="scene/ray-path PNG")
    p.add_argument("--ir-out", default=None, help="IR state checkpoint npz")
    p.add_argument("--spatial-out", default=None, metavar="NPZ",
                   help="also trace a spatial (W/X/Y intensity) IR and "
                        "write its channels + per-bin direction-of-"
                        "arrival/diffuseness; prints the arrival table")
    p.add_argument("--ir-in", default=None,
                   help="resume accumulation from an IR checkpoint npz")
    p.add_argument("--gain", type=float, default=None,
                   help="display gain (waveform default 1000; spectrogram "
                        "default auto-scale)")
    p.add_argument("--debug-rays", type=int, default=100)
    _air_args(p)
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("bake", help="offline convolution bake")
    _common(p)
    p.add_argument("--in", dest="infile", default=None,
                   help="dry WAV (default: bundled assets/dry_clip.wav)")
    p.add_argument("--out", required=True)
    p.add_argument("--no-normalize", action="store_true")
    p.add_argument("--legacy", action="store_true",
                   help="use the legacy frequency-binned (muffle) pipeline")
    p.add_argument("--binaural", type=float, default=None,
                   metavar="FACING_DEG",
                   help="stereo bake through a two-ear head model facing "
                        "FACING_DEG: spatial (W/X/Y) trace, then a "
                        "DirAC-style ITD+ILD decode (replaces --stereo/"
                        "--mic-directivity)")
    p.add_argument("--head-radius", type=float, default=0.0875,
                   metavar="M", help="binaural head radius (meters)")
    _air_args(p)  # applied on the modern path (ignored with --legacy)
    p.set_defaults(fn=cmd_bake)

    p = sub.add_parser("stream", help="chunked streaming convolution")
    _common(p)
    p.add_argument("--in", dest="infile", default=None,
                   help="dry WAV (default: bundled assets/dry_clip.wav)")
    p.add_argument("--out", required=True)
    p.add_argument("--move-listener", default=None,
                   help="listener velocity 'vx,vy' (m/s)")
    p.add_argument("--move-source", default=None,
                   help="source velocity 'vx,vy' (m/s) — the IR retraces "
                        "each chunk, so a moving source reverberates "
                        "correctly; add --doppler for the physical "
                        "pitch shift (the reference has neither)")
    dop = p.add_mutually_exclusive_group()
    dop.add_argument("--doppler", action="store_true",
                     help="fractional-rate dry feed: pitch shifts by "
                          "1 - v/c from the poses' radial velocity")
    dop.add_argument("--doppler-per-arrival", action="store_true",
                     help="per-path Doppler: the direct sound and each "
                          "dominant early reflection glide at their OWN "
                          "rates, derived from the traced IRs (composes "
                          "with --binaural and banded scenes)")
    p.add_argument("--pose-feed", default=None, metavar="FILE",
                   help="steer the running stream: JSON-lines overrides "
                        "tailed from FILE ('-' = stdin), per line "
                        "{\"chunk\": i, \"source\": [x,y], "
                        "\"listener\": [x,y], \"facing\": rad} or "
                        "{\"obstacle\": name, \"position\": [x,y], "
                        "\"angle\": rad} (drag a wall mid-stream) or "
                        "{\"command\": \"stop\"|\"reset_ir\"} "
                        "(Space/R keys)")
    p.add_argument("--frames-per-chunk", type=int, default=1)
    p.add_argument("--duration", type=float, default=None,
                   help="stream for this many seconds; the clip loops at "
                        "its end while audio.loop is set "
                        "(RayTraceManager.cs:74-77)")
    p.add_argument("--viz-every", type=int, default=0, metavar="N",
                   help="write the live IR waveform PNG every N chunks "
                        "(<out stem>_ir_NNNN.png)")
    p.add_argument("--binaural", type=float, default=None,
                   metavar="FACING_DEG",
                   help="binaural stereo stream: per-chunk spatial trace "
                        "+ ITD/ILD ear decode, head facing FACING_DEG "
                        "(replaces --stereo/--mic-directivity)")
    p.add_argument("--head-turn", type=float, default=0.0, metavar="DEG_S",
                   help="with --binaural: rotate the head DEG_S deg/s "
                        "(the facing is traced — no recompiles)")
    p.add_argument("--head-radius", type=float, default=0.0875,
                   metavar="M")
    _arrival_args(p)
    _air_args(p)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("live", help="producer/consumer live audio pipeline "
                                    "(audio thread drains the native ring)")
    _common(p)
    p.add_argument("--in", dest="infile", default=None,
                   help="dry WAV (default: bundled assets/dry_clip.wav)")
    p.add_argument("--out", default=None, help="record what the audio "
                                               "thread heard")
    p.add_argument("--duration", type=float, default=2.0)
    p.add_argument("--frames-per-chunk", type=int, default=1)
    p.add_argument("--dsp-buffer", type=int, default=1024,
                   help="audio callback granularity (reference "
                        "m_DSPBufferSize = 1024)")
    p.add_argument("--realtime", action="store_true",
                   help="pace the audio thread on the wall clock "
                        "(underruns counted when the producer lags)")
    p.add_argument("--move-listener", default=None,
                   help="listener velocity 'vx,vy' (m/s)")
    p.add_argument("--move-source", default=None,
                   help="source velocity 'vx,vy' (m/s)")
    dop = p.add_mutually_exclusive_group()
    dop.add_argument("--doppler", action="store_true",
                     help="fractional-rate dry feed: pitch shifts by "
                          "1 - v/c from the poses' radial velocity "
                          "(same physics as stream --doppler)")
    dop.add_argument("--doppler-per-arrival", action="store_true",
                     help="per-path Doppler: direct sound and each "
                          "dominant early reflection glide at their OWN "
                          "rates (same physics as stream "
                          "--doppler-per-arrival)")
    p.add_argument("--pose-feed", default=None, metavar="FILE",
                   help="steer the running live pipeline: JSON-lines "
                        "overrides tailed from FILE ('-' = stdin); "
                        "poses, obstacle moves, and stop/reset_ir "
                        "commands (see stream --pose-feed)")
    p.add_argument("--play", action="store_true",
                   help="play through the OS audio device (ALSA via "
                        "the native sink; implies realtime pacing by "
                        "the device clock). Degrades with a clear "
                        "message when no sound system exists.")
    p.add_argument("--play-device", default="default", metavar="PCM",
                   help="ALSA PCM device name for --play")
    p.add_argument("--viz-every", type=int, default=0, metavar="N",
                   help="write the live IR waveform PNG every N chunks "
                        "(<out stem>_ir_NNNN.png)")
    p.add_argument("--binaural", type=float, default=None,
                   metavar="FACING_DEG",
                   help="binaural live: per-chunk spatial trace + ITD/ILD "
                        "ear decode, head facing FACING_DEG")
    p.add_argument("--head-turn", type=float, default=0.0, metavar="DEG_S",
                   help="with --binaural: rotate the head DEG_S deg/s")
    p.add_argument("--head-radius", type=float, default=0.0875,
                   metavar="M")
    _arrival_args(p)
    _air_args(p)
    p.set_defaults(fn=cmd_live)

    p = sub.add_parser("sweep", help="IR dataset over procedural rooms")
    _common(p)
    p.add_argument("--rooms", type=int, default=64)
    p.add_argument("--out", required=True)
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--metrics-out", default=None,
                   help="also write per-room acoustics metrics "
                        "(RT60/EDT/C50/C80/D50/... as [rooms, L, K] "
                        "arrays) in one vectorized pass")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("fit", help="inverse material estimation: fit "
                       "per-group wall materials to a target IR by "
                       "jax.grad through the trace")
    _common(p)
    p.add_argument("--target", required=True,
                   help="target IRState npz (e.g. from trace --ir-out)")
    p.add_argument("--out", required=True, help="fitted materials JSON")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.08)
    p.add_argument("--loss", default="edc+mse",
                   choices=["mse", "edc", "edc+mse", "blur"])
    p.add_argument("--fields", default="absorption,scattering",
                   help="comma list of material fields to fit; 'ior' "
                        "needs delay gradients and implies --soft "
                        "(transmission has no pathwise gradient)")
    p.add_argument("--soft", action="store_true",
                   help="soft two-bin IR splat forward (delay gradients; "
                        "pair with --loss blur)")
    p.add_argument("--fit-rays", type=int, default=None,
                   help="rays per fitting step (default: --rays)")
    p.add_argument("--fit-frames", type=int, default=1,
                   help="MC frames per fitting step")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("locate", help="acoustic source localization: "
                       "recover the source position from a target IR by "
                       "jax.grad through the trace")
    _common(p)
    p.add_argument("--target", required=True,
                   help="target IRState npz (e.g. from trace --ir-out)")
    p.add_argument("--out", required=True, help="localization report JSON")
    p.add_argument("--starts", type=int, default=8,
                   help="random restarts (batched in one vmap)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.08)
    p.add_argument("--fit-rays", type=int, default=None,
                   help="rays per fitting step (default: --rays)")
    p.add_argument("--sources", type=int, default=1,
                   help="fit N simultaneous sources jointly")
    p.add_argument("--bounds", default=None,
                   help="search box xmin,ymin,xmax,ymax (default: scene "
                        "AABB; pass the room INTERIOR for --sources > 1)")
    p.set_defaults(fn=cmd_locate)

    p = sub.add_parser("analyze", help="room-acoustics metrics (RT60, "
                       "EDT, C50/C80, D50, centre time, first arrival) "
                       "from a traced or saved IR")
    _common(p)
    p.add_argument("--ir-in", default=None,
                   help="IRState npz to analyze (e.g. from trace "
                        "--ir-out; --sample-rate must match it); default: "
                        "trace the configured room")
    p.add_argument("--out", default=None,
                   help="report JSON (default: stdout)")
    p.add_argument("--edc-out", default=None,
                   help="Schroeder decay-curve plot PNG")
    p.add_argument("--speed-of-sound", type=float, default=343.0)
    _air_args(p)
    p.set_defaults(fn=cmd_analyze)

    p = sub.add_parser("bench", help="run the benchmark suite")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
