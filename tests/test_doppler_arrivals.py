"""Per-arrival Doppler (streaming.py ``doppler="per_arrival"``): each
dominant early arrival of the chunk IR becomes a fractional-delay tap
whose delay glides chunk to chunk — the direct sound and every early
reflection carry their OWN pitch shift, upgrading the shared direct-path
rate of ``doppler=True`` (the reference has no Doppler at all: its chunk
convolution is time-invariant, ``RayTraceManager.cs:91-123``)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import realisticaudioraytracing2d_tpu as art
from realisticaudioraytracing2d_tpu import streaming as st
from realisticaudioraytracing2d_tpu.engine import Engine
from realisticaudioraytracing2d_tpu.models.scene import SceneBuilder
from realisticaudioraytracing2d_tpu.models.materials import AudioMaterial
from realisticaudioraytracing2d_tpu.streaming import Streamer


# ---- unit: arrival extraction ------------------------------------------------


def _ir(bins, vals, t=512, l=1):
    e = np.zeros((l, t, 1), np.float32)
    for b, v in zip(bins, vals):
        e[:, b, 0] = v
    return jnp.asarray(e)


def test_arrival_table_carries_exact_window():
    # a scatter_hits deposit is a linear two-bin splat: the tap must
    # carry exactly those bins so tap + residual == the full IR
    e = _ir([100, 101], [1.5, 0.5])
    idx, g3, valid = st._arrival_table(e, 512, 4)
    assert bool(valid[0, 0])
    assert int(idx[0, 0]) == 100
    np.testing.assert_allclose(np.asarray(g3[0, 0, :, 0]),
                               [0.0, 1.5, 0.5])
    # remaining slots are invalid (only one local max exists)
    assert not np.any(np.asarray(valid[0, 1:]))


def test_arrival_table_suppresses_overlapping_windows():
    # two local maxima 2 bins apart would share a window bin; the weaker
    # one must be suppressed so tap + residual conserves energy
    e = _ir([100, 102], [3.0, 1.0])
    idx, g3, valid = st._arrival_table(e, 512, 4)
    keep = np.asarray(valid[0])
    assert keep.sum() == 1
    assert int(np.asarray(idx[0])[np.argmax(keep)]) == 100


def test_remove_taps_plus_gain_conserves_energy():
    e = _ir([50, 51, 200, 300, 301, 302], [1.0, 0.5, 2.0, 0.3, 0.9, 0.1])
    idx, g3, valid = st._arrival_table(e, 512, 4)
    res = st._remove_taps(e, idx, valid)
    removed = float(jnp.sum(e) - jnp.sum(res))
    kept_gain = float(jnp.sum(jnp.where(valid, jnp.sum(g3, (-1, -2)),
                                        0.0)))
    np.testing.assert_allclose(removed, kept_gain, rtol=1e-6)


def test_match_arrivals_mutual_nearest_and_fade_in():
    idx_c = jnp.asarray([[100, 240, 0]], jnp.int32)
    val_c = jnp.asarray([[True, True, False]])
    idx_p = jnp.asarray([[103, 400, 0]], jnp.int32)
    g3_p = jnp.asarray([[[0.0, 5.0, 0.0], [1.0, 7.0, 2.0],
                         [0.0, 0.0, 0.0]]])[..., None]    # [L, A, 3, K=1]
    val_p = jnp.asarray([[True, True, False]])
    tau0, g0, matched_prev, j, mutual = st._match_arrivals(
        idx_c, val_c, idx_p, g3_p, val_p, match_bins=64.0)
    # arrival 0 glides from prev (103, its window gains); arrival 1 is
    # new (400 is beyond the 64-bin window): fades in from gain 0 at
    # its own delay
    np.testing.assert_allclose(np.asarray(tau0[0]), [103.0, 240.0, 0.0])
    np.testing.assert_allclose(np.asarray(g0[0, 0, :, 0]), [0.0, 5.0, 0.0])
    np.testing.assert_allclose(np.asarray(g0[0, 1, :, 0]), [0.0, 0.0, 0.0])
    # prev arrival 0 consumed; prev arrival 1 is ~matched_prev, which
    # _per_arrival_parts synthesizes as a fade-out tap (g -> 0)
    assert list(np.asarray(matched_prev[0])) == [True, False, False]
    # the matched-prev gather index points at prev arrival 0
    assert int(j[0, 0]) == 0 and bool(mutual[0, 0])
    assert not bool(mutual[0, 1])


def test_tap_chunk_glide_rate_is_doppler():
    # a tap whose delay shrinks by dtau across the chunk reads
    # 1 + dtau/n dry samples per output sample: a sine comes out
    # pitch-shifted by exactly that ratio
    sr, n, f0 = 8000, 800, 400.0
    early = 200
    wd = n + early + 2
    t_all = np.arange(4 * n) / sr
    dry = jnp.asarray(np.sin(2 * np.pi * f0 * t_all).astype(np.float32))
    window = st.dry_history_window(dry, 2, n, early, loop=False)
    assert window.shape[-1] == wd
    tau0, tau1 = 150.0, 130.0                      # approaching: 20 bins
    g = jnp.asarray([[[0.0, 1.0, 0.0]]])
    y = st._tap_chunk(window,
                      jnp.asarray([[tau0]]), jnp.asarray([[tau1]]),
                      g, g, jnp.asarray([[True]]), n)
    y = np.asarray(y)[0]
    # measure the dominant frequency by zero crossings
    zc = np.sum(np.abs(np.diff(np.signbit(y))))
    f_meas = zc * sr / (2.0 * n)
    f_want = f0 * (1.0 + (tau0 - tau1) / n)
    np.testing.assert_allclose(f_meas, f_want, rtol=0.02)
    assert abs(f_meas - f0) > 5.0                  # the shift is real


def test_arrival_table_edge_bins_not_duplicated():
    # idx=0 / idx=T-1 taps: the out-of-range window neighbors must be
    # masked, not clipped onto the edge bin — otherwise the tap
    # synthesizes more energy than _remove_taps zeroes (review round 4)
    t = 64
    e = np.zeros((1, t, 1), np.float32)
    e[0, 0, 0] = 1.0
    e[0, t - 1, 0] = 0.8
    e = jnp.asarray(e)
    idx, g3, valid = st._arrival_table(e, t, 4)
    res = st._remove_taps(e, idx, valid)
    removed = float(jnp.sum(e) - jnp.sum(res))
    kept = float(jnp.sum(jnp.where(valid, jnp.sum(g3, (-1, -2)), 0.0)))
    np.testing.assert_allclose(removed, kept, rtol=1e-6)
    np.testing.assert_allclose(removed, 1.8, rtol=1e-6)


def test_arrival_table_window_edge_uses_real_neighbor():
    # a peak just PAST the early window must not spawn a rising-edge
    # tap at early_bins-1 (the old zero right-pad made any rising slope
    # a local max at the boundary)
    e = _ir([199, 200], [0.6, 1.0], t=512)   # peak at 200, window is 200
    idx, g3, valid = st._arrival_table(e, 200, 4)
    assert not np.any(np.asarray(valid))


def test_vanished_arrival_fades_out_instead_of_clicking():
    # an arrival valid in prev but absent from cur was removed from the
    # previous chunk's pushed tail, so it MUST be synthesized as a
    # fading tap here — dropping it zeroes the first tau samples of the
    # chunk (an audible click; review round 4)
    n, t, tau, g = 256, 400, 100, 1.0
    prev_ir = _ir([tau], [g], t=t)
    cur_ir = jnp.zeros((1, t, 1), jnp.float32)
    early = 300
    wd = n + early + 2
    dry_window = jnp.asarray(
        np.random.default_rng(0).normal(size=wd).astype(np.float32))
    idx_p, g3_p, val_p = st._arrival_table(prev_ir, early,
                                           st._ARRIVAL_TAPS)
    carry = st.ArrivalCarry(st._remove_taps(prev_ir, idx_p, val_p),
                            idx_p, g3_p, val_p)
    wet, taps, _ = st._per_arrival_parts(dry_window[-n:], dry_window,
                                         carry, cur_ir, False, n, 1)
    s = np.arange(n)
    dw = np.asarray(dry_window)
    dw = np.where(np.abs(dw) > 1e-4, dw, 0.0)   # the conv input gate
    want = (1.0 - s / n) * dw[wd - n + s - tau] * g
    np.testing.assert_allclose(np.asarray(taps)[0], want, atol=1e-5)
    # and the residuals no longer hold the arrival at all
    assert float(jnp.sum(st._remove_taps(prev_ir, *(
        st._arrival_table(prev_ir, early, st._ARRIVAL_TAPS)[0:3:2])))) == 0.0


def test_dry_history_window_loop_prestream_is_silence():
    # loop wraps at the clip END only: history before the stream began
    # is silence, not the not-yet-played clip tail (review round 4)
    n, early = 64, 32
    dry = jnp.asarray(np.arange(1, 129, dtype=np.float32))
    w0 = np.asarray(st.dry_history_window(dry, 0, n, early, loop=True))
    assert (w0[:early + 2] == 0.0).all()          # pre-stream silence
    np.testing.assert_array_equal(w0[early + 2:], np.asarray(dry)[:n])
    # once the stream is past the clip head, the wrap is the clip tail
    w2 = np.asarray(st.dry_history_window(dry, 2, n, early, loop=True))
    np.testing.assert_array_equal(w2[-n:],
                                  np.asarray(dry)[(2 * n) % 128:][:n])


def test_cli_doppler_flags_conflict(tmp_path, capsys):
    # the two Doppler modes are different physics: argparse rejects the
    # combination at parse time (exit 2), before any work happens
    from realisticaudioraytracing2d_tpu.cli import main
    with pytest.raises(SystemExit) as exc:
        main(["stream", "--room", "smoll", "--in", "x.wav",
              "--out", "y.wav", "--doppler", "--doppler-per-arrival"])
    assert exc.value.code == 2
    assert "not allowed with" in capsys.readouterr().err


# ---- integration fixtures ----------------------------------------------------


def _free_field_room(src_x, wall_h=2.0):
    """Listener at origin, source on +x, one reflective wall at x=6
    (absorption 0, specular, opaque): exactly two early arrivals —
    direct (length src_x) and the wall echo (length 12 - src_x). The
    wall is kept SHORT so the echo is compact: NEE deposits spread over
    source->wall-point->listener path lengths, and a long wall smears
    the echo into a stationary-phase plateau whose local maxima are
    Monte-Carlo noise."""
    from realisticaudioraytracing2d_tpu.models.scene import Transform2D
    mirror = AudioMaterial(absorption=0.0, scattering=0.0,
                           transmission=0.0, ior=1.0)
    b = SceneBuilder()
    b.add_box(mirror, Transform2D(position=(6.5, 0.0)),
              size=(1.0, wall_h))
    return b.build(), np.asarray([src_x, 0.0], np.float32), \
        np.asarray([0.0, 0.0], np.float32)


def _cfg(sr=8000, reverb=0.2, rays=512, chunk=0.1, radius=None):
    cfg = art.smoll_room_config(ray_count=rays)
    if radius is not None:
        # compact arrivals: the capture-circle delay spread is +-r/c
        cfg = dataclasses.replace(
            cfg, sim=dataclasses.replace(cfg.sim, listener_radius=radius))
    return dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, sample_rate=sr,
                                       reverb_duration=reverb,
                                       chunk_duration=chunk))


def test_static_scene_per_arrival_matches_plain_stream():
    # with nothing moving the taps carry their exact 3-bin windows, so
    # tap + residual reproduce the plain stream's convolution. The first
    # chunk (prev == cur, taps at identical bins) is exact to FFT-conv
    # noise; later chunks differ only by Monte-Carlo trace noise, which
    # per-arrival reinterprets as sub-bin motion of the weak arrivals —
    # bounded, and shrinking with frames_per_chunk.
    scene, src, lis = _free_field_room(2.0)
    cfg = _cfg()
    eng = Engine(scene, cfg)
    params = eng.params(src, lis)
    sr = cfg.audio.sample_rate
    n = cfg.audio.chunk_samples
    rng = np.random.default_rng(3)
    dry = jnp.asarray(rng.normal(size=int(0.4 * sr)).astype(np.float32)
                      * 0.3)
    fn = lambda i: params                                   # noqa: E731
    plain = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(0),
                                frames_per_chunk=4)
                       .stream_clip(dry, fn, loop=False))
    pa = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(0),
                             frames_per_chunk=4)
                    .stream_clip(dry, fn, loop=False,
                                 doppler="per_arrival"))
    assert pa.shape == plain.shape
    scale = np.abs(plain).max()
    # first chunk: prev == cur -> constant integer taps -> exact
    np.testing.assert_allclose(pa[:, :n], plain[:, :n],
                               atol=1e-4 * scale)
    # whole stream: close in waveform and energy
    num = np.linalg.norm(pa - plain)
    den = np.linalg.norm(plain)
    assert num / den < 0.05
    corr = np.dot(pa.ravel(), plain.ravel()) / (
        np.linalg.norm(pa) * den)
    assert corr > 0.995


def test_moving_source_direct_and_echo_shift_opposite_ways():
    # source approaching the listener while receding from the wall
    # behind it: the direct path shortens at +v (pitch UP) while the
    # echo path lengthens at -v (pitch DOWN). Per-arrival Doppler must
    # put energy at BOTH shifted frequencies; the shared-rate feed
    # (doppler=True) warps everything at the direct rate and has no
    # down-shifted line.
    cfg = _cfg(reverb=0.15, rays=2048, radius=0.05)
    sr = cfg.audio.sample_rate
    n = cfg.audio.chunk_samples
    v = 2.0                                    # m/s toward the listener
    c = 343.0
    f0 = 1000.0
    total = 10
    t_all = np.arange((total + 4) * n) / sr
    dry = jnp.asarray(np.sin(2 * np.pi * f0 * t_all).astype(np.float32))

    scene, _, lis = _free_field_room(3.0)
    eng = Engine(scene, cfg)

    def poses(i):
        x = 3.0 - v * (i * n / sr)             # 3.0 m -> 1.0 m
        return eng.params(np.asarray([x, 0.0], np.float32), lis)

    wet = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(0),
                              frames_per_chunk=4)
                     .stream_clip(dry, poses, loop=False,
                                  total_chunks=total,
                                  doppler="per_arrival"))[0]
    seg = wet[2 * n:total * n]                 # steady middle
    win = np.hanning(seg.size)
    spec = np.abs(np.fft.rfft(seg * win))
    freqs = np.fft.rfftfreq(seg.size, 1.0 / sr)

    def band(f_lo, f_hi):
        m = (freqs >= f_lo) & (freqs <= f_hi)
        return spec[m], freqs[m]

    f_up = f0 * (1.0 + v / c)                  # direct, ~+5.8 Hz
    f_dn = f0 * (1.0 - v / c)                  # echo, ~-5.8 Hz
    up_s, up_f = band(f0 + 1.0, f0 + 15.0)
    dn_s, dn_f = band(f0 - 15.0, f0 - 1.0)
    floor = max(band(f0 - 40, f0 - 25)[0].max(),
                band(f0 + 25, f0 + 40)[0].max())
    # both shifted lines rise well out of the local spectral floor...
    assert up_s.max() > 10.0 * floor
    assert dn_s.max() > 4.0 * floor
    # ...and sit at the predicted Doppler frequencies (the FFT grid is
    # 1.25 Hz here)
    assert abs(up_f[np.argmax(up_s)] - f_up) < 2.2
    assert abs(dn_f[np.argmax(dn_s)] - f_dn) < 2.2


def test_cli_stream_doppler_per_arrival(tmp_path):
    from realisticaudioraytracing2d_tpu.cli import main
    from realisticaudioraytracing2d_tpu.utils.audio_io import (noise_burst,
                                                               read_wav,
                                                               write_wav)
    tiny = ["--rays", "256", "--bounces", "4", "--frames", "1",
            "--reverb", "0.2", "--sample-rate", "8000"]
    dry = str(tmp_path / "dry.wav")
    write_wav(dry, noise_burst(0.2, 8000, seed=3), 8000)
    out = str(tmp_path / "pa.wav")
    main(["stream", "--room", "smoll", *tiny, "--in", dry, "--out", out,
          "--move-source", "1,0", "--doppler-per-arrival",
          "--arrival-taps", "8", "--arrival-window", "0.08",
          "--arrival-match-bins", "48"])
    x, sr = read_wav(out)
    assert np.abs(x).max() > 0 and np.isfinite(x).all()


def test_arrival_taps_knob_tracks_seven_arrivals():
    # VERDICT r4 task 8: a 7-arrival fixture the default budget (6)
    # provably smears — the weakest arrival stays in the residual
    # crossfade (time-invariant => its motion would smear) — is tracked
    # cleanly at taps=8 (zero early residual).
    t = 512
    bins = [50, 80, 110, 140, 170, 200, 230]
    vals = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4]
    ir = _ir(bins, vals, t=t)
    idx, _, valid = st._arrival_table(ir, t, 6)
    res6 = st._remove_taps(ir, idx, valid)
    assert float(jnp.sum(res6)) > 0.0          # default budget smears
    idx8, _, valid8 = st._arrival_table(ir, t, 8)
    res8 = st._remove_taps(ir, idx8, valid8)
    assert float(jnp.sum(res8)) == 0.0         # taps=8 tracks all 7
    assert int(jnp.sum(valid8)) == 7


def test_cli_arrival_flags_in_help(capsys):
    from realisticaudioraytracing2d_tpu.cli import main
    for cmd in ("stream", "live"):
        with pytest.raises(SystemExit):
            main([cmd, "--help"])
        out = capsys.readouterr().out
        assert "--arrival-taps" in out
        assert "--arrival-window" in out
        assert "--arrival-match-bins" in out


def _free_field_room_banded(src_x, k, wall_h=2.0):
    """The two-arrival fixture of :func:`_free_field_room` with a K-band
    scene (mirror wall in every band)."""
    from realisticaudioraytracing2d_tpu.models.scene import Transform2D
    mirror = AudioMaterial(band_absorption=(0.0,) * k, scattering=0.0,
                           transmission=0.0, ior=1.0)
    b = SceneBuilder(n_bands=k)
    b.add_box(mirror, Transform2D(position=(6.5, 0.0)),
              size=(1.0, wall_h))
    return b.build(), np.asarray([src_x, 0.0], np.float32), \
        np.asarray([0.0, 0.0], np.float32)


def test_banded_static_per_arrival_matches_plain_stream():
    # K=8: per-band 3-bin window gains share one delay glide, reading
    # band-split dry (round-4 VERDICT task 2: the K==1 ValueError is
    # gone). Static scene => taps carry exact windows: the stream must
    # match the plain banded stream up to Monte-Carlo trace noise and
    # brickwall band-edge leakage.
    k = 8
    scene, src, lis = _free_field_room_banded(2.0, k)
    cfg = _cfg()
    eng = Engine(scene, cfg)
    params = eng.params(src, lis)
    sr = cfg.audio.sample_rate
    rng = np.random.default_rng(5)
    dry = jnp.asarray(rng.normal(size=int(0.4 * sr)).astype(np.float32)
                      * 0.3)
    fn = lambda i: params                                   # noqa: E731
    plain = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(0),
                                frames_per_chunk=4)
                       .stream_clip(dry, fn, loop=False))
    pa = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(0),
                             frames_per_chunk=4)
                    .stream_clip(dry, fn, loop=False,
                                 doppler="per_arrival"))
    assert pa.shape == plain.shape
    num = np.linalg.norm(pa - plain)
    den = np.linalg.norm(plain)
    assert den > 0 and num / den < 0.06
    corr = np.dot(pa.ravel(), plain.ravel()) / (np.linalg.norm(pa) * den)
    assert corr > 0.995


def test_banded_moving_tap_levels_track_band_gains():
    # a banded tap must carry its per-band gains: with band 0 live and
    # band 1 muted in the IR, the synthesized taps must reproduce band-0
    # content only (per-band gain path through _tap_chunk)
    n, t, k = 256, 400, 2
    sr = 8000.0
    e = np.zeros((1, t, k), np.float32)
    e[0, 100, 0] = 1.0                       # band 0 only
    prev_ir = cur_ir = jnp.asarray(e)
    wd = n + 300 + 2
    tt = np.arange(wd) / sr
    # low tone lives in band 0 ([0, nyq/2)), high tone in band 1
    low = np.sin(2 * np.pi * 500.0 * tt).astype(np.float32)
    high = np.sin(2 * np.pi * 3500.0 * tt).astype(np.float32)
    window = jnp.asarray(low + high)
    early = wd - n - 2
    idx_p, g3_p, val_p = st._arrival_table(prev_ir, early,
                                           st._ARRIVAL_TAPS)
    carry = st.ArrivalCarry(st._remove_taps(prev_ir, idx_p, val_p),
                            idx_p, g3_p, val_p)
    wet, taps, _ = st._per_arrival_parts(window[-n:], window, carry,
                                         cur_ir, False, n, k)
    taps = np.asarray(taps)[0]
    # the tap output is (band-0 filtered window) delayed 100 samples:
    # dominated by the low tone, high tone suppressed by the brickwall
    spec = np.abs(np.fft.rfft(taps * np.hanning(n)))
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    lo_peak = spec[(freqs > 300) & (freqs < 700)].max()
    hi_peak = spec[(freqs > 3300) & (freqs < 3700)].max()
    assert lo_peak > 20.0 * hi_peak


def test_binaural_per_arrival_supported_end_to_end():
    # round-4 VERDICT headline: the two flagship modes compose. A
    # binaural per-arrival stream runs and produces two distinct,
    # finite ear channels; live accepts it too.
    scene, _, lis = _free_field_room(3.0)
    cfg = _cfg(reverb=0.15, rays=512, radius=0.05)
    eng = Engine(scene, cfg)
    sr = cfg.audio.sample_rate
    n = cfg.audio.chunk_samples

    def poses(i):
        x = 3.0 - 2.0 * (i * n / sr)
        return eng.params(np.asarray([x, 0.0], np.float32), lis)

    t_all = np.arange(5 * n) / sr
    dry = jnp.asarray(np.sin(2 * np.pi * 500.0 * t_all)
                      .astype(np.float32))
    srb = Streamer(scene, cfg, jax.random.PRNGKey(0), binaural=True)
    wet = np.asarray(srb.stream_clip(dry, poses, loop=False,
                                     total_chunks=3,
                                     doppler="per_arrival",
                                     facing_fn=lambda i: 0.3))
    assert wet.shape[0] == 2
    assert np.isfinite(wet).all() and np.abs(wet).max() > 0
    assert not np.array_equal(wet[0], wet[1])


def test_binaural_static_per_arrival_matches_plain_binaural():
    # VERDICT r4 task 1(a): with nothing moving, the binaural per-
    # arrival stream must reproduce the plain binaural stream — the ear
    # taps synthesize exactly the removed bins' ITD/ILD deposits (the
    # tap's fractional read IS the decode's two-bin splat through the
    # convolution), the residual rides the same decorrelated decode.
    scene, src, lis = _free_field_room(2.0)
    cfg = _cfg()
    eng = Engine(scene, cfg)
    params = eng.params(src, lis)
    sr = cfg.audio.sample_rate
    n = cfg.audio.chunk_samples
    rng = np.random.default_rng(3)
    dry = jnp.asarray(rng.normal(size=int(0.4 * sr)).astype(np.float32)
                      * 0.3)
    fn = lambda i: params                                   # noqa: E731
    facing = lambda i: 0.4                                  # noqa: E731
    plain = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(0),
                                frames_per_chunk=4, binaural=True)
                       .stream_clip(dry, fn, loop=False,
                                    facing_fn=facing))
    pa = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(0),
                             frames_per_chunk=4, binaural=True)
                    .stream_clip(dry, fn, loop=False,
                                 doppler="per_arrival",
                                 facing_fn=facing))
    assert pa.shape == plain.shape and plain.shape[0] == 2
    scale = np.abs(plain).max()
    # first chunk: prev == cur -> static taps -> exact to conv noise
    np.testing.assert_allclose(pa[:, :n], plain[:, :n],
                               atol=2e-4 * scale)
    num = np.linalg.norm(pa - plain)
    den = np.linalg.norm(plain)
    assert num / den < 0.05
    corr = np.dot(pa.ravel(), plain.ravel()) / (np.linalg.norm(pa) * den)
    assert corr > 0.995


def _band_limited(x, sr, f_lo, f_hi):
    spec = np.fft.rfft(x)
    freqs = np.fft.rfftfreq(x.size, 1.0 / sr)
    spec[(freqs < f_lo) | (freqs > f_hi)] = 0.0
    return np.fft.irfft(spec, x.size)


def test_binaural_moving_source_itd_ild_on_shifted_lines():
    # VERDICT r4 task 1(b): the two-ear version of the opposite-shift
    # test. Source approaching on +x while receding from the wall; head
    # faces +y, so sound arrives from phi = -pi/2: the RIGHT ear hears
    # it earlier (ITD ~ 2 r sin/c) and louder (ILD 1 +- shadow). Both
    # Doppler lines must be present per ear, lateralized right.
    cfg = _cfg(reverb=0.15, rays=2048, radius=0.05)
    sr = cfg.audio.sample_rate
    n = cfg.audio.chunk_samples
    v, c, f0 = 2.0, 343.0, 1000.0
    total = 10
    t_all = np.arange((total + 4) * n) / sr
    dry = jnp.asarray(np.sin(2 * np.pi * f0 * t_all).astype(np.float32))
    scene, _, lis = _free_field_room(3.0)
    eng = Engine(scene, cfg)

    def poses(i):
        x = 3.0 - v * (i * n / sr)
        return eng.params(np.asarray([x, 0.0], np.float32), lis)

    head_radius, shadow = 0.0875, 0.6
    wet = np.asarray(
        Streamer(scene, cfg, jax.random.PRNGKey(0), frames_per_chunk=4,
                 binaural=True, head_radius=head_radius, shadow=shadow)
        .stream_clip(dry, poses, loop=False, total_chunks=total,
                     doppler="per_arrival",
                     facing_fn=lambda i: np.pi / 2))
    seg = wet[:, 2 * n:total * n]
    win = np.hanning(seg.shape[-1])
    f_up = f0 * (1.0 + v / c)
    f_dn = f0 * (1.0 - v / c)
    freqs = np.fft.rfftfreq(seg.shape[-1], 1.0 / sr)
    for ear in (0, 1):
        spec = np.abs(np.fft.rfft(seg[ear] * win))
        floor = max(spec[(freqs >= f0 - 40) & (freqs <= f0 - 25)].max(),
                    spec[(freqs >= f0 + 25) & (freqs <= f0 + 40)].max())
        up = spec[(freqs >= f0 + 1) & (freqs <= f0 + 15)].max()
        dn = spec[(freqs >= f0 - 15) & (freqs <= f0 - 1)].max()
        assert up > 8.0 * floor          # both ears carry both lines
        assert dn > 3.0 * floor
    # ILD: right ear (index 1) louder by ~ (1+shadow)/(1-shadow) = 4
    band = [_band_limited(seg[e], sr, f0 - 20, f0 + 20) for e in (0, 1)]
    rms = [np.sqrt(np.mean(b * b)) for b in band]
    assert 2.0 < rms[1] / rms[0] < 7.0
    # ITD: right ear leads by ~ 2 r / c = 4.08 samples at sin = -1.
    # The line is narrowband (period 8 samples at 1 kHz / 8 kHz), so
    # cross-correlation peaks repeat every period — search one
    # unambiguous cycle around the physical lag only.
    pad = 12
    lags = np.arange(-3, 8)
    xc = [np.dot(band[1][pad:-pad],
                 band[0][pad + k:band[0].size - pad + k])
          for k in lags]
    best = lags[int(np.argmax(xc))]
    want = 2.0 * head_radius / c * sr                    # ~4.08
    # left ear's copy of the signal sits LATER: best lag ~ +want
    assert want - 2.0 <= best <= want + 2.0


def test_live_binaural_per_arrival_matches_stream():
    # VERDICT r4 task 1(c): integrity-mode live == the binaural
    # per-arrival streamer sample for sample (separately compiled
    # programs -> float-noise tolerance).
    from realisticaudioraytracing2d_tpu.live import LivePlayer
    scene, _, lis = _free_field_room(3.0)
    cfg = _cfg(reverb=0.15, rays=512, radius=0.05)
    sr = cfg.audio.sample_rate
    n = cfg.audio.chunk_samples
    total = 4
    eng = Engine(scene, cfg)

    def poses(i):
        x = 3.0 - 2.0 * (i * n / sr)
        return eng.params(np.asarray([x, 0.0], np.float32), lis)

    facing = lambda i: np.pi / 2 + 0.05 * i               # noqa: E731
    t_all = np.arange((total + 2) * n) / sr
    dry = jnp.asarray(np.sin(2 * np.pi * 500.0 * t_all)
                      .astype(np.float32))
    rep = LivePlayer(scene, cfg, jax.random.PRNGKey(1),
                     binaural=True).run(
        dry, total_chunks=total, loop=False, realtime=False,
        params_fn=poses, facing_fn=facing, doppler="per_arrival")
    want = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(1),
                               binaural=True)
                      .stream_clip(dry, poses, loop=False,
                                   total_chunks=total,
                                   doppler="per_arrival",
                                   facing_fn=facing))
    assert rep.audio.shape[0] == 2
    scale = np.abs(want).max()
    np.testing.assert_allclose(rep.audio, want[:, :rep.audio.shape[-1]],
                               atol=1e-5 * scale)


def test_live_per_arrival_matches_stream():
    # integrity-mode live == the per-arrival streamer sample for sample
    # (same tap extraction inside wet_chunk; the paths are separately
    # compiled programs, hence the float-noise tolerance)
    from realisticaudioraytracing2d_tpu.live import LivePlayer
    scene, _, lis = _free_field_room(3.0)
    cfg = _cfg(reverb=0.15, rays=512, radius=0.05)
    sr = cfg.audio.sample_rate
    n = cfg.audio.chunk_samples
    total = 4
    eng = Engine(scene, cfg)

    def poses(i):
        x = 3.0 - 2.0 * (i * n / sr)
        return eng.params(np.asarray([x, 0.0], np.float32), lis)

    t_all = np.arange((total + 2) * n) / sr
    dry = jnp.asarray(np.sin(2 * np.pi * 500.0 * t_all)
                      .astype(np.float32))
    rep = LivePlayer(scene, cfg, jax.random.PRNGKey(1)).run(
        dry, total_chunks=total, loop=False, realtime=False,
        params_fn=poses, doppler="per_arrival")
    want = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(1))
                      .stream_clip(dry, poses, loop=False,
                                   total_chunks=total,
                                   doppler="per_arrival"))
    scale = np.abs(want).max()
    np.testing.assert_allclose(rep.audio, want[:, :rep.audio.shape[-1]],
                               atol=1e-5 * scale)
    # and the per-path shift is real: differs from the plain live run
    plain = LivePlayer(scene, cfg, jax.random.PRNGKey(1)).run(
        dry, total_chunks=total, loop=False, realtime=False,
        params_fn=poses)
    assert not np.allclose(rep.audio, plain.audio)


def _tap_chunk_numpy(dry, tau0, tau1, g0, g1, valid, n):
    """Float64 loop form of ``_tap_chunk`` on its full ``[L, A, 3, K]``
    inputs: every output sample of every valid bin reads band ``k`` of
    the window at ``Wd - n + s - tau(s)`` by two-point interpolation."""
    wd = dry.shape[-1]
    l, a, _, k = tau0.shape
    out = np.zeros((l, n))
    r = np.arange(n) / n
    for li, ai, d, kk in np.ndindex(l, a, 3, k):
        if not valid[li, ai]:
            continue
        tau = tau0[li, ai, d, kk] + (tau1 - tau0)[li, ai, d, kk] * r
        g = g0[li, ai, d, kk] + (g1 - g0)[li, ai, d, kk] * r
        p = (wd - n) + np.arange(n) - tau
        lo = np.floor(p)
        frac = p - lo
        lo_i = np.clip(lo.astype(int), 0, wd - 1)
        hi_i = np.clip(lo_i + 1, 0, wd - 1)
        y = dry[kk, lo_i] * (1 - frac) + dry[kk, hi_i] * frac
        out[li] += g * np.where((p >= 0) & (p <= wd - 1), y, 0.0)
    return out


def _tap_fixture(case):
    rng = np.random.default_rng(3)
    n, early = 480, 600
    wd = n + early + 2
    if case == "scalar_banded":
        # scalar [L, A] delays promoted over K=4 banded dry
        k = 4
        dry = rng.normal(size=(k, wd))
        tau0 = rng.uniform(1, early, (2, 12))
        tau1 = tau0 + rng.uniform(-64, 64, (2, 12))
        g0 = np.abs(rng.normal(size=(2, 12, 3)))
        g1 = np.abs(rng.normal(size=(2, 12, 3)))
        val = rng.uniform(size=(2, 12)) > 0.3
        off = np.arange(-1, 2)[None, None, :, None]
        shape = (2, 12, 3, k)
        full = (np.broadcast_to(tau0[:, :, None, None] + off, shape),
                np.broadcast_to(tau1[:, :, None, None] + off, shape),
                np.broadcast_to(g0[..., None], shape),
                np.broadcast_to(g1[..., None], shape))
    elif case == "binaural":
        # binaural full form [2, A', 3, 1] with per-bin ITD offsets
        dry = rng.normal(size=(1, wd))
        tau0 = np.clip(rng.uniform(0, early, (2, 24, 3, 1))
                       + rng.uniform(-13, 13, (2, 24, 3, 1)), 0, None)
        tau1 = np.clip(tau0 + rng.uniform(-64, 64, (2, 24, 1, 1))
                       + rng.uniform(-25, 25, (2, 24, 3, 1)), 0, wd - 3)
        g0 = np.abs(rng.normal(size=(2, 24, 3, 1)))
        g1 = np.abs(rng.normal(size=(2, 24, 3, 1)))
        val = rng.uniform(size=(2, 24)) > 0.2
        full = (tau0, tau1, g0, g1)
    else:
        # window-edge pins (tau 0 / early / wd-1 / 0.5), zero glide
        dry = rng.normal(size=(1, wd))
        tau0 = np.zeros((1, 4, 3, 1))
        tau0[0, 1], tau0[0, 2], tau0[0, 3] = early, wd - 1.0, 0.5
        tau1 = tau0
        g0 = g1 = np.ones((1, 4, 3, 1))
        val = np.ones((1, 4), bool)
        full = (tau0, tau1, g0, g1)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    args = (f32(dry), f32(tau0), f32(tau1), f32(g0), f32(g1),
            jnp.asarray(val))
    ref_in = [np.asarray(x, np.float32).astype(np.float64) for x in full]
    want = _tap_chunk_numpy(np.asarray(dry, np.float32).astype(np.float64),
                            *ref_in, val, n)
    return args, n, want


@pytest.mark.parametrize("case", ["scalar_banded", "binaural", "edges"])
def test_tap_chunk_matches_numpy_reference(case):
    """The gather tap synthesis equals a float64 loop over bins and
    samples, for both caller shapes (the scalar 2-D promotion over
    banded dry and the binaural full [2, A', 3, K] form with per-bin
    ITD-style offsets) and for taps pinned at the window edges."""
    args, n, want = _tap_fixture(case)
    got = np.asarray(jax.jit(lambda *x: st._tap_chunk(*x, n))(*args))
    assert np.max(np.abs(want)) > 0.1            # non-trivial fixture
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.max(np.abs(want)))


def test_binaural_edge_arrival_stays_residual_not_muted():
    """An arrival within the ITD slack of the early-window end must NOT
    become a tap: the far ear's ITD shift would push its read position
    before the dry-history window and mute the tap's first samples
    every chunk (review r5 finding). The extraction window is shrunk by
    the static ITD pad instead, so the edge arrival stays in the
    residual convolution and the static per-arrival stream still
    reproduces the plain binaural stream. head_radius is exaggerated
    (0.5 m) so the pre-fix muting would be ~10 samples of the DOMINANT
    arrival per chunk — far outside the identity tolerance."""
    scene, src, lis = _free_field_room(2.0)
    cfg = _cfg()
    eng = Engine(scene, cfg)
    params = eng.params(src, lis)
    sr = cfg.audio.sample_rate
    rng = np.random.default_rng(5)
    dry = jnp.asarray(rng.normal(size=int(0.3 * sr)).astype(np.float32)
                      * 0.3)
    fn = lambda i: params                                   # noqa: E731
    facing = lambda i: 0.3                                  # noqa: E731
    # direct arrival ~bin 47; window 48 bins puts it 1-2 bins from the
    # end, far inside the 0.5 m head's ITD reach (~12 bins at 8 kHz)
    kw = dict(frames_per_chunk=4, binaural=True, head_radius=0.5,
              arrival_window_s=48.0 / sr)
    plain = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(0), **kw)
                       .stream_clip(dry, fn, loop=False,
                                    facing_fn=facing))
    pa = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(0), **kw)
                    .stream_clip(dry, fn, loop=False,
                                 doppler="per_arrival",
                                 facing_fn=facing))
    scale = np.abs(plain).max()
    np.testing.assert_allclose(pa, plain, atol=2e-3 * scale)
    # and the tap machinery is still live in this mode: a window wide
    # enough to keep the arrival clear of the pad behaves identically
    kw2 = dict(kw, arrival_window_s=0.12)
    pa2 = np.asarray(Streamer(scene, cfg, jax.random.PRNGKey(0), **kw2)
                     .stream_clip(dry, fn, loop=False,
                                  doppler="per_arrival",
                                  facing_fn=facing))
    assert np.isfinite(pa2).all() and np.abs(pa2).max() > 0
