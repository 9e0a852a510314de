"""Multi-device tests on the 8-virtual-CPU-device mesh (conftest sets
xla_force_host_platform_device_count=8): sharded sweeps, ray-axis psum,
multi-source mixdown."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import realisticaudioraytracing2d_tpu as art
from realisticaudioraytracing2d_tpu.models.rooms import (random_rooms,
                                                         smoll_room)
from realisticaudioraytracing2d_tpu.ops import ir as irm
from realisticaudioraytracing2d_tpu.ops.trace import (TraceParams,
                                                      trace_hits_only)
from realisticaudioraytracing2d_tpu.parallel.mesh import make_mesh
from realisticaudioraytracing2d_tpu.parallel.multisource import (
    trace_sources_mixdown, trace_sources_mixdown_sharded)
from realisticaudioraytracing2d_tpu.parallel.rays import trace_rays_sharded
from realisticaudioraytracing2d_tpu.parallel.sweep import (
    sweep_rooms, sweep_rooms_sharded)

# 2048 bins @ 8 kHz = 0.256 s — enough to hold SmollRoom's first arrivals
# (direct path alone is ~0.063 s).
IR_LEN = 2048
SR = 8000


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_multisource_mixdown_equals_sum_of_singles():
    room = smoll_room()
    sources = jnp.asarray([[-18.0, 9.0], [-10.0, 5.0]])
    params = TraceParams.make(sources, room.listener, 0.5, 343.0, 1.0)
    key = jax.random.PRNGKey(0)
    mixed = trace_sources_mixdown(room.scene, params, key, n_rays=256,
                                  max_bounces=2, sample_rate=SR,
                                  ir_length=IR_LEN)
    # manual: per-source with the same split keys
    keys = jax.random.split(key, 2)
    total = jnp.zeros_like(mixed)
    for i in range(2):
        p = params._replace(source=sources[i])
        hits = trace_hits_only(room.scene, p, keys[i], n_rays=256,
                               max_bounces=2)
        total = total + irm.scatter_hits(hits, SR, IR_LEN)
    np.testing.assert_allclose(np.asarray(mixed), np.asarray(total),
                               rtol=1e-5, atol=1e-7)
    assert float(mixed.sum()) > 0


def test_multisource_sharded_matches_single_device():
    room = smoll_room()
    mesh = make_mesh((1, 8), ("rooms", "rays"))
    sources = np.tile(np.asarray(room.source), (8, 1)).astype(np.float32)
    sources[:, 0] += np.linspace(-2, 2, 8)
    params = TraceParams.make(sources, room.listener, 0.5, 343.0, 1.0)
    key = jax.random.PRNGKey(1)
    sharded = trace_sources_mixdown_sharded(
        room.scene, params, key, mesh, n_rays=128, max_bounces=2,
        sample_rate=SR, ir_length=IR_LEN)
    # oracle: same grouping (8 shards of 1 source, shard i uses
    # fold_in(key, i) -> split(.., 1)[0])
    keys = jax.random.split(key, 8)
    total = jnp.zeros_like(sharded)
    for i in range(8):
        total = total + trace_sources_mixdown(
            room.scene, params._replace(source=sources[i:i + 1]), keys[i],
            n_rays=128, max_bounces=2, sample_rate=SR, ir_length=IR_LEN)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(total),
                               rtol=1e-4, atol=1e-7)


def test_sweep_rooms_vmap_shapes():
    scenes, sources, listeners = random_rooms(4, seed=3, n_obstacles=1)
    irs = sweep_rooms(scenes, sources, listeners, jax.random.PRNGKey(0),
                      n_rays=128, max_bounces=2, sample_rate=SR,
                      ir_length=IR_LEN, n_frames=2)
    assert irs.shape == (4, 1, IR_LEN, 1)
    sums = np.asarray(irs).sum(axis=(1, 2, 3))
    assert (sums > 0).sum() >= 3  # almost all rooms produce energy


def test_sweep_sharded_matches_unsharded():
    scenes, sources, listeners = random_rooms(8, seed=4, n_obstacles=1)
    key = jax.random.PRNGKey(2)
    kw = dict(n_rays=128, max_bounces=2, sample_rate=SR, ir_length=IR_LEN,
              n_frames=1)
    plain = sweep_rooms(scenes, sources, listeners, key, **kw)
    mesh = make_mesh((8,), ("rooms",))
    sharded = sweep_rooms_sharded(scenes, sources, listeners, key, mesh,
                                  **kw)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(plain),
                               rtol=1e-4, atol=1e-7)


def test_trace_rays_sharded_runs_and_is_deterministic():
    room = smoll_room()
    params = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    mesh = make_mesh((1, 8), ("rooms", "rays"))
    # 4+ bounces: SmollRoom's source sits behind the transmissive slant
    # wall, so the first capture-eligible bounce is #2 (depth gating).
    kw = dict(n_rays=1024, max_bounces=4, sample_rate=SR, ir_length=IR_LEN)
    a = trace_rays_sharded(room.scene, params, jax.random.PRNGKey(5), mesh,
                           **kw)
    b = trace_rays_sharded(room.scene, params, jax.random.PRNGKey(5), mesh,
                           **kw)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(a.sum()) > 0


def test_frames_sharded_matches_unsharded_scan():
    # DP over MC frames: device d runs frames [d*local, (d+1)*local) with
    # the SAME frame_key stream the unsharded scan uses, so sharded and
    # unsharded accumulation agree (float reassociation only).
    from realisticaudioraytracing2d_tpu.engine import trace_accumulate
    from realisticaudioraytracing2d_tpu.parallel.frames import (
        accumulate_frames_sharded)

    room = smoll_room()
    params = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0)
    mesh = make_mesh((8,), ("rooms",))
    st0 = irm.IRState.zeros(IR_LEN, 1, 1)
    kw = dict(n_rays=256, max_bounces=4, sample_rate=SR)
    key = jax.random.PRNGKey(11)
    sh = accumulate_frames_sharded(room.scene, params, st0, key, mesh,
                                   n_frames=8, **kw)
    un = trace_accumulate(room.scene, params, st0, key, n_frames=8, **kw)
    assert int(sh.frames) == 8
    assert float(un.sum.sum()) > 0
    np.testing.assert_allclose(np.asarray(sh.sum), np.asarray(un.sum),
                               rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError):
        accumulate_frames_sharded(room.scene, params, st0, key, mesh,
                                  n_frames=9, **kw)


def test_convolve_seq_sharded_matches_fft():
    # SP over audio time: chunked overlap-add across devices == full FFT
    # convolution (length, eps gate and accumCount normalization intact).
    from realisticaudioraytracing2d_tpu.ops import convolve as cv
    from realisticaudioraytracing2d_tpu.parallel.seq import (
        convolve_seq_sharded)

    mesh = make_mesh((8,), ("rays",))
    rng = np.random.default_rng(3)
    x = rng.normal(size=4096).astype(np.float32)
    x[::17] = 0.0  # exercise the |x|<=eps input gate across chunk seams
    ir = (rng.normal(size=777) * np.exp(-np.arange(777) / 150)) \
        .astype(np.float32)
    a = np.asarray(convolve_seq_sharded(jnp.asarray(x), jnp.asarray(ir),
                                        mesh, 5))
    b = np.asarray(cv.convolve_fft(jnp.asarray(x), jnp.asarray(ir), 5))
    assert a.shape == (4096 + 777,)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        convolve_seq_sharded(jnp.asarray(x[:4090]), jnp.asarray(ir), mesh)


def test_graft_entry_single_chip():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert int(out.frames) == 1


def test_graft_dryrun_multichip():
    # Backend-already-initialized-as-CPU case (this pytest process): the
    # config.update route raises internally, the hard device check passes,
    # and the dry run proceeds inline.
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_graft_dryrun_routes_to_subprocess(monkeypatch):
    # Backend initialized on the WRONG platform / too few devices (the
    # driver's round-1 failure): must re-exec into a clean subprocess, not
    # run on whatever backend is live.
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    calls = []
    monkeypatch.setattr(ge, "_cpu_backend_ready", lambda n: False)
    monkeypatch.setattr(ge, "_dryrun_subprocess",
                        lambda n: calls.append(n))
    monkeypatch.delenv(ge._CHILD_ENV_FLAG, raising=False)
    ge.dryrun_multichip(8)
    assert calls == [8]


def test_graft_dryrun_child_never_respawns(monkeypatch):
    # A clean child that STILL can't get the CPU backend must raise, not
    # fork another child.
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    monkeypatch.setattr(ge, "_cpu_backend_ready", lambda n: False)
    monkeypatch.setenv(ge._CHILD_ENV_FLAG, "1")
    with pytest.raises(RuntimeError, match="subprocess still"):
        ge.dryrun_multichip(8)


def test_graft_dryrun_subprocess_real():
    # One real end-to-end re-exec: env-forced CPU backend in a fresh
    # interpreter (the path a process that opened an accelerator takes).
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    ge._dryrun_subprocess(2)


def test_64_sources_stereo_mixdown():
    # BASELINE config #4: 64 simultaneous sources sharing one scene,
    # batched trace + mixdown to a stereo listener.
    room = smoll_room()
    rng_np = np.random.default_rng(11)
    sources = np.stack([rng_np.uniform(-15, 15, 64),
                        rng_np.uniform(-3, 8, 64)], -1).astype(np.float32)
    ears = np.stack([[-0.2, -3.68], [0.2, -3.68]]).astype(np.float32)
    params = TraceParams.make(sources, ears, 0.5, 343.0, 1.0)
    ir = trace_sources_mixdown(room.scene, params, jax.random.PRNGKey(0),
                               n_rays=128, max_bounces=4, sample_rate=SR,
                               ir_length=IR_LEN)
    assert ir.shape == (2, IR_LEN, 1)
    assert float(ir.sum()) > 0
    assert not np.allclose(np.asarray(ir[0]), np.asarray(ir[1]))


def test_multisource_sharded_per_source_gains():
    # regression: per-source input_gain must shard with the sources
    room = smoll_room()
    mesh = make_mesh((1, 8), ("rooms", "rays"))
    sources = np.tile(np.asarray(room.source), (8, 1)).astype(np.float32)
    sources[:, 0] += np.linspace(-2, 2, 8)
    gains = np.linspace(0.5, 4.0, 8).astype(np.float32)
    params = TraceParams.make(sources, room.listener, 0.5, 343.0, gains)
    ir = trace_sources_mixdown_sharded(
        room.scene, params, jax.random.PRNGKey(1), mesh, n_rays=128,
        max_bounces=4, sample_rate=SR, ir_length=IR_LEN)
    assert float(ir.sum()) > 0
    # oracle: unsharded with the same per-shard key grouping
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    total = jnp.zeros_like(ir)
    for i in range(8):
        total = total + trace_sources_mixdown(
            room.scene,
            params._replace(source=sources[i:i + 1], input_gain=gains[i:i + 1]),
            keys[i], n_rays=128, max_bounces=4, sample_rate=SR,
            ir_length=IR_LEN)
    np.testing.assert_allclose(np.asarray(ir), np.asarray(total),
                               rtol=1e-4, atol=1e-7)


def test_rays_sharded_with_directive_params():
    # The extended TraceParams (directivity/mic patterns) must flow
    # through shard_map unchanged: sharded == sum of the per-device
    # partial scatters, and the pattern actually bites (differs from
    # omni).
    from realisticaudioraytracing2d_tpu.ops import directivity as dv
    from realisticaudioraytracing2d_tpu.ops import ir as irm
    from realisticaudioraytracing2d_tpu.ops.trace import trace_hits_only

    room = smoll_room()
    params = TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0,
                              directivity=dv.cardioid(1.0),
                              mic_directivity=dv.cardioid(2.0))
    mesh = make_mesh((1, 8), ("rooms", "rays"))
    kw = dict(n_rays=1024, max_bounces=4, sample_rate=SR, ir_length=IR_LEN)
    sharded = np.asarray(trace_rays_sharded(
        room.scene, params, jax.random.PRNGKey(5), mesh, **kw))

    expect = np.zeros_like(sharded)
    for d in range(8):
        k = jax.random.fold_in(jax.random.PRNGKey(5), d)
        hits = trace_hits_only(room.scene, params, k, n_rays=128,
                               max_bounces=4)
        expect += np.asarray(irm.scatter_hits(hits, SR, IR_LEN))
    np.testing.assert_allclose(sharded, expect, rtol=1e-5, atol=1e-12)

    omni = np.asarray(trace_rays_sharded(
        room.scene,
        TraceParams.make(room.source, room.listener, 0.5, 343.0, 1.0),
        jax.random.PRNGKey(5), mesh, **kw))
    assert not np.allclose(sharded, omni)
