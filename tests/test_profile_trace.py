"""The trace reduction of ``scripts/profile_trace.py``: busy time is the
union of device intervals, and a recorded trace reduces to a window, a
busy share in [0, 1] and per-name device time."""

import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import profile_trace as pt  # noqa: E402


@pytest.mark.parametrize("intervals, busy", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),            # overlap counted once
    ([(0, 10), (2, 4)], 10),             # nested
    ([(20, 30), (0, 10)], 20),           # unsorted, disjoint
])
def test_union_of_device_intervals(intervals, busy):
    assert pt._union_ns(intervals) == busy


def test_reduce_recorded_trace(tmp_path):
    out = str(tmp_path / "trace")
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    jax.profiler.start_trace(out)
    with jax.profiler.TraceAnnotation(pt.WINDOW):
        f(x).block_until_ready()
    jax.profiler.stop_trace()
    path = [os.path.join(d, n) for d, _, ns in os.walk(out) for n in ns
            if n.endswith(".xplane.pb")][0]
    r = pt.reduce_trace(path, top=3)
    assert r["window_ms"] > 0
    assert 0.0 <= r["busy_share"] <= 1.0
    assert r["idle_share"] == pytest.approx(1.0 - r["busy_share"])
    assert len(r["top"]) <= 3
