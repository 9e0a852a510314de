"""``chip_smoke.py`` off the card: it refuses to run without a GPU, its
parity comparators accept and reject the right IRs, its last line carries
exactly the contract's keys, and ``--four-cards`` selects only that
phase."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SR = 8000


def test_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join(REPO,
                                                        "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def _ir():
    rng = np.random.default_rng(0)
    ir = np.zeros(4000)
    ir[500:] = rng.exponential(1.0, 3500) * np.exp(-np.arange(3500) / 600)
    return ir


def _shift_energy_late(ir):
    out = ir.copy()
    moved = 0.1 * out[500:1000]
    out[500:1000] -= moved
    out[3000:3500] += moved
    return out


def _noisy(ir):
    return ir * (1 + 1e-4 * np.random.default_rng(1).normal(size=ir.size))


def _early(ir):
    out = ir.copy()
    out[400] = 0.5
    return out


@pytest.mark.parametrize("make, broken", [
    (lambda ir: ir.copy(), []),
    (_noisy, []),
    (lambda ir: 1.03 * ir, ["energy"]),
    (_early, ["first arrival"]),
    (_shift_energy_late, ["envelope"]),
], ids=["identical", "noise", "energy", "first", "envelope"])
def test_ir_parity_accepts_and_rejects(make, broken):
    ref = _ir()
    fails = cs.parity_failures(cs.ir_parity(make(ref), ref, SR))
    assert len(fails) == len(broken)
    for word, msg in zip(broken, fails):
        assert word in msg


@pytest.mark.parametrize("n_flip, ok", [(20, True), (200, False)])
def test_hit_record_share(n_flip, ok):
    valid = np.zeros((5, 2, 4000, 1), bool)
    valid[:, :, ::2] = True                      # 20,000 valid records
    other = valid.copy()
    other.reshape(-1)[:2 * n_flip:2] = False     # n_flip of them dropped
    share = cs.hit_diff_share(other, valid)
    assert share == pytest.approx(n_flip / 20000)
    m = {"energy_rel": 0.0, "first": 1, "first_ref": 1,
         "envelope_rel": 0.0, "hit_diff": share}
    assert (cs.parity_failures(m) == []) == ok


def test_first_arrival_of_silence():
    assert cs.first_arrival(np.zeros(16)) == -1
    assert cs.first_arrival(np.r_[np.zeros(5), 1.0, 2.0]) == 5


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_has_exactly_the_contract_keys(count):
    obj = json.loads(cs.result_line([_Dev()] * count))
    assert obj == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_four_cards_selects_only_that_phase():
    assert cs.phases(cs.parse_args(["--four-cards"]).four_cards) \
        == ["four_cards"]
    single = cs.phases(cs.parse_args([]).four_cards)
    assert "four_cards" not in single
    assert single[0] == "trace" and "memory" in single
