"""Smoke tests for every examples/*.py (round-3 VERDICT weak #5: the
README/STATUS quote the examples' headline artifacts, but nothing ran
them — quoted claims could rot silently).

Each script self-asserts its own success criterion and exits nonzero on
failure (examples/README.md), so "runs to exit 0 with tiny arguments"
already exercises the claim machinery; cheap stdout claims are pinned
on top. Run in subprocesses (fresh interpreter, CPU forced) so an
example crashing cannot poison the suite. Marked slow: deselect with
``-m 'not slow'`` for quick loops.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.slow

# script -> (tiny args, stdout substrings to assert)
CASES = {
    "demo.py": ([], ["traced 8 frames", "localized",
                     "rt60", "bake"]),
    "dataset_sweep.py": (["--rooms", "4", "--rays", "256", "--cpu"],
                         ["rooms"]),
    "quad_mic.py": (["--grid", "2"], ["first arrival"]),
    "speaker_array.py": (["--elements", "4"], ["contrast"]),
    "spatial_doa.py": (["--rays", "8192", "--frames", "1"],
                       ["bearing"]),
    "occlusion_walkby.py": ([], ["shadow"]),
    "doppler_walkby.py": (["--rays", "1024", "--chunks", "8"],
                          ["direct shifts up, echo shifts down"]),
    "inverse_materials.py": (["--steps", "25", "--rays", "128"],
                             ["fitted"]),
    "locate_source.py": (["--starts", "4", "--steps", "60",
                          "--rays", "128"], ["fitted"]),
    # tracking needs chunk-to-chunk motion within the hypothesis ring:
    # FEWER chunks make it harder (bigger jumps), not cheaper.
    "track_source.py": (["--chunks", "8", "--rays", "128",
                         "--track-steps", "40"], ["tracked 8 chunks"]),
    "obstacle_pose_negative.py": ([], []),
    "live_steering.py": (["--rays", "256"],
                         ["byte-identical", "live steering ok"]),
    "binaural_walkby.py": (["--rays", "1024", "--chunks", "8"],
                           ["direct shifts up, echo shifts down",
                            "lateralized right"]),
}


def run_example(name, args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # write artifacts into the test's tmp dir, not the repo
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", name), *args],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=900)
    return proc


def test_all_examples_are_covered():
    have = {f for f in os.listdir(os.path.join(REPO, "examples"))
            if f.endswith(".py")}
    assert have == set(CASES), \
        "new example script: add a smoke case for it"


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_and_claims_hold(name, tmp_path):
    args, claims = CASES[name]
    proc = run_example(name, args, tmp_path)
    assert proc.returncode == 0, \
        f"{name} exited {proc.returncode}:\n{proc.stdout[-3000:]}"
    low = proc.stdout.lower()
    for claim in claims:
        assert claim.lower() in low, \
            f"{name}: expected {claim!r} in output:\n{proc.stdout[-3000:]}"
