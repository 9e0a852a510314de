"""Test harness configuration.

Runs the whole suite on the JAX CPU backend with 8 virtual devices so
multi-chip sharding paths are exercised without hardware — the strategy
SURVEY.md section 4 prescribes (the reference has no tests at all; this
suite is this framework's own).

The overrides go through ``jax.config`` before first use, so they hold
even when jax was imported earlier in the process. The persistent compile
cache that the entry points enable (``utils/compile_cache.py``) stays off
here: test programs are small and the workers would share one directory.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses we spawn

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _release_xla_executables():
    """Keep the full single-process suite under the kernel's mmap cap.

    Every retained XLA-CPU executable (module-level jitted functions keep
    theirs alive in jax's jit cache) holds ~30 mmap'd JIT code/data
    regions. A ~360-test run accumulates tens of thousands of mappings
    and dies at ``vm.max_map_count`` (65530 by default): LLVM's memory
    mapper doesn't check the failing mmap and the process segfaults
    inside ``backend_compile_and_load`` — the round-3 "full suite
    segfaults ~200-300 compilations in" failure. Dropping the caches at
    each module boundary bounds the live mapping count to one module's
    worth (~2-3k). Evidence + standalone repro: docs/TESTGATE.md.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
