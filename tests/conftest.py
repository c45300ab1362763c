"""Test harness: force an 8-virtual-device CPU backend before JAX import.

The tier-1 tests need no accelerator; sharding tests run on a virtual
8-device CPU mesh (SURVEY.md §4's 'CPU-backend JAX tests' implication).
Tests marked ``gpu`` take the ``gpu`` fixture, which skips them unless JAX
runs on a GPU; run them on a GPU machine with

    DESMAN_TEST_GPU=1 python -m pytest -m gpu tests/
"""
import os

if not os.environ.get("DESMAN_TEST_GPU"):
    # overwrite, not setdefault: an ambient JAX_PLATFORMS must not leak in
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
# hermetic tests: never read/write the persistent XLA executable cache (a
# stale cross-session entry once SEGFAULTED deserialization mid-suite; CLI
# tests would otherwise switch it on via _enable_compilation_cache)
os.environ["DESMAN_TPU_NO_CACHE"] = "1"

import jax

if not os.environ.get("DESMAN_TEST_GPU"):
    # a plugin registered at interpreter start would make the env var alone
    # too late — force the platform through jax.config as well
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from desman_tpu import synth


@pytest.fixture(scope="session")
def small_synth():
    """Tiny but informative dataset: 3 strains, decent coverage."""
    return synth.generate(V=120, S=12, G=3, coverage=60.0, seed=1)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, so
    every worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform!r} here "
                    "(set DESMAN_TEST_GPU=1 on a GPU machine)")
    return dev
