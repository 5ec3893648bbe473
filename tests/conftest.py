"""Shared pytest configuration.

One tier-1 process compiles thousands of distinct XLA programs — every
``ServingEngine``/train-engine instance jits its own closures over its
own weights. On CPU jaxlib the retained compiler/executable state from
hundreds of engines can crash ``backend_compile`` late in a long run;
dropping JAX's in-process caches between test modules bounds that state
without changing any individual test (each module recompiles what it
actually uses).
"""

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (repro_torch kernels); skipped "
        "without one")
