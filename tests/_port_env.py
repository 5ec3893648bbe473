"""The environment of the port's CPU test modules: one XLA compile per
program, one torch thread per worker.

The port's CPU tests hold it to ``repro``'s functions run eagerly or op by
op (``jax.disable_jit``), where every primitive is an XLA program of its
own: one tinyllama serving reference is ~900 of them, and their compiles,
not their runs, take most of its time. Without a shared cache each
worker process of a run compiles them again, and again in each module
(``conftest.py`` clears JAX's in-process caches between modules).
``shared_compile_cache`` turns on JAX's persistent compilation cache,
keyed by the compiled program, in a directory that every worker of the
run shares: each program is compiled once a run and loaded where it is
needed again. The programs and their
results are unchanged.

The port's side runs tiny torch ops on the CPU. With the default of one
intra-op thread per core in each of the run's worker processes, the
workers' threads outnumber the cores several times over and spend the
time waiting on each other. ``one_torch_thread`` runs a module's torch ops
on one thread, as a one-core machine would. A module whose results depend
on the thread count does not take it: ``tests/test_torch_core.py``'s BOP
sums of the full model equal repro's bit for bit at the default thread
count, and not on one thread.

Both fixtures are module-scoped and undo their setting at the module's
end, so the JAX package's own tests run as before.
"""

from __future__ import annotations

import os

import pytest
import torch

# every compile is cached, however short. An entry is written in place: a
# worker that reads one still being written fails to decompress it, and
# JAX then warns and compiles the program itself
_OPTIONS = {"jax_persistent_cache_min_compile_time_secs": 0.0,
            "jax_persistent_cache_min_entry_size_bytes": 0}


@pytest.fixture(autouse=True, scope="module")
def shared_compile_cache(tmp_path_factory):
    import jax
    from jax.experimental.compilation_cache import compilation_cache

    # xdist's workers each have a base temp dir under the run's shared one
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    saved = {name: getattr(jax.config, name)
             for name in (*_OPTIONS, "jax_compilation_cache_dir")}
    for name, value in _OPTIONS.items():
        jax.config.update(name, value)
    compilation_cache.set_cache_dir(str(root / "jax-compile-cache"))
    compilation_cache.reset_cache()
    yield
    for name, value in saved.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
