"""How the port's test modules compile the JAX reference they compare with.

The port's tests spend most of their time compiling the reference's
programs, many of them again in another module or another xdist worker
(``tests/conftest.py`` drops every compiled program at each module
boundary).  Each port test module that runs the reference imports
:func:`cheap_reference_compiles`, a module-scoped autouse fixture that,
for that module only:

* turns on JAX's persistent compilation cache in a directory shared by the
  run's workers (every program, however quick to compile): a program
  compiled once in the run is loaded, not compiled, by every later module;
  JAX writes no entry for a program with host callbacks;
* compiles with ``jax_disable_most_optimizations`` (XLA's backend
  optimization level 0, LLVM's expensive passes off): the reference's
  programs here run on arrays of a few thousand elements, where compiling
  costs far more than running, and the level enters the cache key.

Both settings are put back after the module, so the JAX package's own tests
run as they always did.  Neither changes what is compared: integer outputs
are the same at any optimization level, and every float comparison keeps
its stated tolerance.
"""
import os

import jax
import pytest
from jax.experimental.compilation_cache import compilation_cache

SETTINGS = {
    "jax_compilation_cache_dir": None,  # set per run
    "jax_persistent_cache_min_compile_time_secs": 0.0,
    "jax_persistent_cache_min_entry_size_bytes": 0,
    "jax_disable_most_optimizations": True,
}


def _cache_dir(tmp_path_factory) -> str:
    """One directory per test run, shared by its xdist workers."""
    base = tmp_path_factory.getbasetemp()
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = base.parent / f"jax-reference-{run}" if run else base / "jax-reference"
    root.mkdir(parents=True, exist_ok=True)
    return str(root)


@pytest.fixture(autouse=True, scope="module")
def cheap_reference_compiles(tmp_path_factory):
    settings = dict(SETTINGS, jax_compilation_cache_dir=_cache_dir(tmp_path_factory))
    before = {name: jax.config.values[name] for name in settings}
    for name, value in settings.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for name, value in before.items():
            jax.config.update(name, value)
        compilation_cache.reset_cache()
