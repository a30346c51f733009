"""jaybenne_tpu — Implicit Monte Carlo thermal photon transport in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of lanl/jaybenne (IMC after Fleck &
Cummings 1971, with hybrid Discrete Diffusion Monte Carlo in optically thick cells, on
block-structured optionally statically-refined Cartesian meshes). See SURVEY.md at the
repository root for the reference analysis and the design mapping.
"""

import os as _os

import jax as _jax

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=_os.environ):
    """Where the persistent XLA compilation cache lives: the directory named by
    ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself), else a
    fixed ``.jax_cache`` at the repository root — a fixed path, because the
    path is part of the cache key."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _REPO_ROOT, ".jax_cache"
    )


# Each distinct configuration compiles once; caching the executables on disk
# lets every rerun of the same configuration start in seconds.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

from . import config, driver, io, mesh, particles, state, step  # noqa: F401,E402
from .config import from_deck, from_file  # noqa: F401,E402

__version__ = "0.1.0"
