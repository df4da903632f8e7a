"""Where JAX keeps its persistent compile cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here. Otherwise the cache goes to ``.jax_cache/`` at the checkout root: a
fixed path, because the path is part of the cache key, so the next process
finds what this one compiled. :mod:`pyorc_tpu.ops` imports this module before
the first computation.
"""

import os
from pathlib import Path

import jax

CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
