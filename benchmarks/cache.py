"""Persistent XLA compile cache for the entry scripts.

Every entry script (``chip_smoke.py``, ``bench.py``, the ``benchmarks/``
mains) calls :func:`enable_compile_cache` once, before its first compile. The
library package itself never sets a cache.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set here.
* Otherwise the cache lives at ``<repo>/.jax_cache``. The path is fixed (it is
  part of the cache key) and listed in ``.gitignore``.
"""

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
	"""Point JAX's persistent compile cache at its directory; return that path."""
	env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
	if env:
		return env
	import jax

	DEFAULT_DIR.mkdir(exist_ok=True)
	jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
	return str(DEFAULT_DIR)
