"""Build & drive the REAL reference package (scikit-primate) for the baseline.

Round-2 verdict asked for a head-to-head against the *compiled* reference
rather than a numpy stand-in. The stock build chain is unavailable here (no
meson-python/pythran/pip-installable pybind11, `extern/eigen` is an empty
submodule, no network) — but the toolchain gap is only HEADERS, and both
ship inside common wheels:

  * Eigen   — TensorFlow wheels vendor the full Eigen tree under
              `tensorflow/include/Eigen` (found in the uv wheel cache).
  * pybind11 — torch wheels vendor a complete pybind11 (incl. `eigen.h`)
              under `torch/include/pybind11`.

So `_lanczos.cpp` (the reference's ONLY required native module) compiles with
plain g++ against those, and the package imports: `tqli.py`/`fttr.py` are
valid numpy Python before Pythran transpilation, and the meson step adds
nothing else. The reference sources are read from ``PRIMATE_REF_SRC`` (none
is copied into the repo); the build lands in the git-ignored
``benchmarks/.ref_build`` and is reused across runs.

`real_slq_logdet` then runs the reference's own
``hutch(MatrixFunction(A, "log"), ...)`` — its genuine C++ Lanczos recurrence
over Eigen sparse matvecs — for bench.py's honest ``vs_baseline`` denominator.
"""

import glob
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import Optional

# The reference's Python package sources (``src/primate`` of a scikit-primate
# checkout); unset means no real-reference baseline.
REF_SRC = Path(os.environ["PRIMATE_REF_SRC"]) if os.environ.get("PRIMATE_REF_SRC") else None
CACHE = Path(os.environ.get("PRIMATE_REF_BUILD", Path(__file__).resolve().parent / ".ref_build"))

_BUILT: Optional[bool] = None


def _find_eigen() -> Optional[Path]:
	for pat in (
		"/usr/include/eigen3/Eigen",
		os.path.expanduser("~/.cache/uv/archive-v0/*/tensorflow/include/Eigen"),
		"/opt/venv/lib/python3*/site-packages/tensorflow/include/Eigen",
	):
		hits = glob.glob(pat)
		if hits:
			return Path(hits[0]).parent
	return None


def _find_pybind11() -> Optional[Path]:
	for pat in (
		"/opt/venv/lib/python3*/site-packages/torch/include/pybind11/eigen.h",
		"/usr/include/pybind11/eigen.h",
	):
		hits = glob.glob(pat)
		if hits:
			return Path(hits[0]).parent.parent
	try:
		import pybind11

		return Path(pybind11.get_include())
	except ImportError:
		return None


def build() -> bool:
	"""Compile `_lanczos` and assemble an importable copy of the reference.

	Idempotent; returns True when `primate` is importable from CACHE.
	"""
	global _BUILT
	if _BUILT is not None:
		return _BUILT
	_BUILT = False
	try:
		pkg = CACHE / "primate"
		ext = f"_lanczos{sysconfig.get_config_var('EXT_SUFFIX')}"
		if not (pkg / ext).exists():
			eigen, pb11 = _find_eigen(), _find_pybind11()
			if not (REF_SRC is not None and REF_SRC.exists() and eigen and pb11):
				return False
			CACHE.mkdir(parents=True, exist_ok=True)
			so_tmp = CACHE / f"{ext}.{os.getpid()}.tmp"
			subprocess.run(
				[
					"g++", "-O3", "-march=native", "-std=c++20", "-shared", "-fPIC",
					"-fvisibility=hidden",
					f"-I{eigen}", f"-I{pb11}",
					f"-I{sysconfig.get_paths()['include']}",
					f"-I{REF_SRC / 'include'}",
					str(REF_SRC / "_lanczos.cpp"), "-o", str(so_tmp),
				],
				check=True,
				capture_output=True,
				timeout=600,
			)
			if pkg.exists():
				shutil.rmtree(pkg)
			shutil.copytree(REF_SRC, pkg, ignore=shutil.ignore_patterns("meson.build", "*.cpp", "include"))
			os.replace(so_tmp, pkg / ext)
			# importlib.metadata lookup in primate/__init__ needs a dist-info.
			di = CACHE / "scikit_primate-0.5.6.dist-info"
			di.mkdir(exist_ok=True)
			(di / "METADATA").write_text("Metadata-Version: 2.1\nName: scikit-primate\nVersion: 0.5.6\n")
		if str(CACHE) not in sys.path:
			sys.path.insert(0, str(CACHE))
		import primate  # noqa: F401
		import primate.trace  # noqa: F401

		_BUILT = True
	except Exception:
		_BUILT = False
	return _BUILT


def real_slq_logdet(A, deg: int, orth: int, probes: int, seed: int = 42) -> tuple:
	"""Config-2 SLQ logdet with the genuine reference package.

	Returns ``(estimate, wall_seconds)`` — the wall covers the reference's full
	estimator path: pybind11 ``_lanczos.lanczos`` per probe column inside
	``MatrixFunction.quad`` + LAPACK quadrature + the host convergence loop.
	"""
	assert build(), "real reference unavailable"
	import numpy as np
	from primate.operators import MatrixFunction
	from primate.trace import hutch

	Acsc = A.tocsc()  # the sparse pybind11 overload binds Eigen CSC
	M = MatrixFunction(Acsc, fun="log", deg=deg, orth=orth, dtype=np.float32)
	t0 = time.perf_counter()
	est = hutch(M, batch=probes, converge="count", count=probes, seed=np.random.default_rng(seed))
	return float(est), time.perf_counter() - t0
