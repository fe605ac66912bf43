"""Native (C++) sparse-prep runtime: device-layout conversion off the compute path.

Role parity with the reference's native layer (`src/primate/include/*.h`,
meson-built): all *compute* lives in XLA, so the native code's
job is the **data loader** — turning huge host CSR matrices into device-ready
tiled BSR / banded DIA layouts in one pass, without scipy's intermediate
copies. Compiled lazily with the system toolchain (g++ -O3) into a cached
shared library and bound via ctypes; every entry point has a scipy/numpy
fallback, so the package works without a compiler.
"""

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "csr_analyze", "csr_to_bsr_arrays", "csr_to_dia_arrays"]

_HERE = Path(__file__).parent
_SRC = _HERE / "sparse_prep.cpp"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _host_tag() -> str:
	"""Short per-host CPU fingerprint for the compiled-cache filename: the
	library is built with -march=native, so a .so cached on one host can
	SIGILL another host sharing the filesystem (NFS homes, multi-host pods) —
	an uncatchable failure the ctypes fallback net cannot intercept."""
	import hashlib
	import platform

	tag = platform.machine()
	try:
		with open("/proc/cpuinfo") as fh:
			for line in fh:
				if line.startswith(("flags", "Features")):
					tag += hashlib.sha1(line.encode()).hexdigest()[:8]
					break
	except OSError:
		pass
	return tag


def _build() -> Optional[ctypes.CDLL]:
	so = _HERE / f"_sparse_prep.{_host_tag()}.so"
	try:
		if not so.exists() or so.stat().st_mtime < _SRC.stat().st_mtime:
			# Compile to a unique temp file and atomically rename: a killed or
			# concurrent g++ must never leave a half-written .so at the final
			# path (other processes would load garbage instead of falling back).
			tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
			cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)]
			try:
				subprocess.run(cmd, check=True, capture_output=True, timeout=120)
				os.replace(tmp, so)
			except BaseException:
				tmp.unlink(missing_ok=True)  # no stale .tmp.so per failed process
				raise
		lib = ctypes.CDLL(str(so))
		lib.bsr_count.restype = ctypes.c_int64
		lib.bsr_count.argtypes = [ctypes.c_int64] * 4 + [_i64p, _i32p, _i64p]
		for suf, fp in (("f32", _f32p), ("f64", _f64p)):
			fn = getattr(lib, f"bsr_fill_{suf}")
			fn.restype = None
			fn.argtypes = [ctypes.c_int64] * 4 + [_i64p, _i32p, fp, _i64p, fp, _i32p, _i64p]
			fn = getattr(lib, f"dia_fill_{suf}")
			fn.restype = None
			fn.argtypes = [ctypes.c_int64] * 2 + [_i64p, _i32p, fp, ctypes.c_int64, _i64p, fp]
		lib.dia_count.restype = ctypes.c_int64
		lib.dia_count.argtypes = [ctypes.c_int64] * 2 + [_i64p, _i32p, _i64p]
		lib.csr_analyze.restype = None
		lib.csr_analyze.argtypes = [ctypes.c_int64] * 2 + [_i64p, _i32p] + [ctypes.c_int64] * 2 + [_i64p]
		return lib
	except (OSError, AttributeError, subprocess.SubprocessError):
		# Corrupt/incompatible cached .so, missing symbol, no toolchain, ... —
		# every caller has a scipy/numpy fallback, so never raise from here.
		return None


def _lib() -> Optional[ctypes.CDLL]:
	global _LIB, _TRIED
	if not _TRIED:
		_TRIED = True
		_LIB = _build()
	return _LIB


def available() -> bool:
	"""True when the native library compiled (or was cached) successfully."""
	return _lib() is not None


def _as_csr_parts(A) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]]:
	import scipy.sparse as sps

	A = sps.csr_matrix(A)
	A.sum_duplicates()
	# Column ids cross the ABI as int32 (indptr is int64, so nnz may exceed
	# 2^31 — but the column COUNT may not). Guard instead of wrapping.
	if A.shape[1] >= 2**31:
		raise OverflowError("native sparse-prep supports < 2^31 columns; use the scipy engine for wider matrices")
	data = np.ascontiguousarray(A.data)
	if data.dtype.kind == "c":
		# The C ABI is real-only; casting would DISCARD the imaginary part.
		# Returning None routes callers to the (complex-correct) scipy path.
		return None
	if data.dtype not in (np.float32, np.float64):
		data = data.astype(np.float64)
	return (
		data,
		np.ascontiguousarray(A.indices, np.int32),
		np.ascontiguousarray(A.indptr, np.int64),
		A.shape,
	)


def csr_analyze(A, bm: int = 8, bn: int = 8):
	"""One-pass structural stats for format selection (`operators.prepare`).

	Returns ``{"n_diags", "bandwidth", "n_tiles", "max_row_nnz"}`` — the
	distinct-diagonal count, max |i−j|, occupied (bm × bn) tile count, and the
	longest row — or None when the native library is unavailable (callers use
	the numpy fallback). Touches only the index structure; values are never
	read or copied.
	"""
	lib = _lib()
	if lib is None or A.shape[1] >= 2**31:
		return None
	import scipy.sparse as sps

	A = sps.csr_matrix(A)
	A.sum_duplicates()
	indices = np.ascontiguousarray(A.indices, np.int32)
	indptr = np.ascontiguousarray(A.indptr, np.int64)
	out = np.zeros(4, np.int64)
	lib.csr_analyze(A.shape[0], A.shape[1], indptr, indices, bm, bn, out)
	return {"n_diags": int(out[0]), "bandwidth": int(out[1]), "n_tiles": int(out[2]), "max_row_nnz": int(out[3])}


def csr_to_bsr_arrays(A, bm: int, bn: int):
	"""CSR/scipy-sparse → (blocks (nnzb,bm,bn), colids, indptr_b) on the padded grid.

	Single-pass native conversion with empty-row coverage blocks; None when
	the native library is unavailable (callers fall back to scipy tobsr).
	"""
	lib = _lib()
	if lib is None or A.shape[1] >= 2**31:
		return None
	parts = _as_csr_parts(A)
	if parts is None:  # complex data: the real-only ABI would drop imag(A)
		return None
	data, indices, indptr, (n, m) = parts
	n_brow = -(-n // bm)
	counts = np.zeros(n_brow, np.int64)
	nnzb = lib.bsr_count(n, m, bm, bn, indptr, indices, counts)
	blocks = np.zeros((nnzb, bm, bn), data.dtype)
	colids = np.zeros(nnzb, np.int32)
	indptr_b = np.zeros(n_brow + 1, np.int64)
	fill = lib.bsr_fill_f32 if data.dtype == np.float32 else lib.bsr_fill_f64
	fill(n, m, bm, bn, indptr, indices, data, counts, blocks, colids, indptr_b)
	return blocks, colids, indptr_b


def csr_to_dia_arrays(A):
	"""CSR/scipy-sparse → (offsets tuple, row-aligned bands (n_d, n)); None w/o native."""
	lib = _lib()
	if lib is None or A.shape[1] >= 2**31:
		return None
	parts = _as_csr_parts(A)
	if parts is None:  # complex data: the real-only ABI would drop imag(A)
		return None
	data, indices, indptr, (n, m) = parts
	offsets_buf = np.zeros(n + m - 1, np.int64)
	n_d = lib.dia_count(n, m, indptr, indices, offsets_buf)
	offsets = np.ascontiguousarray(offsets_buf[:n_d])
	bands = np.zeros((n_d, n), data.dtype)
	fill = lib.dia_fill_f32 if data.dtype == np.float32 else lib.dia_fill_f64
	fill(n, m, indptr, indices, data, n_d, offsets, bands)
	return tuple(int(o) for o in offsets), bands
