"""Symmetric tridiagonal eigensolvers — batched, on-device.

Parity: reference ``src/primate/tridiag.py`` (dispatch) and the Pythran
``src/primate/tqli.py`` (implicit-shift QL fallback).

Accelerator design: JAX has no eigenvector-producing `eigh_tridiagonal`, and the
Jacobi matrices produced by Lanczos are tiny (deg ≲ 100) but arrive **in
batches of nv probes** — so the default path densifies each (deg × deg)
tridiagonal and calls `jnp.linalg.eigh`, which batches over leading axes and
runs entirely on-device (the reference calls LAPACK MRRR per probe on the
host, `tridiag.py:9-20`). A jittable implicit-shift QL (`tqli`) is provided as
the method-parity alternative; "auto" uses eigh (which, unlike LAPACK MRRR,
has no failure mode requiring a fallback ladder).
"""

from functools import partial
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["eigh_tridiag", "eigvalsh_tridiag", "sign", "tqli", "tridiag_matrix"]


def sign(a, b):
	"""Transfer-of-sign: ``|a|`` carrying the sign of ``b`` (Fortran ``SIGN``),
	elementwise and jittable.

	Parity: reference ``src/primate/tqli.py:5-7`` exposes this helper for its
	QL sweeps. Its expression ``(int(b > 1) - int(a < 0) + 1)`` misbehaves for
	``b ∈ (0, 1]`` (the comparison should be ``b > 0``; SURVEY §7 flags it);
	this implements the intended semantics, treating ``b == 0`` as positive.
	"""
	return jnp.where(jnp.asarray(b) >= 0, jnp.abs(a), -jnp.abs(a))


def _normalize_offdiag(d: jnp.ndarray, e: jnp.ndarray) -> jnp.ndarray:
	"""Return the length ``deg-1`` off-diagonal, accepting the reference's
	leading-zero convention (e of length deg with e[0] ≈ 0)."""
	if e.shape[-1] == d.shape[-1]:
		return e[..., 1:]
	assert e.shape[-1] == d.shape[-1] - 1, "Invalid diagonal/subdiagonal pair"
	return e


def tridiag_matrix(d: jnp.ndarray, e: jnp.ndarray) -> jnp.ndarray:
	"""Densify diagonal(s) ``d (..., deg)`` / off-diagonal(s) ``e`` into
	``(..., deg, deg)`` symmetric tridiagonal matrices."""
	d = jnp.asarray(d)
	e = _normalize_offdiag(d, jnp.asarray(e))

	def build(di, ei):
		return jnp.diag(di) + jnp.diag(ei, 1) + jnp.diag(ei, -1)

	for _ in range(d.ndim - 1):
		build = jax.vmap(build)
	return build(d, e)


def eigh_tridiag(d: jnp.ndarray, e: jnp.ndarray, method: str = "auto", maxiter: int = 30) -> Tuple[jnp.ndarray, jnp.ndarray]:
	"""Eigenpairs ``(rw, Y)`` of symmetric tridiagonal matrices ``T(d, e)``.

	Batched: ``d (..., deg)``, ``e (..., deg-1)`` (or with a leading zero) give
	``rw (..., deg)`` and ``Y (..., deg, deg)``. Jittable.
	"""
	assert method in {"auto", "eigh", "mrrr", "tqli"}
	if method == "tqli":
		return tqli(d, e, eigenvectors=True, maxiter=maxiter)
	T = tridiag_matrix(d, e)
	rw, Y = jnp.linalg.eigh(T)
	return rw, Y


def eigvalsh_tridiag(d: jnp.ndarray, e: jnp.ndarray, method: str = "auto", maxiter: int = 30) -> jnp.ndarray:
	"""Eigenvalues of symmetric tridiagonal matrices ``T(d, e)`` (batched, jittable)."""
	assert method in {"auto", "eigh", "mrrr", "tqli"}
	if method == "tqli":
		return tqli(d, e, eigenvectors=False, maxiter=maxiter)
	return jnp.linalg.eigvalsh(tridiag_matrix(d, e))


@partial(jax.jit, static_argnames=("eigenvectors", "maxiter"))
def _tqli_single(d: jnp.ndarray, e: jnp.ndarray, eigenvectors: bool, maxiter: int):
	"""Implicit-shift QL with Givens rotations for one tridiagonal matrix.

	O(1) extra space per rotation; useful when only Ritz values are needed and
	the dense densify+eigh path is memory-bound. Expressed as nested
	`lax.while_loop`s (outer: eigenvalue index; inner: QL sweeps) with a
	`lax.fori_loop` of masked plane rotations — fully jittable and vmappable.
	"""
	n = d.shape[0]
	acc = jnp.promote_types(d.dtype, jnp.float32)
	d = d.astype(acc)
	# Internal convention: e[i] couples (i, i+1); pad to length n with 0.
	e = jnp.concatenate([e.astype(acc), jnp.zeros(1, acc)])
	Z = jnp.eye(n, dtype=acc) if eigenvectors else jnp.zeros((0, 0), acc)

	def find_split(l, d, e):
		"""Smallest m >= l with negligible e[m] (split point of the active block)."""
		idx = jnp.arange(n)
		dd = jnp.abs(d) + jnp.abs(jnp.roll(d, -1))
		negligible = (jnp.abs(e) + dd) == dd
		cand = jnp.where((idx >= l) & (negligible | (idx == n - 1)), idx, n - 1)
		return jnp.min(cand)

	def sweep(l, m, d, e, Z):
		"""One implicit-shift QL sweep on the block [l, m]."""
		g = (d[l + 1] - d[l]) / (2.0 * e[l])
		r = jnp.hypot(g, jnp.asarray(1.0, acc))
		sgn = jnp.where(g >= 0, r, -r)
		g = d[m] - d[l] + e[l] / (g + sgn)

		def rot(k, state):
			d, e, Z, g, s, c, p, alive = state
			i = m - 1 - k  # iterate i = m-1 .. l
			active = alive & (i >= l)
			f, b = s * e[i], c * e[i]
			r = jnp.hypot(f, g)
			underflow = (r == 0.0) & (i < m - 1)
			# On underflow e[i+1] takes r == 0 (reference sets it before the
			# break), splitting the block so the next sweep converges.
			e = e.at[i + 1].set(jnp.where(active, r, e[i + 1]))
			safe_r = jnp.where(r == 0, 1.0, r)
			s_n, c_n = f / safe_r, g / safe_r
			g_n = d[i + 1] - p
			r2 = (d[i] - g_n) * s_n + 2.0 * c_n * b
			p_n = s_n * r2
			d = d.at[i + 1].set(jnp.where(active & ~underflow, g_n + p_n, jnp.where(active & underflow, d[i + 1] - p, d[i + 1])))
			g_out = c_n * r2 - b
			if Z.shape[0] > 0:
				col_i, col_i1 = Z[:, i], Z[:, i + 1]
				new_i1 = s_n * col_i + c_n * col_i1
				new_i = c_n * col_i - s_n * col_i1
				upd = active & ~underflow
				Z = Z.at[:, i + 1].set(jnp.where(upd, new_i1, col_i1))
				Z = Z.at[:, i].set(jnp.where(upd, new_i, col_i))
			alive = active & ~underflow
			s = jnp.where(alive, s_n, s)
			c = jnp.where(alive, c_n, c)
			p = jnp.where(alive, p_n, p)
			g = jnp.where(alive, g_out, g)
			return (d, e, Z, g, s, c, p, alive)

		one = jnp.asarray(1.0, acc)
		d, e, Z, g, s, c, p, alive = lax.fori_loop(
			0, m - l, rot, (d, e, Z, g, one, one, jnp.asarray(0.0, acc), jnp.asarray(True))
		)
		d = d.at[l].set(jnp.where(alive, d[l] - p, d[l]))
		e = e.at[l].set(jnp.where(alive, g, e[l]))
		# e[m] zeroes on BOTH exits: normal completion and the underflow
		# break (the reference sets e[m]=0 in each case).
		e = e.at[m].set(0.0)
		return d, e, Z

	def outer(l, state):
		d, e, Z = state

		def inner_cond(st):
			d, e, Z, it = st
			return (find_split(l, d, e) != l) & (it < maxiter) & (e[l] != 0.0)

		def inner_body(st):
			d, e, Z, it = st
			m = find_split(l, d, e)
			d, e, Z = sweep(l, m, d, e, Z)
			return (d, e, Z, it + 1)

		d, e, Z, _ = lax.while_loop(inner_cond, inner_body, (d, e, Z, jnp.asarray(0)))
		return (d, e, Z)

	d, e, Z = lax.fori_loop(0, n - 1, outer, (d, e, Z))
	# Convergence certificate: every interior off-diagonal negligible relative
	# to its neighbors (the split criterion). False = some block exhausted
	# maxiter sweeps — the reference RAISES "Too many iterations" there.
	dd = jnp.abs(d) + jnp.abs(jnp.roll(d, -1))
	ok = jnp.all(((jnp.abs(e) + dd) == dd)[: n - 1])
	return ((d, Z) if eigenvectors else d), ok


def tqli(
	d: jnp.ndarray,
	e: jnp.ndarray,
	eigenvectors: Union[bool, np.ndarray, None] = False,
	maxiter: int = 30,
	max_iter: Optional[int] = None,
	Z: Optional[np.ndarray] = None,
) -> Union[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray]]:
	"""Tridiagonal QL-implicit eigensolver (batched over leading axes).

	Returns eigenvalues (unsorted, as the shifts leave them) or ``(rw, Z)``.
	Parity: reference Pythran `tqli.py:15-90` (the reference's `sign()` helper
	computes ``int(b > 1) - int(a < 0) + 1`` — a transcription quirk of
	FORTRAN's SIGN; this implementation uses the intended magnitude-of-a,
	sign-of-b semantics).

	Drop-in: the reference signature ``tqli(d, e, Z, max_iter)`` passes a
	preallocated ``Z`` array as the third argument (size 0 = eigenvalues only,
	`tqli.py:28`, `tridiag.py:13`) and mutates ``d``/``Z`` in place. An ndarray
	third argument selects that convention here: eigenvalues are written back
	into a numpy ``d`` and eigenvectors into a non-empty numpy ``Z``.
	"""
	if max_iter is not None:
		maxiter = int(max_iter)
	if Z is not None:  # keyword form of the reference's output-array argument
		eigenvectors = Z
	d_in, Z_out = d, None
	if isinstance(eigenvectors, (bool, np.bool_)) or eigenvectors is None:
		want_vecs = bool(eigenvectors)
	else:  # reference convention: third positional is the Z output array
		Z_ref = eigenvectors
		want_vecs = int(np.prod(np.shape(Z_ref))) > 0
		Z_out = Z_ref if (want_vecs and isinstance(Z_ref, np.ndarray)) else None
	d, e = jnp.asarray(d), jnp.asarray(e)
	e = _normalize_offdiag(d, e)
	fn = partial(_tqli_single, eigenvectors=want_vecs, maxiter=maxiter)
	for _ in range(d.ndim - 1):
		fn = jax.vmap(fn)
	out, ok = fn(d, e)
	if not bool(jnp.all(ok)):
		# The reference raises "Too many iterations"; here tqli is also the
		# LAPACK-failure FALLBACK (`eigh_tridiag`), so a hard raise would break
		# the robustness ladder — warn loudly instead of silently returning
		# partially-converged eigenvalues.
		import warnings

		warnings.warn(
			f"tqli: not all off-diagonals became negligible within maxiter={maxiter} "
			"QL sweeps; returned eigenvalues may be partially converged (raise maxiter).",
			stacklevel=2,
		)
	if Z_out is not None or (not isinstance(eigenvectors, (bool, np.bool_)) and eigenvectors is not None):
		rw = out[0] if want_vecs else out
		if isinstance(d_in, np.ndarray) and d_in.shape == rw.shape:
			d_in[...] = np.asarray(rw)
		if Z_out is not None and Z_out.shape == out[1].shape:
			Z_out[...] = np.asarray(out[1])
	return out
