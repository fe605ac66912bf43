"""Small dense linear-algebra updates used by the exchangeable estimators.

Parity: reference ``src/primate/linalg.py`` (`update_trinv`, the incremental
upper-triangular inverse behind XTrace's leave-one-out identities).

Accelerator restructuring: the reference appends **one column at a time** via
`scipy.qr_insert` + a rank-one triangular-inverse update (`trace.py:298-301`) —
inherently host-serial. Here the same math is done **block-wise**: a batch of
``b`` new columns is orthogonalized against the current basis with two passes of
classical Gram-Schmidt (CGS2 — two GEMMs, GEMM-shaped, and more stable than a
single MGS sweep), then QR'd locally; the triangular inverse updates by a
block-triangular identity. Both are pure jnp and jit per (m, b) shape.
"""

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

__all__ = ["update_trinv", "update_trinv_block", "qr_append", "colwise_dot", "tall_qr"]


def _hiprec(fn):
	"""Trace the wrapped function under full matmul precision: the QR-append /
	triangular-inverse identities are EXACT algebra — a reduced-precision
	default (bf16 passes, or TF32 on the GPU) breaks xtrace's m = n exactness."""

	@functools.wraps(fn)
	def wrapped(*a, **k):
		with jax.default_matmul_precision("highest"):
			return fn(*a, **k)

	return wrapped


@_hiprec
def _shifted_cholqr3(Y: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
	"""Shifted CholeskyQR3 (Fukaya et al. 2018): thin QR of a TALL block via
	three m×m Choleskys + triangular solves — all GEMM-shaped, no Householder
	panel recursion.

	Replaces XLA's Householder QR of tall blocks (e.g. (262144, 192) f32) at
	the same orthogonality error; its speed on the GPU is not measured yet.
	The first Cholesky is shifted by ``s = 11(nm + m(m+1))·ε·‖G‖``
	so it cannot break down (valid for κ(Y) up to ~1/ε); the two plain
	CholeskyQR passes that follow restore orthogonality to O(ε).
	"""
	n, m = Y.shape
	eps = jnp.finfo(jnp.real(Y).dtype).eps
	G = jnp.conj(Y).T @ Y
	# ‖G‖₂ ≤ ‖G‖_F; the shift only needs an upper bound.
	s = 11.0 * (n * m + m * (m + 1)) * eps * jnp.linalg.norm(G)
	R = jnp.linalg.cholesky(G + s * jnp.eye(m, dtype=G.dtype)).conj().T  # upper
	Q = solve_triangular(R.conj().T, jnp.conj(Y).T, lower=True).conj().T
	for _ in range(2):
		G2 = jnp.conj(Q).T @ Q
		R2 = jnp.linalg.cholesky(G2).conj().T
		Q = solve_triangular(R2.conj().T, jnp.conj(Q).T, lower=True).conj().T
		R = R2 @ R
	# RANK-DEFICIENT blocks (rank(Y) < m — e.g. the sketch of an exactly
	# low-rank operator, or Lanczos/xtrace at breakdown): the unshifted
	# refinement Choleskys produce NaN. Householder QR handles them (any
	# orthonormal completion is valid for the estimator algebra), so detect
	# and fall back at runtime — the common full-rank path never takes it.
	ok = jnp.all(jnp.isfinite(R)) & jnp.all(jnp.isfinite(Q))
	return jax.lax.cond(
		ok,
		lambda: (Q, R),
		lambda: tuple(jnp.linalg.qr(Y, mode="reduced")),
	)


def tall_qr(Y: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
	"""Thin QR, dispatched by aspect ratio: shifted CholeskyQR3 for tall
	blocks (n ≥ 8m — the estimator-sketch regime, where Householder QR's
	panel recursion is the slow shape), ``jnp.linalg.qr`` otherwise."""
	n, m = Y.shape
	if m == 0 or n < 8 * m:
		return jnp.linalg.qr(Y, mode="reduced")
	return _shifted_cholqr3(Y)


@_hiprec
def update_trinv(B_inv: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
	"""Append one column to an upper-triangular inverse.

	Given ``B⁻¹`` for upper-triangular ``B (n x n)`` and a new column ``b`` of
	length ``n+1``, returns the inverse of ``[[B, b[:n]], [0, b[n]]]``.
	"""
	B_inv = jnp.asarray(B_inv)
	b = jnp.asarray(b).reshape(-1)
	n = B_inv.shape[0]
	assert B_inv.shape == (n, n) and b.shape[0] == n + 1, "B must be n x n and `b` must have length `n + 1`"
	out = jnp.zeros((n + 1, n + 1), dtype=jnp.result_type(B_inv, b))
	inv_corner = jnp.reciprocal(b[-1])
	out = out.at[:n, :n].set(B_inv)
	out = out.at[n, n].set(inv_corner)
	out = out.at[:n, n].set(-inv_corner * (B_inv @ b[:n]))
	return out


@_hiprec
def update_trinv_block(R_inv: jnp.ndarray, B: jnp.ndarray, C: jnp.ndarray) -> jnp.ndarray:
	"""Append a block of columns to an upper-triangular inverse.

	For the block upper-triangular ``[[R, B], [0, C]]`` with known ``R⁻¹`` and
	upper-triangular ``C (b x b)``, the inverse is
	``[[R⁻¹, -R⁻¹ B C⁻¹], [0, C⁻¹]]``. One triangular solve + one GEMM.
	"""
	m = R_inv.shape[0]
	b = C.shape[0]
	C_inv = solve_triangular(C, jnp.eye(b, dtype=C.dtype), lower=False)
	out = jnp.zeros((m + b, m + b), dtype=jnp.result_type(R_inv, C))
	out = out.at[:m, :m].set(R_inv)
	out = out.at[m:, m:].set(C_inv)
	if m > 0:
		out = out.at[:m, m:].set(-(R_inv @ B) @ C_inv)
	return out


@_hiprec
def qr_append(
	Q: Optional[jnp.ndarray], R: Optional[jnp.ndarray], Y: jnp.ndarray, reorth_passes: int = 2
) -> Tuple[jnp.ndarray, jnp.ndarray]:
	"""Append columns ``Y (n x b)`` to a thin QR factorization ``Q R``.

	Block Gram-Schmidt: project ``Y`` off ``span(Q)`` (``reorth_passes`` CGS
	sweeps, each two GEMMs), QR the remainder, and assemble the bordered ``R``.
	Equivalent to ``b`` successive `qr_insert` calls, but runs as a handful of
	batched matmuls instead of a serial column loop.
	"""
	Y = jnp.asarray(Y)
	if Q is None or Q.shape[1] == 0:
		Qn, Rn = tall_qr(Y)
		return Qn, Rn
	m = Q.shape[1]
	B = jnp.zeros((m, Y.shape[1]), dtype=Y.dtype)
	Z = Y
	for _ in range(max(1, reorth_passes)):
		proj = jnp.conj(Q).T @ Z  # Q†Z (conj is an identity for real Q)
		Z = Z - Q @ proj
		B = B + proj
	Q2, C = tall_qr(Z)
	Q_new = jnp.concatenate([Q, Q2], axis=1)
	R_new = jnp.zeros((m + Y.shape[1], m + Y.shape[1]), dtype=Y.dtype)
	R_new = R_new.at[:m, :m].set(R)
	R_new = R_new.at[:m, m:].set(B)
	R_new = R_new.at[m:, m:].set(C)
	return Q_new, R_new


def colwise_dot(X: jnp.ndarray, Y: jnp.ndarray) -> jnp.ndarray:
	"""Columnwise dots ``diag(X†Y)`` as an ``(k, 1)`` column (shared by the
	XTrace/XDiag leave-one-out identity blocks; conj is a no-op for real X)."""
	return jnp.einsum("ij,ij->j", jnp.conj(X), Y)[:, None]
