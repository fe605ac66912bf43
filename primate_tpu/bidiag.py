"""Golub-Kahan-Lanczos block bidiagonalization as a batched `lax.scan`.

Beyond-reference capability: the reference handles rectangular data only
through its Gram-mode sparse operator (``AᵀA`` matvecs,
`src/primate/include/eigen_operators.h:58,69-75`) and then runs symmetric
Lanczos on the product. GKL builds the same Krylov information — an upper
bidiagonal ``B`` with ``A V = U B`` — **without ever applying the squared
operator**: each step is one ``A`` apply and one ``Aᵀ`` apply, and the
(squared) singular values only appear in the tiny ``deg×deg`` Jacobi matrix
``BᵀB`` formed at the end. That keeps the recurrence's conditioning at
``κ(A)`` instead of ``κ(A)²`` — the standard stability argument for
Lanczos-bidiagonalization quadrature on Gram spectra (Golub & Meurant,
"Matrices, Moments and Quadrature").

Accelerator-first: all nv probes advance together, state is carried PROBE-MAJOR
(``(nv, n)`` / ``(nv, m)`` blocks, contiguous operator axis on vector lanes)
and the operator applies through ``matmat_t`` / ``rmatmat_t`` — the same
layout discipline as `lanczos._lanczos_core`.
"""

from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["lanczos_bidiag", "bidiag_jacobi", "BidiagOutput"]


class BidiagOutput(NamedTuple):
	"""Batched GKL results: probe axis last.

	alphas: (deg, nv) diagonal of the upper-bidiagonal B (α_1..α_deg ≥ 0).
	betas:  (deg-1, nv) superdiagonal (β_1..β_{deg-1} ≥ 0).
	U:      (deg, m, nv) left Lanczos vectors (``return_basis=True`` only).
	V:      (deg, n, nv) right Lanczos vectors (``return_basis=True`` only).
	residual: (nv,) the NEXT superdiagonal β_deg (``return_residual=True``
	        only; one extra adjoint apply) — the coupling a Gauss-Radau
	        extension of the BᵀB Jacobi matrix needs (its β_end = α_deg·β_deg).
	"""

	alphas: jnp.ndarray
	betas: jnp.ndarray
	U: Optional[jnp.ndarray] = None
	V: Optional[jnp.ndarray] = None
	residual: Optional[jnp.ndarray] = None


def bidiag_jacobi(alphas: jnp.ndarray, betas: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
	"""Jacobi matrix ``J = BᵀB`` of the GKL bidiagonal → tridiagonal ``(d, e)``.

	``d_j = α_j² + β_{j-1}²`` (β_0 = 0), ``e_j = α_j β_j``. Feeding (d, e) to
	:func:`~primate_tpu.integrate.spectral_quad_form` gives the Gauss rule for
	``v₁ᵀ f(AᵀA) v₁`` — identical (in exact arithmetic) to symmetric Lanczos on
	the Gram operator, but computed from un-squared recurrence coefficients.
	Shapes: alphas (deg, ...), betas (deg-1, ...) → d (deg, ...), e (deg-1, ...).
	"""
	a2 = alphas.astype(jnp.promote_types(alphas.dtype, jnp.float32)) ** 2
	b2 = betas.astype(a2.dtype) ** 2
	pad = jnp.zeros_like(a2[:1])
	d = a2 + jnp.concatenate([pad, b2], axis=0)
	e = alphas[:-1].astype(a2.dtype) * betas.astype(a2.dtype)
	return d, e


@partial(jax.jit, static_argnames=("deg", "orth", "reorth_passes", "return_basis", "adjoint", "return_residual"))
def lanczos_bidiag_op(
	op,
	V0: jnp.ndarray,
	deg: int,
	orth: int = 0,
	rtol: float = 1e-8,
	reorth_passes: int = 2,
	return_basis: bool = False,
	adjoint: bool = False,
	return_residual: bool = False,
) -> BidiagOutput:
	"""`lanczos_bidiag` core with the operator as a PYTREE argument (see
	`lanczos.lanczos_block_op` for why: the compiled sweep is keyed on the
	operator's structure, not a bound method's identity).

	``adjoint=True`` bidiagonalizes ``Aᵀ`` (probes live on the m side) — used
	for Gram operators in ``AAᵀ`` mode without materializing a transpose.
	"""
	if adjoint:
		app_t = lambda Vt: op.rmatmat_t(Vt)  # noqa: E731
		rapp_t = lambda Ut: op.matmat_t(Ut)  # noqa: E731
	else:
		app_t = lambda Vt: op.matmat_t(Vt)  # noqa: E731
		rapp_t = lambda Ut: op.rmatmat_t(Ut)  # noqa: E731
	return _bidiag_core(
		app_t, rapp_t, V0, deg=deg, orth=orth, rtol=rtol,
		reorth_passes=reorth_passes, return_basis=return_basis, return_residual=return_residual,
	)


def _masked_cgs(x: jnp.ndarray, W: jnp.ndarray, valid: jnp.ndarray, passes: int) -> jnp.ndarray:
	"""Project ``x (nv, k)`` off the masked window ``W (ncv, nv, k)`` (CGS).

	Projections conjugate the bra — ``x −= Σ wᵢ⟨wᵢ, x⟩`` — a no-op for real W."""
	for _ in range(max(1, passes)):
		proj = jnp.sum(jnp.conj(W) * x[None, :, :], axis=2) * valid[:, None]  # (ncv, nv)
		x = x - jnp.sum(W * proj[:, :, None].astype(x.dtype), axis=0)
	return x


def _bidiag_core(
	app_t,
	rapp_t,
	V0: jnp.ndarray,
	*,
	deg: int,
	orth: int,
	rtol: float,
	reorth_passes: int,
	return_basis: bool,
	return_residual: bool = False,
) -> BidiagOutput:
	n, nv = V0.shape
	dtype = V0.dtype
	acc = jnp.promote_types(dtype, jnp.float32)
	# α/β are NORMS — real even for complex (Hermitian-adjoint) operators; the
	# conjugated reductions below are identities on the real path.
	r_acc = jnp.real(jnp.zeros((), acc)).dtype
	norm_of = lambda x: jnp.sqrt(jnp.real(jnp.sum(jnp.conj(x) * x, axis=1)))  # noqa: E731

	Vt0 = V0.T.astype(acc)  # (nv, n) probe-major
	norm0 = norm_of(Vt0)
	v1 = Vt0 / jnp.where(norm0 > 0, norm0, 1.0)[:, None]

	p = app_t(v1.astype(dtype)).astype(acc)  # (nv, m)
	m = p.shape[1]
	tol = jnp.sqrt(jnp.asarray(max(m, n), r_acc)) * jnp.asarray(rtol, r_acc)
	alpha1 = norm_of(p)
	u1 = p / jnp.where(alpha1 > tol, alpha1, jnp.inf)[:, None]

	keep_window = return_basis or orth > 0
	ncv = deg if return_basis else int(np.clip(orth, 1, deg))
	if keep_window:
		U_win = jnp.zeros((ncv, nv, m), acc).at[0].set(u1)
		V_win = jnp.zeros((ncv, nv, n), acc).at[0].set(v1)
	else:
		U_win = jnp.zeros((0,), acc)
		V_win = jnp.zeros((0,), acc)
	slot_ids = jnp.arange(ncv)

	def step(carry, j):
		u, v, alpha, done, U_win, V_win = carry
		if orth > 0:  # same window policy for both sides, depends only on j
			age = (j - slot_ids) % ncv
			valid = ((age < orth) & (age <= j)).astype(acc)
		# Right vector: r = Aᵀu_j − α_j v_j
		r = rapp_t(u.astype(dtype)).astype(acc) - alpha[:, None] * v
		if orth > 0:
			r = _masked_cgs(r, V_win, valid, reorth_passes)
		beta = norm_of(r)
		v_next = r / jnp.where(beta > tol, beta, jnp.inf)[:, None]
		# Left vector: p = A v_{j+1} − β_j u_j
		p = app_t(v_next.astype(dtype)).astype(acc) - beta[:, None] * u
		if orth > 0:
			p = _masked_cgs(p, U_win, valid, reorth_passes)
		alpha_next = norm_of(p)
		u_next = p / jnp.where(alpha_next > tol, alpha_next, jnp.inf)[:, None]

		newly_done = (beta < tol) | (alpha_next < tol)
		beta_out = jnp.where(done, 0.0, beta)
		alpha_out = jnp.where(done | (beta < tol), 0.0, alpha_next)

		if keep_window:
			slot = (j + 1) % ncv
			# v_next stays a valid basis vector whenever β_j survived — even on
			# an α-breakdown step, where B's column j+1 still references it
			# (A v_{j+1} = β_j u_j + α_{j+1} u_{j+1}); dropping it would break
			# A V = U B on rank-deficient operators. u_next is exactly 0 after
			# its own breakdown (guarded divide), so one shared mask suffices.
			advance = (~done) & (beta >= tol) if return_basis else jnp.ones_like(done)
			oldV = lax.dynamic_index_in_dim(V_win, slot, axis=0, keepdims=False)
			oldU = lax.dynamic_index_in_dim(U_win, slot, axis=0, keepdims=False)
			V_win = lax.dynamic_update_index_in_dim(
				V_win, jnp.where(advance[:, None], v_next, oldV), slot, axis=0
			)
			U_win = lax.dynamic_update_index_in_dim(
				U_win, jnp.where(advance[:, None], u_next, oldU), slot, axis=0
			)
		return (u_next, v_next, alpha_next, done | newly_done, U_win, V_win), (beta_out, alpha_out)

	carry0 = (u1, v1, alpha1, jnp.zeros(nv, bool), U_win, V_win)
	(u_fin, v_fin, alpha_fin, done_fin, U_fin, V_fin), (betas, alphas_rest) = lax.scan(
		step, carry0, jnp.arange(deg - 1)
	)
	alphas = jnp.concatenate([alpha1[None], alphas_rest], axis=0)  # (deg, nv)
	residual = None
	if return_residual:
		# One extra half-step: β_deg = ‖Aᵀ u_deg − α_deg v_deg‖ — the coupling
		# beyond the deg×deg factor, needed by Gauss-Radau extensions of the
		# BᵀB Jacobi matrix (β_end = α_deg·β_deg). Exited probes emit 0 (their
		# u is exactly 0 after the guarded divide, or they're masked by done).
		r = rapp_t(u_fin.astype(dtype)).astype(acc) - alpha_fin[:, None] * v_fin
		if orth > 0:
			age = (deg - 1 - slot_ids) % ncv
			valid = ((age < orth) & (age <= deg - 1)).astype(acc)
			r = _masked_cgs(r, V_fin, valid, reorth_passes)
		residual = jnp.where(done_fin, 0.0, norm_of(r))
	return BidiagOutput(
		alphas=alphas,
		betas=betas,
		U=jnp.swapaxes(U_fin, 1, 2) if return_basis else None,  # (deg, m, nv)
		V=jnp.swapaxes(V_fin, 1, 2) if return_basis else None,  # (deg, n, nv)
		residual=residual,
	)


def lanczos_bidiag(
	A,
	V0: Optional[jnp.ndarray] = None,
	deg: int = 20,
	orth: int = 0,
	rtol: float = 1e-8,
	reorth_passes: int = 2,
	return_basis: bool = False,
	seed=None,
	dtype=None,
	adjoint: bool = False,
	return_residual: bool = False,
) -> BidiagOutput:
	"""Golub-Kahan-Lanczos bidiagonalization of a (rectangular) operator.

	``deg`` steps produce per-probe upper-bidiagonal factors ``B`` with
	``A V_deg = U_deg B`` — each step one ``A`` apply + one ``Aᵀ`` apply on the
	whole probe block. ``orth`` re-orthogonalizes both U- and V-sides against a
	window of that many previous vectors (−1 = full re-orth); early exit per
	probe on an invariant subspace (residual < √max(m,n)·rtol) emits zeros, so
	the bidiagonal decouples exactly like `lanczos`'s zero-fill.

	Singular values of ``B`` approximate extremal singular values of ``A``;
	:func:`bidiag_jacobi` turns (α, β) into the Jacobi matrix of ``AᵀA`` for
	Gauss quadrature of ``v₁ᵀ f(AᵀA) v₁`` at ``κ(A)`` (not ``κ(A)²``)
	recurrence conditioning.
	"""
	from .operators import aslinop
	from .random import as_key, real_dtype

	op = aslinop(A, dtype=dtype)
	m, n = op.shape
	deg = int(np.clip(deg, 1, min(m, n)))
	orth = deg if (orth < 0 or orth > deg) else int(orth)
	side = m if adjoint else n  # adjoint=True bidiagonalizes Aᵀ: probes on the m side
	if V0 is None:
		# Real starting probes even for complex operators (same Krylov space).
		V0 = jax.random.normal(as_key(seed), (side, 1), real_dtype(op.dtype)).astype(op.dtype)
	V0 = jnp.asarray(V0, op.dtype)
	V0 = V0[:, None] if V0.ndim == 1 else V0
	assert V0.shape[0] == side, f"V0 must have {side} rows; got {V0.shape}"
	return lanczos_bidiag_op(
		op, V0, deg=deg, orth=orth, rtol=rtol,
		reorth_passes=reorth_passes, return_basis=return_basis,
		adjoint=adjoint, return_residual=return_residual,
	)
