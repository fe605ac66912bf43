"""True block Lanczos: block-tridiagonal Krylov factorization + block quadrature.

Beyond the reference: `primate` (and `primate_tpu.lanczos`) advance nv
*independent* three-term recurrences — one Jacobi matrix per probe. Block
Lanczos instead couples a probe block ``V (n, b)`` into ONE Krylov space
``span{V, AV, ..., A^{deg-1}V}``, producing a block-tridiagonal

	T = [A₁ B₁ᵀ          ]
	    [B₁ A₂ B₂ᵀ       ]      Aⱼ, Bⱼ ∈ R^{b×b},  Bⱼ upper-triangular
	    [   B₂ A₃ ⋱      ]
	    [       ⋱  ⋱     ]

with ``A Q = Q T + residual`` for the orthonormal basis ``Q = [V₁ … V_deg]``.
Why it earns its keep:

  * **multiplicities**: a single-vector Krylov space contains at most one
    copy of each eigenvalue; a width-``b`` block space captures eigenvalues
    of multiplicity up to ``b`` (the classic failure mode of plain Lanczos).
  * **matrix-valued Gauss quadrature** (Golub–Meurant ch. 6): the leading
    b×b block of ``f(T)`` gives ``Vᵀ f(A) V ≈ R₀ᵀ [f(T)]₁₁ R₀`` — the block
    analog of the scalar rule ``vᵀf(A)v ≈ ‖v‖² e₁ᵀf(J)e₁`` the estimators
    are built on, with lower quadrature bias at equal degree because each
    column's approximation error is governed by the *block* space.
  * **Accelerator shape**: every step is two (n, b) GEMMs + one thin QR — GEMM work,
    no per-column seriality.

All hot paths are jitted `lax.scan`s; the full basis is carried in a
preallocated ``(deg, n, b)`` buffer (zero slots project to zero, so the
re-orthogonalization needs no masking).
"""

from functools import partial
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .operators import aslinop
from .random import as_key, sample_isotropic
from .special import param_callable

__all__ = ["BlockLanczosOutput", "block_lanczos", "block_jacobi_dense", "block_quadrature", "block_slq_trace"]


class BlockLanczosOutput(NamedTuple):
	"""Block-tridiagonal factorization of a symmetric operator.

	Ablocks: (deg, b, b) symmetric diagonal blocks A₁..A_deg.
	Bblocks: (deg, b, b) sub-diagonal blocks; ``Bblocks[j]`` couples step j to
	         j+1 (the last entry is the residual factor — the block analog of
	         the trailing β_deg in :class:`~primate_tpu.lanczos.LanczosOutput`).
	R0:      (b, b) upper-triangular factor of the input block ``V0 = Q₁ R0``
	         (the quadrature weight: Vᵀf(A)V = R0ᵀ [f(T)]₁₁ R0).
	basis:   (deg, n, b) orthonormal block basis, or None.
	"""

	Ablocks: jnp.ndarray
	Bblocks: jnp.ndarray
	R0: jnp.ndarray
	basis: Optional[jnp.ndarray] = None


def _qr_pos(W: jnp.ndarray):
	"""Thin QR with a nonnegative-real-diagonal R (deterministic sign convention).

	For complex ``W`` the sign flip generalizes to a unit-phase rotation per
	column: ``Q ← Q·diag(p)``, ``R ← diag(p̄)·R`` with ``p = d/|d|``.
	"""
	Q, R = jnp.linalg.qr(W, mode="reduced")
	d = jnp.diagonal(R)
	if jnp.iscomplexobj(W):
		mag = jnp.abs(d)
		p = jnp.where(mag > 0, d / jnp.where(mag > 0, mag, 1.0), 1.0 + 0.0j)
	else:
		p = jnp.where(d < 0, -1.0, 1.0).astype(W.dtype)
	return Q * p[None, :], R * jnp.conj(p)[:, None]


@partial(jax.jit, static_argnames=("deg", "reorth", "return_basis"))
def _block_lanczos_core(
	op,
	V0: jnp.ndarray,
	deg: int,
	reorth: bool = True,
	return_basis: bool = False,
) -> BlockLanczosOutput:
	"""``deg`` block Lanczos steps from ``V0 (n, b)`` — pure/jittable.

	``op`` is a LinearOperator PYTREE argument (not a static callable), so the
	compiled program is cached by operator *structure* — sweeping many
	same-shaped matrices reuses one executable instead of baking each matrix
	in as a constant (same design as `lanczos.lanczos_block_op`).

	Complex-Hermitian operators are handled by the package-wide convention
	(conjugated bra-side inner products; the diagonal blocks Aⱼ are Hermitian
	and T stays Hermitian, so eigh-based quadrature is unchanged). V0 may be
	real even when the operator is complex — the first apply promotes it.
	"""
	matmat = op.matmat
	n, b = V0.shape
	acc = jnp.promote_types(V0.dtype, jnp.float32)
	V0 = V0.astype(acc)
	out_aval = jax.eval_shape(matmat, jax.ShapeDtypeStruct((n, b), acc))
	if jnp.issubdtype(out_aval.dtype, jnp.complexfloating):
		acc = jnp.promote_types(acc, out_aval.dtype)
		V0 = V0.astype(acc)
	Q1, R0 = _qr_pos(V0)

	keep_basis = reorth or return_basis
	basis0 = jnp.zeros((deg, n, b), acc)
	if keep_basis:
		basis0 = basis0.at[0].set(Q1)

	def step(carry, j):
		V_prev, V_cur, B_prev, basis = carry
		W = matmat(V_cur).astype(acc)
		Aj = V_cur.conj().T @ W
		Aj = 0.5 * (Aj + Aj.conj().T)
		W = W - V_cur @ Aj - V_prev @ B_prev.conj().T
		if reorth:
			# two CGS passes against every block written so far; slots ≥ j are
			# zero, so they project to zero — no validity mask required.
			for _ in range(2):
				proj = jnp.einsum("tnb,nc->tbc", basis.conj(), W)
				W = W - jnp.einsum("tnb,tbc->nc", basis, proj)
		V_next, B_next = _qr_pos(W)
		if keep_basis:
			basis = lax.cond(
				j + 1 < deg,
				lambda bs: bs.at[j + 1].set(V_next),
				lambda bs: bs,
				basis,
			)
		return (V_cur, V_next, B_next, basis), (Aj, B_next)

	Zb = jnp.zeros((b, b), acc)
	init = (jnp.zeros_like(Q1), Q1, Zb, basis0)
	(_, _, _, basis), (Ab, Bb) = lax.scan(step, init, jnp.arange(deg))
	return BlockLanczosOutput(Ab, Bb, R0.astype(acc), basis if return_basis else None)


def block_lanczos(
	A,
	V0: Optional[jnp.ndarray] = None,
	deg: Optional[int] = None,
	b: int = 4,
	reorth: bool = True,
	return_basis: bool = False,
	pdf: str = "normal",
	seed=None,
) -> BlockLanczosOutput:
	"""Block Lanczos factorization of a symmetric operator.

	Parameters mirror :func:`~primate_tpu.lanczos.lanczos` where they overlap;
	``b`` is the block width (ignored when ``V0`` is given). ``deg`` counts
	*block* steps, so the Krylov space has dimension ``deg·b`` (clamped to n).

	>>> out = block_lanczos(A, b=4, deg=10, seed=0)
	>>> T = block_jacobi_dense(out.Ablocks, out.Bblocks)   # (40, 40) banded
	"""
	op = aslinop(A)
	n = op.shape[0]
	if V0 is None:
		key = as_key(seed)
		b = min(int(b), n)  # a block wider than the space has dependent columns
		V0 = sample_isotropic(key, (n, b), pdf=pdf, dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
	V0 = jnp.asarray(V0)
	assert V0.ndim == 2 and V0.shape[0] == n, f"V0 must be (n, b) with n={n}; got {V0.shape}"
	assert V0.shape[1] <= n, f"Block width b={V0.shape[1]} exceeds the operator dimension n={n}; thin QR of the block would be rank-deficient"
	b = V0.shape[1]
	deg = int(max(1, min(n // b if deg is None else deg, n // max(b, 1))))
	return _block_lanczos_core(op, V0, deg=deg, reorth=reorth, return_basis=return_basis)


def block_jacobi_dense(Ablocks: jnp.ndarray, Bblocks: jnp.ndarray) -> jnp.ndarray:
	"""Densify block-tridiagonal coefficients into the (deg·b, deg·b) matrix T.

	``Bblocks[deg-1]`` is the residual factor and is not part of T (exactly as
	the trailing β_deg is dropped when densifying the scalar Jacobi matrix).
	"""
	deg, b, _ = Ablocks.shape
	m = deg * b
	T = jnp.zeros((m, m), Ablocks.dtype)

	def put(T, j):
		T = lax.dynamic_update_slice(T, Ablocks[j], (j * b, j * b))
		off = Bblocks[j]

		def with_off(T):
			T = lax.dynamic_update_slice(T, off, ((j + 1) * b, j * b))
			return lax.dynamic_update_slice(T, off.conj().T, (j * b, (j + 1) * b))

		return lax.cond(j + 1 < deg, with_off, lambda T: T, T), None

	T, _ = lax.scan(put, T, jnp.arange(deg))
	return T


def block_quadrature(out: BlockLanczosOutput, fun: Union[str, Callable], **kwargs) -> jnp.ndarray:
	"""Matrix-valued Gauss rule: ``Vᵀ f(A) V ≈ R0ᵀ [f(T)]₁₁ R0`` (b×b).

	``[f(T)]₁₁`` is the leading b×b block of ``f`` applied to the densified
	block-tridiagonal matrix (Golub–Meurant block quadrature). Exact whenever
	``deg·b ≥ n`` and the basis stayed orthonormal.
	"""
	f = param_callable(fun, **kwargs) if isinstance(fun, str) else (fun or (lambda x: x))
	T = block_jacobi_dense(out.Ablocks, out.Bblocks)
	theta, Y = jnp.linalg.eigh(T)  # T is Hermitian; theta real either way
	b = out.R0.shape[0]
	Y1 = Y[:b, :]  # (b, deg·b) first block-row of eigenvectors
	F11 = (Y1 * f(theta)[None, :]) @ Y1.conj().T
	return out.R0.conj().T @ F11 @ out.R0


def block_slq_trace(
	A,
	fun: Union[str, Callable, None] = None,
	b: int = 8,
	deg: int = 20,
	nblocks: int = 16,
	pdf: str = "normal",
	reorth: bool = True,
	seed=None,
	full: bool = False,
	**kwargs,
):
	"""tr(f(A)) by block stochastic Lanczos quadrature.

	Each of the ``nblocks`` isotropic blocks ``V (n, b)`` contributes the
	sample ``tr(Vᵀ f(A) V) / b`` — an unbiased estimate of ``tr(f(A))`` whose
	quadrature bias is controlled by the *block* Krylov space (clustered /
	multiple eigenvalues converge at width ``b``, where the per-vector rule of
	:func:`~primate_tpu.hutch` ∘ :class:`~primate_tpu.MatrixFunction` stalls).

	Returns the estimate, or ``(estimate, samples)`` when ``full=True``.
	``differentiable=True`` returns the traced scalar: the program is a fixed
	composition (block recurrence + thin QR + eigh quadrature), so ``jax.grad``
	is the exact derivative of the estimator.
	"""
	differentiable = kwargs.pop("differentiable", False)
	op = aslinop(A)
	n = op.shape[0]
	key = as_key(seed)
	f = _resolve_fun(fun, **kwargs)
	b = min(int(b), n)
	deg = int(max(1, min(deg, n // max(b, 1))))
	samples = _block_slq_program(op, key, fun=f, n=n, b=b, deg=deg, pdf=pdf, reorth=reorth, nblocks=int(nblocks))
	est = jnp.mean(samples)
	if differentiable:
		assert not full, "differentiable=True returns the traced estimate only"
		return est
	return (float(est), np.asarray(samples)) if full else float(est)


def _resolve_fun(fun, **kwargs):
	# param_callable already memoizes builtins on (name, params) — a stable
	# identity for the static `fun` jit argument — so no extra cache layer.
	if isinstance(fun, str):
		return param_callable(fun, **kwargs)
	return fun or _identity_fun


def _identity_fun(x):
	return x


@partial(jax.jit, static_argnames=("fun", "n", "b", "deg", "pdf", "reorth", "nblocks"))
def _block_slq_program(op, key, *, fun, n: int, b: int, deg: int, pdf: str, reorth: bool, nblocks: int):
	"""All ``nblocks`` block-quadrature samples as ONE program (op = pytree arg)."""

	def one_block(k):
		V0 = sample_isotropic(k, (n, b), pdf=pdf, dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
		out = _block_lanczos_core(op, V0, deg=deg, reorth=reorth)
		G = block_quadrature(out, fun)
		# Hermitian quadrature: tr(Vᵀf(A)V) is real up to roundoff.
		return jnp.real(jnp.trace(G)) / b

	return jax.lax.map(one_block, jax.random.split(key, nblocks))
