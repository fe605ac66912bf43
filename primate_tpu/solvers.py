"""Matrix-free linear solvers: batched conjugate gradients (+ Lanczos links).

Beyond-reference capability (the reference ships no solver): completes the
Gaussian-process workflow — ``logdet(K)`` comes from SLQ
(:func:`~primate_tpu.recipes.logdet`), the quadratic term ``yᵀK⁻¹y`` from CG
on the same operator protocol. Accelerator shape: the iteration is a
`lax.while_loop` whose body is one operator application on the whole
right-hand-side block (SpMM/GEMM) plus a few batched reductions —
all RHS columns converge together with per-column masking.
"""

import warnings
from functools import partial
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .operators import aslinop
from .linalg import tall_qr
from .random import real_dtype as real_dtype_of

__all__ = ["NystromPreconditioner", "cg", "nystrom_precond", "solve"]


@jax.tree_util.register_pytree_node_class
class DiagPreconditioner:
	"""Jacobi preconditioner: ``Z = D⁻¹ R`` as an elementwise multiply."""

	def __init__(self, inv_diag: jnp.ndarray):
		self.inv_diag = inv_diag

	def apply_t(self, Rt: jnp.ndarray) -> jnp.ndarray:  # probe-major (k, n)
		return Rt * self.inv_diag[None, :]

	def tree_flatten(self):
		return (self.inv_diag,), None

	@classmethod
	def tree_unflatten(cls, aux, children):
		return cls(*children)


@jax.tree_util.register_pytree_node_class
class NystromPreconditioner:
	"""Randomized Nyström preconditioner (Frangella-Tropp-Udell 2021).

	From a rank-``s`` Nyström approximation ``Â = U Λ Uᵀ`` of SPD ``A``, the
	preconditioner ``P⁻¹ = (λ_s+μ)·U(Λ+μ)⁻¹Uᵀ + (I − UUᵀ)`` clusters the top of
	the spectrum at ``λ_s + μ``, so PCG converges at the rate of the *deflated*
	condition number. Construction is one sketch SpMM + a Cholesky + an (n×s)
	SVD; each application is two GEMMs — the device-native preconditioner for the
	GP workflow (vs incomplete factorizations, which are serial and
	sparsity-bound). Beyond-reference capability (no solver exists there).
	"""

	def __init__(self, U: jnp.ndarray, coef: jnp.ndarray):
		self.U = U  # (n, s) orthonormal
		self.coef = coef  # (s,) = (λ_s+μ)/(λ_i+μ) − 1

	def apply_t(self, Rt: jnp.ndarray) -> jnp.ndarray:  # probe-major (k, n)
		# Row-major P⁻¹: (UU†r)ᵀ = rᵀ·conj(U)·Uᵀ (conj is a no-op for real U).
		C = Rt @ jnp.conj(self.U)  # (k, s)
		return Rt + (C * self.coef[None, :]) @ self.U.T

	def tree_flatten(self):
		return (self.U, self.coef), None

	@classmethod
	def tree_unflatten(cls, aux, children):
		return cls(*children)


def nystrom_precond(A, rank: int = 64, mu: float = 0.0, seed=None) -> NystromPreconditioner:
	"""Build a rank-``rank`` :class:`NystromPreconditioner` for SPD ``A`` (+μI)."""
	from .random import as_key, sample_isotropic

	op = aslinop(A)
	n = op.shape[0]
	s = int(max(1, min(rank, n)))
	acc = jnp.promote_types(op.dtype, jnp.float32)
	r_acc = real_dtype_of(acc)
	Om = sample_isotropic(as_key(seed), (n, s), pdf="normal", dtype=real_dtype_of(op.dtype))
	Om, _ = tall_qr(Om.astype(acc))
	Y = (op.matmat(Om.astype(op.dtype))).astype(acc)
	nu = jnp.finfo(r_acc).eps * jnp.linalg.norm(Y) / jnp.sqrt(jnp.asarray(n, r_acc))
	Y = Y + nu * Om
	L = jnp.linalg.cholesky(0.5 * ((jnp.conj(Om).T @ Y) + (jnp.conj(Y).T @ Om)))  # ½(Ω†Y + Y†Ω)
	# Small (s×s) triangular inverse + GEMM instead of a triangular solve with
	# an (s, n) RHS — back-substitution at that shape serializes.
	L_inv = jax.scipy.linalg.solve_triangular(L, jnp.eye(s, dtype=acc), lower=True)
	B = Y @ jnp.conj(L_inv).T  # (n, s) = Y L^{-H}
	# Left singular vectors via eigh of the small (s×s) Gram matrix instead of
	# an (n×s) SVD: one GEMM + a tiny eigendecomposition. Squares B's condition
	# number, but a preconditioner only needs the spectrum approximately.
	d, W = jnp.linalg.eigh(jnp.conj(B).T @ B)
	d, W = d[::-1], W[:, ::-1]  # descending, like the SVD convention
	safe = jnp.maximum(d, jnp.finfo(acc).tiny)
	U = B @ (W * jax.lax.rsqrt(safe)[None, :])
	lam = jnp.maximum(d - nu, 0.0)
	# PD floor: when the sketch rank exceeds the numerical rank (fast-decaying
	# GP-style spectra), lam_s -> 0 makes coef -> -1 and P^{-1} = I - UU† is
	# SINGULAR — PCG then diverges. Floor lam_s relative to lam_max (so the top
	# subspace is damped, never annihilated) and floor the denominators at
	# lam_s (so rank-deficient tail directions are left at scale 1 rather than
	# inflated by 1/lam_tiny).
	lam_max = jnp.maximum(lam[0], jnp.finfo(r_acc).tiny)
	# √eps·λmax (≈3.5e-4·λmax at f32): large enough that applying
	# I + Σ coef·uu† keeps ≳3-digit relative accuracy in the damped subspace
	# (1 + coef suffers cancellation ~eps/(1+coef)), small enough to still
	# flatten the captured spectrum onto ~[λ_floor, λ_s].
	lam_s = jnp.maximum(lam[-1], jnp.sqrt(jnp.finfo(r_acc).eps) * lam_max)
	coef = (lam_s + mu) / (jnp.maximum(lam, lam_s) + mu) - 1.0
	# A NaN Cholesky (rank-collapsed sketch at f32) must degrade to P = I, not
	# poison every solve.
	coef = jnp.where(jnp.isfinite(coef), coef, 0.0)
	U = jnp.where(jnp.isfinite(U), U, 0.0)
	return NystromPreconditioner(U=U, coef=coef)


class CGState(NamedTuple):
	it: jnp.ndarray  # ()
	X: jnp.ndarray  # (n, k) current iterates
	R: jnp.ndarray  # (n, k) residuals
	P: jnp.ndarray  # (n, k) search directions
	rs: jnp.ndarray  # (k,) residual norms² (at acc dtype)
	done: jnp.ndarray  # (k,) bool


@partial(jax.jit, static_argnames=("matmat", "maxiter", "matmat_t"))
def _cg_loop(
	matmat: Callable, B: jnp.ndarray, X0: jnp.ndarray, pre, rtol, maxiter: int,
	matmat_t: Optional[Callable] = None,
) -> CGState:
	# The loop carries its (X, R, P) state PROBE-MAJOR — (k, n), contiguous n
	# — the layout the Lanczos sweep carries, so the probe count never sets
	# the minor dimension. GP-style solves with one
	# or a few right-hand sides are the common case. State transposes back to
	# the (n, k) API layout at exit.
	if matmat_t is None:
		matmat_t = lambda Xt: matmat(Xt.T).T  # noqa: E731
	acc = jnp.promote_types(B.dtype, jnp.float32)
	# Hermitian (complex) operators: CG inner products conjugate the bra —
	# ⟨r, z⟩ and ⟨p, Ap⟩ are REAL, so α/β and the stopping state stay real.
	# Both conj and real are identities on the real path (lowering unchanged).
	inner = lambda X, Y: jnp.real(jnp.sum(jnp.conj(X) * Y, axis=1))  # noqa: E731
	Bt, X0t = B.T, X0.T
	R0 = (Bt - matmat_t(X0t)).astype(acc)
	Z0 = pre.apply_t(R0) if pre is not None else R0
	b_norm2 = inner(Bt.astype(acc), Bt.astype(acc))
	tol2 = (rtol**2) * jnp.maximum(b_norm2, jnp.finfo(b_norm2.dtype).tiny)

	init = CGState(
		it=jnp.zeros((), jnp.int32),
		X=X0t.astype(acc),
		R=R0,
		P=Z0,
		rs=inner(R0, Z0),
		done=inner(R0, R0) <= tol2,
	)

	def cond(s: CGState):
		return jnp.logical_and(s.it < maxiter, jnp.logical_not(jnp.all(s.done)))

	def body(s: CGState):
		AP = matmat_t(s.P.astype(B.dtype)).astype(acc)
		pAp = inner(s.P, AP)
		alpha = jnp.where(s.done | (pAp == 0), 0.0, s.rs / jnp.where(pAp == 0, 1.0, pAp))
		X = s.X + alpha[:, None] * s.P
		R = s.R - alpha[:, None] * AP
		Z = pre.apply_t(R) if pre is not None else R
		rs_new = inner(R, Z)
		done = s.done | (inner(R, R) <= tol2)
		beta = jnp.where(done | (s.rs == 0), 0.0, rs_new / jnp.where(s.rs == 0, 1.0, s.rs))
		P = Z + beta[:, None] * s.P
		return CGState(it=s.it + 1, X=X, R=R, P=P, rs=rs_new, done=done)

	out = lax.while_loop(cond, body, init)
	return CGState(it=out.it, X=out.X.T, R=out.R.T, P=out.P.T, rs=out.rs, done=out.done)


@partial(jax.jit, static_argnames=("maxiter",))
def _cg_loop_op(op, B, X0, pre, rtol, *, maxiter: int) -> CGState:
	"""`_cg_loop` with the operator as a PYTREE argument — the compiled loop is
	keyed on the operator's structure (not the bound-method identity `_cg_loop`'s
	static `matmat` would pin), so per-instance operators reuse the executable."""
	return _cg_loop(op.matmat, B, X0, pre, rtol, maxiter, matmat_t=getattr(op, "matmat_t", None))


def cg(
	A,
	B: jnp.ndarray,
	X0: Optional[jnp.ndarray] = None,
	rtol: float = 1e-6,
	maxiter: Optional[int] = None,
	precond: Optional[Union[str, jnp.ndarray, "NystromPreconditioner"]] = None,
	full: bool = False,
	precond_rank: int = 64,
	precond_seed=None,
):
	"""Solve ``A X = B`` for SPD ``A`` by (preconditioned) conjugate gradients.

	``B`` may be a vector or an ``(n, k)`` block — all right-hand sides advance
	in one fused loop (each step is a single SpMM). ``precond``: ``"jacobi"``
	(diagonal of A, estimated exactly when the operator is dense/DIA, otherwise
	by :func:`~primate_tpu.diag`), ``"nystrom"`` (rank-``precond_rank``
	randomized Nyström — the right choice when the spectrum has outliers, as GP
	kernels do), an explicit diagonal array, or a prebuilt
	:class:`NystromPreconditioner` (reuse it across solves against the same A).

	Returns ``X`` (same shape as ``B``); with ``full=True`` also
	``(iterations, residual_norms)``.
	"""
	op = aslinop(A)
	n = op.shape[0]
	B = jnp.asarray(B, dtype=op.dtype)
	single = B.ndim == 1
	if single:
		B = B[:, None]
	warm_start = X0 is not None
	X0 = jnp.zeros_like(B) if X0 is None else jnp.asarray(X0, dtype=B.dtype).reshape(B.shape)
	maxiter = int(maxiter) if maxiter is not None else min(10 * n, 10_000)

	M_inv_diag = None
	if precond is not None:
		if isinstance(precond, (NystromPreconditioner, DiagPreconditioner)):
			M_inv_diag = precond
		elif precond == "nystrom":
			M_inv_diag = nystrom_precond(op, rank=precond_rank, seed=precond_seed)
		else:
			if isinstance(precond, str):
				assert precond == "jacobi", f"Unknown preconditioner '{precond}'"
				d, d_stochastic = _operator_diagonal(op)
			else:
				# User-supplied diagonals are trusted as exact (the caller knows
				# their provenance; pass a pre-floored array for noisy estimates).
				d, d_stochastic = jnp.asarray(precond), False
			acc = jnp.promote_types(B.dtype, jnp.float32)
			M_inv_diag = DiagPreconditioner(_jacobi_weights(d, d_stochastic, acc))

	is_cplx = jnp.dtype(op.dtype).kind == "c"
	if full or is_cplx:
		# Diagnostic path (iterations / residuals) — not differentiable. Complex
		# (Hermitian) systems also solve here: `custom_linear_solve(symmetric=
		# True)` transposes with A itself, which is Aᵀ = conj(A) ≠ A for complex
		# Hermitian operators — its cotangent solve would be silently wrong.
		# Operator rides as a PYTREE argument: the compiled loop is keyed on
		# its structure, so fresh same-shaped operators (GP hyperparameter
		# loops) reuse the executable instead of retracing per instance.
		state = _cg_loop_op(op, B, X0, M_inv_diag, float(rtol), maxiter=maxiter)
		X = state.X.astype(B.dtype)
		X = X[:, 0] if single else X
		if not full:
			return X
		res = np.sqrt(np.maximum(np.asarray(jax.device_get(jnp.sum(jnp.abs(state.R) ** 2, axis=0))), 0.0))
		return X, int(state.it), (res[0] if single else res)

	# Differentiable path: implicit differentiation via custom_linear_solve —
	# the VJP of an SPD solve is another solve with the same operator, so
	# gradients flow through A's pytree leaves and b without unrolling CG.
	# A warm start shifts the system (solve A·ΔX = B − A·X0) so the transpose
	# solve is unaffected. The program is jitted with the operator as a pytree
	# argument, so repeated solves against the same operator type hit the
	# compile cache instead of retracing per call.
	if warm_start:
		# The shifted system A·ΔX = B − A·X0 converges when ‖R‖ ≤ rtol·‖B‖ —
		# the USER's target — not rtol·‖B − A·X0‖ (much stricter for a good
		# warm start): rescale the per-column rtol by the norm ratio so both
		# cg paths stop at the same documented criterion.
		Bs = B - op.matmat(X0)
		acc = jnp.promote_types(B.dtype, jnp.float32)
		nb = jnp.linalg.norm(B.astype(acc), axis=0)
		ns = jnp.linalg.norm(Bs.astype(acc), axis=0)
		rtol_eff = jnp.asarray(rtol, jnp.real(nb).dtype) * jnp.real(nb) / jnp.maximum(jnp.real(ns), jnp.finfo(jnp.zeros((), acc).real.dtype).tiny)
		dX = _cg_program(op, Bs, M_inv_diag, rtol_eff, maxiter=maxiter)
		X = (X0 + dX).astype(B.dtype)
	else:
		X = _cg_program(op, B, M_inv_diag, float(rtol), maxiter=maxiter)
	return X[:, 0] if single else X


@partial(jax.jit, static_argnames=("maxiter",))
def _cg_program(op, B, M_inv_diag, rtol, *, maxiter: int):
	def solve_fn(mv, B_in):
		# symmetric=True: every solve custom_linear_solve requests (forward,
		# tangent, cotangent) is against the SAME operator, so the native
		# probe-major apply closed over from `op` is always the right one —
		# `mv` is a reconstructed callable, never `op.matmat` by identity.
		return _cg_loop(
			mv, B_in, jnp.zeros_like(B_in), M_inv_diag, rtol, maxiter,
			matmat_t=getattr(op, "matmat_t", None),
		).X.astype(B_in.dtype)

	return lax.custom_linear_solve(op.matmat, B, solve=solve_fn, symmetric=True)


def _jacobi_weights(d, stochastic: bool, acc) -> jnp.ndarray:
	"""Per-entry Jacobi weights ``1/d`` with a provenance-aware floor.

	Floor policy depends on how trustworthy the diagonal is:
	  * EXACT diagonals (extracted from the operator, or user-supplied — the
	    caller controls those) keep exact ``1/d`` down to an eps-relative
	    positivity threshold, so a legitimate SPD diagonal spanning many
	    orders of magnitude is not silently weakened;
	  * STOCHASTIC estimates (matrix-free fallback) can come out ≤ 0 or
	    tiny-positive on non-diagonally-dominant operators; exact ``1/d`` of a
	    noisy near-zero entry is a huge, wrong weight that breaks or stalls
	    PCG — those floor conservatively at ``1e-3·mean`` (review r4).
	"""
	d = jnp.real(d)  # Hermitian diagonals are real (no-op for real d)
	d_mean = jnp.maximum(jnp.mean(jnp.abs(d)), jnp.finfo(acc).tiny)
	rel_floor = 1e-3 if stochastic else float(jnp.finfo(acc).eps)
	d_tiny = rel_floor * d_mean  # positivity/floor threshold
	d_floor = 1e-3 * d_mean  # replacement weight for floored entries
	floored = d <= d_tiny
	_warn_floored_if_free(floored, d_floor)
	return jnp.where(floored, 1.0 / d_floor, 1.0 / jnp.maximum(d, d_tiny)).astype(real_dtype_of(acc))


def _warn_floored_if_free(floored, d_floor) -> None:
	"""Warn that Jacobi flooring fired — but ONLY when counting costs nothing.

	Under tracing there is no concrete value; on an accelerator an eager
	scalar pull is a device→host sync per cg call (the latency class this
	library eliminates elsewhere), so the check runs only for host-resident
	(numpy / local-CPU) values.
	"""
	if isinstance(floored, jax.core.Tracer):
		return
	devices = getattr(floored, "devices", None)
	if callable(devices):
		try:
			if any(dev.platform != "cpu" for dev in floored.devices()):
				return
		except Exception:
			return
	n_floored = int(np.sum(np.asarray(floored)))
	if n_floored:
		warnings.warn(
			f"jacobi preconditioner: {n_floored} non-positive/tiny diagonal "
			f"entr{'y' if n_floored == 1 else 'ies'} floored to weight 1/{float(d_floor):.3g} "
			"(stochastic diagonal estimate?)",
			stacklevel=3,
		)


def _operator_diagonal(op) -> tuple:
	"""``(diagonal, stochastic)``: exact extraction when cheap, else a
	stochastic estimate (the flag drives the Jacobi floor policy)."""
	from .operators import DenseOperator
	from .operators.sparse import CSROperator, DIAOperator

	if isinstance(op, DenseOperator):
		return jnp.diagonal(op.A), False
	if isinstance(op, DIAOperator) and 0 in op.offsets:
		return op.bands[op.offsets.index(0)], False
	if isinstance(op, CSROperator):
		if op.shape[0] <= 4096:
			return jnp.diagonal(op.todense()), False
		return _stochastic_diag(op), True
	return _stochastic_diag(op), True


def _stochastic_diag(op) -> jnp.ndarray:
	from .diagonal import diag

	return jnp.asarray(diag(op, converge="count", count=256, seed=0))


def solve(A, b: jnp.ndarray, **kwargs) -> jnp.ndarray:
	"""Alias for :func:`cg` — ``solve(A, b)`` reads naturally in GP losses."""
	return cg(A, b, **kwargs)
