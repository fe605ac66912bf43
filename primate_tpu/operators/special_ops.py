"""Structured and spectral operators: MatrixFunction, Toeplitz, normalize_unit.

Parity: reference ``src/primate/operators.py:36-193`` (`MatrixFunction`,
`matrix_function`, `Toeplitz`, `normalize_unit`).

Accelerator-first: `MatrixFunction.matvec`/`quad` are fully batched — one fused block
Lanczos sweep (a `lax.scan` of GEMMs) plus one batched tridiagonal eigensolve
covers **all** probe columns, replacing the reference's serial per-column loop
(`operators.py:145-150`). Both methods are jittable and differentiable, and
compose with the stochastic estimators (``hutch(MatrixFunction(A, "log"))`` is
stochastic Lanczos quadrature for logdet as a single device program).
"""

from typing import Callable, Optional, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from ..special import param_callable
from ..tridiag import eigh_tridiag
from .base import LinearOperator, aslinop, is_linear_op

__all__ = ["MatrixFunction", "matrix_function", "Toeplitz", "ScaledOperator", "normalize_unit"]


@jax.tree_util.register_pytree_node_class
class MatrixFunction(LinearOperator):
	r"""Implicit matrix function ``f(A) = U f(Λ) Uᵀ`` as a linear operator.

	``matvec`` approximates ``x ↦ f(A)x`` by a degree-``deg`` Krylov expansion:
	``‖x‖ · Q · Y · (f(θ) ∘ Y[0,:])ᵀ`` where ``T = YᵀΘY`` is the Lanczos
	tridiagonal (reference `operators.py:102-124`); ``quad`` estimates
	``x ↦ xᵀ f(A) x`` by Gauss quadrature on the Jacobi matrix
	(`operators.py:126-151`). Both accept blocks of columns and run batched.

	Parameters:
		A: array / sparse / LinearOperator to lift.
		fun: spectral function (builtin name or jnp-traceable callable).
		deg: Krylov expansion degree.
		orth: re-orthogonalization count (<0 or >deg means full).
		dtype: computation dtype (defaults to A's dtype).
		kwargs: forwarded to the builtin-function factory (e.g. ``t`` for exp).
	"""

	def __init__(
		self,
		A,
		fun: Union[str, Callable, None] = None,
		deg: int = 20,
		orth: int = 3,
		dtype=None,
		two_pass: Union[bool, str] = "auto",
		reorth_passes: int = 2,
		basis_dtype=None,
		quad_rule: str = "gauss",
		interval: Optional[tuple] = None,
		**kwargs,
	):
		assert is_linear_op(A) or isinstance(A, (jnp.ndarray, np.ndarray)), (
			"Invalid operator `A`; must be dim=2 symmetric operator with defined matvec"
		)
		assert deg >= 2, "Degree must be >= 2"
		self._A = aslinop(A, dtype=dtype)
		self.shape = self._A.shape
		self.dtype = jnp.dtype(dtype) if dtype is not None else self._A.dtype
		self.fun = param_callable(fun, **kwargs) if (fun is None or isinstance(fun, str)) else fun
		assert callable(self.fun), "Function must be callable."
		# The setter saw the resolved callable; record scalar-ness from the RAW spec.
		self._fun_scalar = fun is None or isinstance(fun, str)
		self._deg = int(min(deg, self.shape[0]))
		self._orth = self._deg if (orth < 0 or orth > self._deg) else int(orth)
		self._rtol = kwargs.get("rtol", 1e-8)
		self._two_pass = two_pass
		# CGS passes per re-orth (2 = CGS2, the stable default; 1 halves the
		# window-GEMM traffic when deg is modest and A is well-conditioned).
		self._reorth_passes = int(reorth_passes)
		# bf16 here halves the re-orth window's HBM traffic; the recurrence and
		# Jacobi coefficients stay full precision (see lanczos basis_dtype).
		# NOTE: the one-pass matvec reconstructs y from the stored window, so a
		# narrowed window caps ITS accuracy at basis_dtype; two_pass="auto"
		# therefore switches to the two-pass matvec (full-precision y), and quad
		# never reads the window at all.
		self._basis_dtype = basis_dtype
		# quad_rule selects the Gauss rule family used by .quad(): "gauss"
		# (default), or the Golub-modified "radau_lo"/"radau_hi"/"lobatto" rules
		# with node(s) pinned at `interval` endpoints — their quadrature error
		# has a KNOWN SIGN for derivative-sign-definite f (Golub-Meurant), so
		# hutch(MatrixFunction(A, "log", quad_rule="radau_lo", interval=(a, b)))
		# is an SLQ estimator whose bias is provably one-sided (certified bound
		# when combined with a CLT confidence side). See recipes.trace_bounds.
		assert quad_rule in ("gauss", "radau_lo", "radau_hi", "lobatto"), f"Unknown quad_rule {quad_rule!r}"
		if quad_rule != "gauss":
			assert interval is not None, "radau/lobatto quad rules need interval=(a, b) endpoints outside the spectrum"
		self._quad_rule = quad_rule
		self._interval = None if interval is None else (float(interval[0]), float(interval[1]))

	@property
	def fun(self) -> Callable:
		"""The spectral function; assignable after construction (a string is
		resolved through the builtin gallery). Parity: the reference's
		validating property pair `operators.py:87-97`."""
		return self._fun

	@fun.setter
	def fun(self, value: Union[str, Callable, None]) -> None:
		# Track whether the output shape is knowable without tracing: builtins
		# are scalar; `special.stacked` families advertise `.nout`; arbitrary
		# callables may be vector-valued (reference `operators.py:63-66`), so
		# their stack shape stays unknown until probed.
		self._fun_scalar = value is None or isinstance(value, str)
		if value is None or isinstance(value, str):
			value = param_callable(value)
		assert callable(value), "Function must be callable."
		self._fun = value

	@property
	def stack_shape(self) -> Optional[Tuple[int, ...]]:
		"""Leading (stack) axes of `quad`/`matvec` outputs, if statically known.

		``()`` for scalar spectral functions, ``(nt,)`` for `special.stacked`
		families, ``None`` when the function's output shape can only be learned
		by tracing (`jax.eval_shape`) — estimators use this to skip a full
		host retrace per call (measured 34 ms/call at deg 20, n=500k)."""
		nout = getattr(self._fun, "nout", None)
		if nout is not None:
			return (int(nout),)
		return () if self._fun_scalar else None

	@property
	def degree(self) -> int:
		return self._deg

	@property
	def operator(self) -> LinearOperator:
		return self._A

	def _lanczos(self, X: jnp.ndarray, ncv: int, return_basis: bool = True, coeffs=None):
		# Operator-as-pytree entry point: the compiled sweep is keyed on the
		# operator's STRUCTURE, so same-shaped matrices re-use it (a bound
		# method would pin the jit cache to this instance and bake A in).
		from ..lanczos import lanczos_block_op

		return lanczos_block_op(
			self._A,
			X,
			deg=self._deg,
			ncv=ncv,
			orth=self._orth,
			rtol=self._rtol,
			reorth_passes=self._reorth_passes,
			return_basis=return_basis,
			coeffs=coeffs,
			basis_dtype=self._basis_dtype,
		)

	def _modified_rule(self, d: jnp.ndarray, e: jnp.ndarray, beta_end: jnp.ndarray):
		"""The configured Gauss-Radau/Lobatto rule on batched Jacobi (d, e)."""
		from ..integrate import lobatto_rule, radau_rule

		a, b = self._interval
		if self._quad_rule == "radau_lo":
			return radau_rule(d, e, beta_end, a)
		if self._quad_rule == "radau_hi":
			return radau_rule(d, e, beta_end, b)
		return lobatto_rule(d, e, beta_end, a, b)

	def _use_two_pass(self, nv: int) -> bool:
		if isinstance(self._two_pass, bool):
			return self._two_pass
		# auto, rule 1: a narrowed basis window (basis_dtype=bf16) would cap the
		# ONE-pass matvec at window precision (y is reconstructed as Q·c from
		# the stored window); the two-pass path re-runs the recurrence in full
		# precision and accumulates y at acc_dtype, so prefer it.
		if self._basis_dtype is not None and jnp.dtype(self._basis_dtype).itemsize < jnp.dtype(self.dtype).itemsize:
			return True
		# auto, rule 2: avoid materializing a (deg, n, nv) basis past ~1 GiB —
		# trade a second sweep (2× matvecs) for O(n·nv) memory (classic 2-pass f(A)v).
		itemsize = jnp.dtype(self.dtype).itemsize
		return self._deg * self.shape[0] * nv * itemsize > (1 << 30)

	def _coeffs(self, out) -> jnp.ndarray:
		"""Expansion coefficients of f(T)e₁ in the Lanczos basis → (b, deg).

		A STACKED spectral function (``f(θ)`` with extra leading axes, e.g. from
		:func:`~primate_tpu.special.stacked`) yields ``(..., b, deg)`` — one
		coefficient set per family member, all from this single sweep.
		"""
		a = out.alphas.T  # (b, deg)
		e = out.betas[: self._deg - 1].T  # (b, deg-1)
		rw, Y = eigh_tridiag(a, e)  # (b, deg), (b, deg, deg)
		w = self.fun(rw) * Y[:, 0, :]  # f(θ) ∘ Y[0,:], broadcast over stack axes
		# precision: deg-length contraction of the spectral coefficients — a
		# reduced-precision default (TF32 on the GPU) costs digits of f(A)v.
		return jnp.einsum("bij,...bj->...bi", Y, w, precision=jax.lax.Precision.HIGHEST)

	def _matmat(self, X: jnp.ndarray) -> jnp.ndarray:
		X = jnp.asarray(X, dtype=self.dtype)
		x_norm = jnp.linalg.norm(X, axis=0)  # (b,)
		if self._use_two_pass(X.shape[1]):
			# Pass 1: coefficients only (no basis); pass 2: re-run the same
			# deterministic recurrence accumulating y = Σ c_t q_t.
			out = self._lanczos(X, ncv=max(2, min(self._orth, self._deg)), return_basis=False)
			c = self._coeffs(out)
			out2 = self._lanczos(
				X, ncv=max(2, min(self._orth, self._deg)), return_basis=False, coeffs=jnp.moveaxis(c, -1, 0)
			)
			return (x_norm * out2.y).astype(self.dtype)  # (..., n, b)
		out = self._lanczos(X, ncv=self._deg)
		c = self._coeffs(out)
		# out.Q: (deg, n, b) — slot t holds q_t (ncv == deg never wraps).
		# Promote (never downcast): c is real even for complex/Hermitian A,
		# and a bf16 window upcasts to the coefficient dtype for the contraction.
		y_dtype = jnp.promote_types(out.Q.dtype, c.dtype)
		y = jnp.einsum("knb,...bk->...nb", out.Q.astype(y_dtype), c.astype(y_dtype), precision=jax.lax.Precision.HIGHEST)
		return (x_norm * y).astype(self.dtype)

	def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
		v = jnp.asarray(v)
		return self._matmat(v[:, None])[..., 0]  # (n,) — or (nt, n) for stacked f

	def quad(self, x: jnp.ndarray) -> jnp.ndarray:
		"""Batched Lanczos-quadrature estimates of ``diag(xᵀ f(A) x)`` → (b,).

		With a stacked spectral function the whole family is evaluated against
		the same Gauss rules — ONE sweep — and the result is ``(nt, b)``.
		"""
		from ..integrate import spectral_quad_form

		from .sparse import GramOperator

		X = jnp.asarray(x, dtype=self.dtype)
		X = X[:, None] if X.ndim == 1 else X
		Xa = X.astype(jnp.promote_types(X.dtype, jnp.float32))
		if np.dtype(self.dtype).kind == "c":
			# Hermitian operator: quadratic forms x†f(A)x are REAL — return the
			# real dtype so estimator states stay real.
			x_norm_sq = jnp.sum(jnp.abs(Xa) ** 2, axis=0)
			out_dtype = np.finfo(self.dtype).dtype
		else:
			x_norm_sq = jnp.sum(Xa**2, axis=0)
			out_dtype = self.dtype
		if isinstance(self._A, GramOperator):
			# Gram spectra go through Golub-Kahan bidiagonalization of the
			# DATA operator: same matvec budget (one A + one Aᵀ per step), but
			# the recurrence conditions at κ(A) instead of κ(A)² — the squared
			# values only appear in the deg×deg Jacobi matrix BᵀB.
			from ..bidiag import bidiag_jacobi, lanczos_bidiag_op

			# GKL exhausts after min(m, n) steps regardless of the Gram side's
			# dimension — clamp so tall AAᵀ-mode operators don't burn applies
			# on guaranteed-breakdown steps.
			deg = int(min(self._deg, min(self._A.A.shape)))
			out = lanczos_bidiag_op(
				self._A.A, X, deg=deg, orth=min(self._orth, deg), rtol=self._rtol,
				reorth_passes=self._reorth_passes, adjoint=not self._A.transpose_first,
				return_residual=self._quad_rule != "gauss",
			)
			d, e = bidiag_jacobi(out.alphas, out.betas)
			# BᵀB is PSD by construction; eigh can still return −ε Ritz values
			# on rank-deficient data, which would NaN sqrt/log-style functions.
			fun = self.fun
			if self._quad_rule != "gauss":
				# Gauss-Radau/Lobatto on the BᵀB Jacobi: its next coupling is
				# e_deg = α_deg·β_deg (one extra adjoint apply). interval is in
				# σ² units; x0 = 0 is always a valid lower endpoint for PSD.
				beta_end = out.alphas[deg - 1] * out.residual
				nodes, weights = self._modified_rule(d.T, e.T, beta_end)
				vals = jnp.sum(fun(jnp.maximum(nodes, 0.0)) * weights, axis=-1)
				return (vals * x_norm_sq).astype(out_dtype)
			vals = spectral_quad_form(d.T, e.T, lambda x: fun(jnp.maximum(x, 0.0)))
			return (vals * x_norm_sq).astype(out_dtype)
		ncv = int(np.clip(max(self._orth, 2), 2, self._deg))
		out = self._lanczos(X, ncv=ncv, return_basis=False)  # quadrature needs only (α, β)
		if self._quad_rule != "gauss":
			nodes, weights = self._modified_rule(
				out.alphas.T, out.betas[: self._deg - 1].T, out.betas[self._deg - 1]
			)
			vals = jnp.sum(self.fun(nodes) * weights, axis=-1)
			return (vals * x_norm_sq).astype(out_dtype)
		# Degeneracy-stable custom-JVP quadrature form: same primal as the
		# Golub-Welsch rule, Daleckii–Krein derivative (no eigenvector grads).
		vals = spectral_quad_form(out.alphas.T, out.betas[: self._deg - 1].T, self.fun)
		return (vals * x_norm_sq).astype(out_dtype)

	def tree_flatten(self):
		return (self._A,), (
			self.fun, self._deg, self._orth, self._rtol, self.dtype, self._two_pass,
			self._reorth_passes, self._basis_dtype, self._quad_rule, self._interval, self._fun_scalar,
		)

	@classmethod
	def tree_unflatten(cls, aux, children):
		fun, deg, orth, rtol, dtype, two_pass, reorth_passes, basis_dtype, quad_rule, interval, fun_scalar = aux
		obj = object.__new__(cls)
		obj._A = children[0]
		obj.shape = obj._A.shape
		obj.dtype = dtype
		obj.fun = fun
		obj._fun_scalar = fun_scalar
		obj._deg, obj._orth, obj._rtol = deg, orth, rtol
		obj._two_pass = two_pass
		obj._reorth_passes = reorth_passes
		obj._basis_dtype = basis_dtype
		obj._quad_rule = quad_rule
		obj._interval = interval
		return obj


def matrix_function(A, fun: Union[str, Callable, None] = None, v: Optional[jnp.ndarray] = None, deg: int = 20, **kwargs):
	"""Convenience constructor: the operator ``f(A)``, or ``f(A) v`` if ``v`` given.

	Parity: reference `operators.py:155-161`.
	"""
	M = MatrixFunction(A, fun=fun, deg=deg, **kwargs)
	return M if v is None else M @ jnp.asarray(v)


@jax.tree_util.register_pytree_node_class
class Toeplitz(LinearOperator):
	"""Matrix-free Toeplitz/circulant operator via FFT circulant embedding.

	O(n log n) matvec, O(n) storage; the batched matmat FFTs all probe columns
	at once. Parity: reference `operators.py:165-183`.
	"""

	stack_shape = ()  # plain (N,) apply: estimator wrappers skip their eval_shape probe

	def __init__(self, c: jnp.ndarray, r: Optional[jnp.ndarray] = None, dtype=None):
		self.c = jnp.asarray(c, dtype=dtype)
		self.r = jnp.asarray(c if r is None else r, dtype=dtype)
		assert self.r.shape == self.c.shape, "First row and first column must have the same length."
		n = self.c.shape[0]
		d = jnp.concatenate([self.c, jnp.zeros(1, self.c.dtype), jnp.flip(self.r[1:])])
		# Keep the complex circulant spectrum: the reference drops the imaginary
		# part (`operators.py:176`), which is only valid for symmetric Toeplitz
		# (palindromic embedding). The general case needs the full spectrum.
		self._dfft = jnp.fft.fft(d)
		self.shape = (n, n)
		# result_type(c, r): with a real first column and a complex first row
		# (or vice versa), c.dtype alone would route _matmat through the
		# real-output branch and silently discard the imaginary contribution.
		self.dtype = jnp.result_type(self.c, self.r) if dtype is None else self.c.dtype

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		n = self.shape[0]
		Z = jnp.zeros((2 * n,) + V.shape[1:], V.dtype).at[:n].set(V)
		Y = jnp.fft.ifft(self._dfft[(...,) + (None,) * (V.ndim - 1)] * jnp.fft.fft(Z, axis=0), axis=0)
		out = Y[:n]
		# Real Toeplitz data: the product is real up to fft round-off. Complex
		# (e.g. Hermitian) Toeplitz keeps its genuinely complex values — taking
		# the real part would silently corrupt every downstream estimate.
		if jnp.dtype(self.dtype).kind != "c":
			out = jnp.real(out)
		return out.astype(self.dtype)

	def tree_flatten(self):
		# _dfft is data, not derived state: recomputing it in unflatten would
		# re-trace an FFT into every transformed program (and break on
		# abstract placeholder leaves during jit lowering).
		return (self.c, self.r, self._dfft), (self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.c, obj.r, obj._dfft = children
		obj.shape, obj.dtype = aux
		return obj


@jax.tree_util.register_pytree_node_class
class ScaledOperator(LinearOperator):
	"""``s · (A + t·I)`` — the shift-and-scale used for spectrum normalization."""

	def __init__(self, A, t=0.0, s=1.0):
		self.A = aslinop(A)
		self.t = jnp.asarray(t)
		self.s = jnp.asarray(s)
		self.shape = self.A.shape
		self.dtype = self.A.dtype

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		AV = self.A.matmat(V)
		# Promote rather than truncate: a complex shift/scale of a real operator
		# must not have its imaginary part silently cast away.
		out_dtype = jnp.result_type(AV.dtype, self.t.dtype, self.s.dtype)
		return (self.s * (AV + self.t * V)).astype(out_dtype)

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		# Probe-major shift-and-scale: delegate to A's native (k, n) apply so
		# normalized operators keep the zero-transpose Lanczos/Clenshaw path.
		AV = self.A.matmat_t(Vt)
		out_dtype = jnp.result_type(AV.dtype, self.t.dtype, self.s.dtype)
		return (self.s * (AV + self.t * Vt)).astype(out_dtype)

	def tree_flatten(self):
		return (self.A, self.t, self.s), (self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.A, obj.t, obj.s = children
		obj.shape, obj.dtype = aux
		return obj


def normalize_unit(A, interval: tuple = (-1, 1), deg: int = 64, seed=None) -> ScaledOperator:
	"""Shift/scale ``A`` so its spectrum lands in ``interval`` (default [-1, 1]).

	With α the largest-magnitude eigenvalue (estimated matrix-free by a
	high-orth Lanczos sweep — the reference calls ARPACK ``eigsh``,
	`operators.py:186-193`), the affine map ``s·(A + tI)`` sends [-α, α] onto
	``[a, b]``: s = (b−a)/(2α), t = α(b+a)/(b−a). A 1% safety inflation
	guards the Ritz underestimate. (The reference accepts ``interval`` but
	ignores it — a bug consciously not replicated.)
	"""
	from ..lanczos import rayleigh_ritz

	a_lo, b_hi = interval
	assert b_hi > a_lo, "interval must be increasing"
	op = aslinop(A)
	k = int(min(deg, op.shape[0]))
	rw = rayleigh_ritz(op, deg=k, orth=-1, seed=seed)
	alpha = 1.01 * jnp.max(jnp.abs(rw))
	s = (b_hi - a_lo) / (2.0 * alpha)
	t = alpha * (b_hi + a_lo) / (b_hi - a_lo)
	return ScaledOperator(op, t=t, s=s)
