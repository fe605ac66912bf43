"""Linear operator protocol: pytree operators with jittable matvec/matmat/quad.

Parity: reference C++20 concepts ``src/primate/include/linear_operator.h:25-70``
(LinearOperator / AdjointOperator / QuadOperator / SupportsMatrixMult /
AffineOperator), the Eigen wrappers ``include/eigen_operators.h``, and the
Python-callback bridge ``include/pylinop.h``.

Accelerator-first: there is no FFI boundary to bridge — *any jittable callable is an
operator*. The protocol is structural, exactly like the reference's concepts:

  * required: ``.shape`` and one of ``matmat(V)`` / ``matvec(v)`` / ``@``;
  * optional: ``.dtype``, ``.quad(V)`` (used directly by estimators when
    present, mirroring `trace.py:97`), ``.rmatvec`` (adjoint).

Operators are registered **pytrees** (via `register_pytree_node_class`), so
they pass through `jit`/`vmap`/`lax.while_loop` as arguments — changing the
matrix re-uses the compiled estimator program instead of recompiling.
"""

from typing import Any, Callable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
	"LinearOperator",
	"DenseOperator",
	"DeflatedOperator",
	"FunctionOperator",
	"AffineOperator",
	"AdjointOperator",
	"ComposedOperator",
	"aslinop",
	"is_linear_op",
	"is_valid_operator",
	"matmat",
	"quad_form",
]


class LinearOperator:
	"""Base class for matrix-free symmetric(-friendly) operators.

	Subclasses implement ``_matmat(V)`` on an ``(n, k)`` block (the GEMM-shaped
	primitive); ``matvec`` derives from it. ``shape``/``dtype`` are aux data.
	"""

	shape: Tuple[int, int]
	dtype: Any

	# Opt out of numpy's ufunc machinery: without this, `np.eye(n) + op`
	# coerces the operator to a 0-d object array and broadcasts __radd__
	# elementwise — an object-dtype ndarray of operators instead of one
	# AffineOperator. None makes numpy defer to our reflected operators
	# (scipy's LinearOperator does the same).
	__array_ufunc__ = None

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		raise NotImplementedError

	def matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		return self._matmat(jnp.asarray(V))

	def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
		v = jnp.asarray(v)
		return self._matmat(v[:, None])[:, 0]

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		"""Probe-major apply: ``(A Vtᵀ)ᵀ`` on a ``(k, n)`` block.

		Layout detail: with probes on the *leading* axis, the contiguous
		``n`` axis does not depend on the probe count — the Lanczos sweep carries its state probe-major and calls
		this per step. The default derives from ``matmat`` via two transposes;
		operators whose apply is natural in this layout (DIA stencils, dense
		GEMMs) override it with a zero-transpose version.
		"""
		return self._matmat(Vt.T).T

	def rmatvec(self, v: jnp.ndarray) -> jnp.ndarray:
		# Estimation targets are symmetric; subclasses override when not.
		return self.matvec(v)

	def rmatmat(self, V: jnp.ndarray) -> jnp.ndarray:
		"""Adjoint block apply ``A† V`` — ``Aᵀ V`` for real operators
		(vmapped rmatvec fallback)."""
		return jax.vmap(self.rmatvec, in_axes=1, out_axes=1)(V)

	def rmatmat_t(self, Ut: jnp.ndarray) -> jnp.ndarray:
		"""Probe-major adjoint apply ``(A† Utᵀ)ᵀ`` on a ``(k, m)`` block
		(the Golub-Kahan sweep's second hot primitive; see ``matmat_t``)."""
		return self.rmatmat(Ut.T).T

	def __matmul__(self, x):
		# operator @ operator composes (scipy LinearOperator semantics);
		# operator @ array applies.
		if isinstance(x, LinearOperator):
			return ComposedOperator(self, x)
		x = jnp.asarray(x)
		return self.matvec(x) if x.ndim == 1 else self.matmat(x)

	def todense(self) -> jnp.ndarray:
		return self.matmat(jnp.eye(self.shape[1], dtype=self.dtype))

	# -- operator algebra (the scipy LinearOperator surface migrating users
	#    expect: `pylinop.h` wraps scipy operators, which support all of these) --

	def __add__(self, other):
		if _is_scalar(other):  # A + c means A + c·I, matching AffineOperator's pencil
			return AffineOperator(self, None, other)
		return AffineOperator(self, other, 1.0)

	__radd__ = __add__

	def __sub__(self, other):
		if _is_scalar(other):
			return AffineOperator(self, None, -other)
		from .special_ops import ScaledOperator

		return AffineOperator(self, ScaledOperator(other, s=-1.0), 1.0)

	def __rsub__(self, other):  # other − A
		from .special_ops import ScaledOperator

		if _is_scalar(other):  # c·I − A
			return ScaledOperator(self, t=-other, s=-1.0)
		return AffineOperator(other, ScaledOperator(self, s=-1.0), 1.0)

	def __mul__(self, c):
		if not _is_scalar(c):
			return NotImplemented
		from .special_ops import ScaledOperator

		return ScaledOperator(self, s=c)

	__rmul__ = __mul__

	def __truediv__(self, c):
		if not _is_scalar(c):
			return NotImplemented
		from .special_ops import ScaledOperator

		return ScaledOperator(self, s=1.0 / c)

	def __neg__(self):
		from .special_ops import ScaledOperator

		return ScaledOperator(self, s=-1.0)

	@property
	def H(self) -> "LinearOperator":
		"""The adjoint ``A†`` as an operator (applies via ``rmatmat``)."""
		return AdjointOperator(self, transpose=False)

	@property
	def T(self) -> "LinearOperator":
		"""The transpose ``Aᵀ`` (``= A†`` for real operators)."""
		return AdjointOperator(self, transpose=True)


@jax.tree_util.register_pytree_node_class
class DenseOperator(LinearOperator):
	"""Dense matrix operator: matvec/matmat are GEMMs.

	Replaces the reference's ``DenseEigenLinearOperator``
	(`eigen_operators.h:17-55`).
	"""

	stack_shape = ()  # plain (N,) apply: estimator wrappers skip their eval_shape probe

	def __init__(self, A: jnp.ndarray):
		self.A = jnp.asarray(A)
		assert self.A.ndim == 2, "Operator must be two dimensional."
		self.shape = tuple(self.A.shape)
		self.dtype = self.A.dtype

	# precision=HIGHEST on all GEMMs: the DEFAULT f32 matmul precision may run
	# in a reduced format (TF32 on the GPU, ~3 decimal digits) — operator
	# applies are the library's accuracy contract. bf16-dtype operators are unaffected (single native pass).
	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		return jnp.matmul(self.A, V, precision=jax.lax.Precision.HIGHEST)

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		# (A Vtᵀ)ᵀ — same GEMM, no transposes materialized
		return jnp.matmul(Vt, self.A.T, precision=jax.lax.Precision.HIGHEST)

	def rmatvec(self, v: jnp.ndarray) -> jnp.ndarray:
		# adjoint A† (= Aᵀ for real; conj is a no-op then)
		return jnp.matmul(jnp.conj(self.A).T, v, precision=jax.lax.Precision.HIGHEST)

	def rmatmat(self, V: jnp.ndarray) -> jnp.ndarray:
		return jnp.matmul(jnp.conj(self.A).T, V, precision=jax.lax.Precision.HIGHEST)

	def rmatmat_t(self, Ut: jnp.ndarray) -> jnp.ndarray:
		# (A† Utᵀ)ᵀ — one GEMM, no transposes materialized
		return jnp.matmul(Ut, jnp.conj(self.A), precision=jax.lax.Precision.HIGHEST)

	def todense(self) -> jnp.ndarray:
		return self.A

	def tree_flatten(self):
		return (self.A,), (self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		# Rebuild without touching the leaf: unflatten must accept abstract
		# placeholders (jit lowering, tree_map), so no jnp.asarray / attribute
		# reads on children here.
		obj = object.__new__(cls)
		obj.A = children[0]
		obj.shape, obj.dtype = aux
		return obj


@jax.tree_util.register_pytree_node_class
class FunctionOperator(LinearOperator):
	"""Wrap an arbitrary callable ``V ↦ A V`` as an operator.

	Replaces the reference's ``PyLinearOperator`` callback bridge
	(`pylinop.h:16-73`) — with no FFI boundary, the callable simply traces into
	the estimator program. The callable must accept ``(n, k)`` blocks (pass
	``batched=False`` to lift a single-vector matvec via `vmap`).

	``traceable=False`` is the escape hatch for host-only callables (numpy,
	C extensions, IO): the apply routes through :func:`jax.pure_callback`, so
	the operator still composes with the fused jitted estimator programs — the
	device program pauses at each apply, ships ``V`` to the host, and resumes
	with the result (the device analog of the reference's per-matvec C++→Python
	round trip, `pylinop.h:32-40`). The callable must be pure and is handed
	numpy arrays.
	"""

	def __init__(
		self,
		fn: Callable,
		shape: Tuple[int, int],
		dtype=None,
		batched: bool = True,
		captures: tuple = (),
		traceable: bool = True,
	):
		self.fn = fn
		self.shape = tuple(shape)
		# Canonicalize so a host callable advertising float64 (every scipy
		# LinearOperator) still yields a legal pure_callback result spec when
		# jax_enable_x64 is off — 64-bit ShapeDtypeStructs are rejected there.
		self.dtype = jnp.dtype(jax.dtypes.canonicalize_dtype(dtype)) if dtype is not None else jnp.asarray(0.0).dtype
		self.batched = batched
		self.traceable = traceable
		self.captures = tuple(captures)  # pytree leaves the callable closes over

	def _apply_fn(self, V: jnp.ndarray) -> jnp.ndarray:
		if self.batched:
			return self.fn(V) if not self.captures else self.fn(*self.captures, V)
		f = (lambda v: self.fn(v)) if not self.captures else (lambda v: self.fn(*self.captures, v))
		return jax.vmap(f, in_axes=1, out_axes=1)(V)

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		if self.traceable:
			return self._apply_fn(V)
		out_spec = jax.ShapeDtypeStruct((self.shape[0], V.shape[1]), self.dtype)

		def _host(*args):
			*caps, Vh = (np.asarray(a) for a in args)
			if self.batched:
				out = self.fn(*caps, Vh)
			else:
				out = np.stack([self.fn(*caps, Vh[:, j]) for j in range(Vh.shape[1])], axis=1)
			return np.asarray(out, dtype=self.dtype.name).reshape(out_spec.shape)

		return jax.pure_callback(_host, out_spec, *self.captures, V, vmap_method="sequential")

	def tree_flatten(self):
		return self.captures, (self.fn, self.shape, self.dtype, self.batched, self.traceable)

	@classmethod
	def tree_unflatten(cls, aux, children):
		fn, shape, dtype, batched, traceable = aux
		return cls(fn, shape, dtype=dtype, batched=batched, captures=tuple(children), traceable=traceable)


@jax.tree_util.register_pytree_node_class
class AffineOperator(LinearOperator):
	"""Parameterized pencil ``A + t·B`` (B defaults to identity).

	Replaces the reference's ``SparseEigenAffineOperator``
	(`eigen_operators.h:106-137`); ``set_parameter`` returns a *new* operator
	(functional update — the pytree leaf ``t`` can be a traced scalar, so a
	whole family of shifted operators shares one compiled program).
	"""

	def __init__(self, A, B=None, t: float = 0.0):
		self.A = aslinop(A)
		self.B = aslinop(B) if B is not None else None
		self.t = jnp.asarray(t)
		self.shape = self.A.shape
		self.dtype = self.A.dtype

	def set_parameter(self, t) -> "AffineOperator":
		return AffineOperator(self.A, self.B, t)

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		AV = self.A.matmat(V)
		BV = V if self.B is None else self.B.matmat(V)
		# Promote, never truncate: a complex shift of a real operator must not
		# have t's imaginary part silently cast to zero.
		out = jnp.result_type(AV.dtype, self.t.dtype)
		return AV.astype(out) + self.t.astype(out) * BV.astype(out)

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		AV = self.A.matmat_t(Vt)
		BV = Vt if self.B is None else self.B.matmat_t(Vt)
		out = jnp.result_type(AV.dtype, self.t.dtype)
		return AV.astype(out) + self.t.astype(out) * BV.astype(out)

	def tree_flatten(self):
		return (self.A, self.B, self.t), (self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.A, obj.B, obj.t = children
		obj.shape, obj.dtype = aux
		return obj


def _is_scalar(x) -> bool:
	return isinstance(x, (int, float, complex, np.number)) or (
		isinstance(x, (np.ndarray, jnp.ndarray)) and getattr(x, "ndim", None) == 0
	)


@jax.tree_util.register_pytree_node_class
class ComposedOperator(LinearOperator):
	"""Operator product ``A @ B`` (applies right-to-left, never materialized).

	The scipy-LinearOperator composition surface for implicit operators:
	``(A @ B).matvec(v) = A(B v)``; adjoints compose in reverse. Note the
	product of two symmetric operators is NOT symmetric in general — compose
	symmetrically (e.g. ``B.H @ A @ B``) before handing to the symmetric
	estimators.
	"""

	def __init__(self, A, B):
		A, B = aslinop(A), aslinop(B)
		assert A.shape[1] == B.shape[0], f"Composition shape mismatch: {A.shape} @ {B.shape}"
		self.A, self.B = A, B
		self.shape = (A.shape[0], B.shape[1])
		self.dtype = jnp.promote_types(A.dtype, B.dtype)

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		return self.A.matmat(self.B.matmat(V))

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		return self.A.matmat_t(self.B.matmat_t(Vt))

	def rmatvec(self, v: jnp.ndarray) -> jnp.ndarray:
		return self.B.rmatvec(self.A.rmatvec(v))

	def rmatmat(self, V: jnp.ndarray) -> jnp.ndarray:
		return self.B.rmatmat(self.A.rmatmat(V))

	def rmatmat_t(self, Ut: jnp.ndarray) -> jnp.ndarray:
		return self.B.rmatmat_t(self.A.rmatmat_t(Ut))

	def tree_flatten(self):
		return (self.A, self.B), (self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.A, obj.B = children
		obj.shape, obj.dtype = aux
		return obj


@jax.tree_util.register_pytree_node_class
class AdjointOperator(LinearOperator):
	"""``A†`` (``transpose=False``) or ``Aᵀ`` (``transpose=True``) as an operator.

	Backed by the base operator's ``rmatmat``; for real operators the two
	coincide. ``Aᵀ = conj(A† · conj(·))`` handles the complex transpose.
	"""

	def __init__(self, base, transpose: bool = False):
		self.base = aslinop(base)
		self.transpose = bool(transpose)
		self.shape = (self.base.shape[1], self.base.shape[0])
		self.dtype = self.base.dtype

	def _plain_transpose(self) -> bool:
		return self.transpose and jnp.dtype(self.dtype).kind == "c"

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		if self._plain_transpose():
			return jnp.conj(self.base.rmatmat(jnp.conj(V)))
		return self.base.rmatmat(V)

	def rmatvec(self, v: jnp.ndarray) -> jnp.ndarray:
		if self._plain_transpose():
			return jnp.conj(self.base.matvec(jnp.conj(v)))
		return self.base.matvec(v)

	def rmatmat(self, V: jnp.ndarray) -> jnp.ndarray:
		if self._plain_transpose():
			return jnp.conj(self.base.matmat(jnp.conj(V)))
		return self.base.matmat(V)

	@property
	def H(self) -> LinearOperator:
		return self.base if not self.transpose else AdjointOperator(self, transpose=False)

	@property
	def T(self) -> LinearOperator:
		return self.base if self.transpose else AdjointOperator(self, transpose=True)

	def tree_flatten(self):
		return (self.base,), (self.transpose, self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		(obj.base,) = children
		obj.transpose, obj.shape, obj.dtype = aux
		return obj


@jax.tree_util.register_pytree_node_class
class DeflatedOperator(LinearOperator):
	"""Projected operator ``P A P + fill·VVᵀ`` with ``P = I − VVᵀ``.

	``V`` (n×k, orthonormal columns) spans a subspace to remove from ``A`` —
	typically the extremal eigenvectors from :func:`~primate_tpu.eigsh`. The
	deflated directions are re-filled with the benign eigenvalue ``fill`` (pick
	one where downstream ``f`` is finite: 1.0 for log/inv, 0.0 for trace), so
	``spec(op) = {fill}×k ∪ (spec(A) ∖ deflated)`` when V is A-invariant.

	Variance reduction for stochastic estimators: ``tr(A) = tr(VᵀAV) +
	tr(P A P)`` holds *exactly* for any orthonormal V (``VᵀP = 0``), so spiky
	spectra stop dominating the Monte-Carlo variance. No reference analog
	(the reference has no deflation machinery); composes with every estimator
	and with :class:`MatrixFunction` — see :func:`primate_tpu.recipes.deflated_trace`.
	"""

	def __init__(self, A, V: jnp.ndarray, fill: float = 0.0):
		self.A = aslinop(A)
		self.V = jnp.asarray(V, self.A.dtype)
		assert self.V.ndim == 2 and self.V.shape[0] == self.A.shape[0], "V must be (n, k)."
		self.fill = jnp.asarray(fill, self.A.dtype)
		self.shape = self.A.shape
		self.dtype = self.A.dtype

	def _project(self, W: jnp.ndarray) -> jnp.ndarray:
		# P = I − VV† (conj no-op when real); full-precision skinny GEMMs —
		# bf16-truncated projections leak deflated outliers back at ~1e-3.
		hp = jax.lax.Precision.HIGHEST
		return W - jnp.matmul(self.V, jnp.matmul(jnp.conj(self.V).T, W, precision=hp), precision=hp)

	def _matmat(self, W: jnp.ndarray) -> jnp.ndarray:
		PW = self._project(W)
		out = self._project(self.A.matmat(PW))
		return out + self.fill * (self.V @ (jnp.conj(self.V).T @ W))

	def matmat_t(self, Wt: jnp.ndarray) -> jnp.ndarray:
		# Row-major probes: (VV†w)ᵀ = wᵀ·conj(V)·Vᵀ, so the right factor keeps
		# the plain transpose and the LEFT one conjugates.
		Vc = jnp.conj(self.V)
		C = Wt @ Vc  # (k_probes, k)
		PWt = Wt - C @ self.V.T
		APWt = self.A.matmat_t(PWt)
		out = APWt - (APWt @ Vc) @ self.V.T
		return out + self.fill * (C @ self.V.T)

	def tree_flatten(self):
		return (self.A, self.V, self.fill), (self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.A, obj.V, obj.fill = children
		obj.shape, obj.dtype = aux
		return obj


def is_linear_op(A: Any) -> bool:
	"""Structural check: square, 2-d, with some way to apply it to a vector."""
	has_apply = any(hasattr(A, a) for a in ("__matmul__", "matmul", "dot", "matvec", "matmat"))
	ok = has_apply and hasattr(A, "shape") and len(A.shape) >= 2
	return bool(ok and A.shape[0] == A.shape[1])


def is_valid_operator(A: Any) -> jnp.dtype:
	"""Assert the operator protocol and return its element dtype.

	Parity: reference `operators.py:15-23` (the reference restricts to
	f32/f64; here bf16 is additionally allowed — it is a native tensor-core dtype).
	"""
	assert any(hasattr(A, a) for a in ("__matmul__", "matmul", "dot", "matvec", "matmat")), (
		"Invalid operator; must have an overloaded 'matvec' or 'matmul' method"
	)
	assert hasattr(A, "shape") and len(A.shape) >= 2, "Operator must be at least two dimensional."
	assert A.shape[0] == A.shape[1], "This function only works with square, symmetric matrices!"
	f_dtype = jnp.dtype(A.dtype) if hasattr(A, "dtype") else jnp.asarray(A @ jnp.zeros(A.shape[1])).dtype
	valid = (jnp.float32, jnp.float64, jnp.bfloat16, jnp.complex64, jnp.complex128)
	assert f_dtype in tuple(jnp.dtype(d) for d in valid), (
		"Only bfloat16, 32-/64-bit floats, and 64-/128-bit complex (Hermitian) are supported."
	)
	return f_dtype


def aslinop(A: Any, dtype=None) -> LinearOperator:
	"""Coerce arrays / scipy matrices / protocol objects into a LinearOperator."""
	if isinstance(A, LinearOperator):
		return A
	if isinstance(A, (jnp.ndarray, np.ndarray)):
		A = jnp.asarray(A, dtype=dtype)
		return DenseOperator(A)
	# scipy sparse matrices convert to the native sparse pytree operators.
	try:
		import scipy.sparse as sps

		if sps.issparse(A):
			from .sparse import CSROperator

			return CSROperator.from_scipy(A, dtype=dtype)
		# scipy LinearOperators compute on host numpy by construction — route
		# their applies through the pure_callback bridge so they still compose
		# with the fused device programs (reference analog: PyLinearOperator).
		import scipy.sparse.linalg as spsla

		if isinstance(A, spsla.LinearOperator):
			n, m = A.shape
			dt = dtype or getattr(A, "dtype", None) or jnp.float64
			return FunctionOperator(lambda V: A.matmat(V), (n, m), dtype=dt, batched=True, traceable=False)
	except ImportError:  # pragma: no cover
		pass
	if is_linear_op(A):
		n, m = A.shape[0], A.shape[1]
		dt = dtype or getattr(A, "dtype", None)  # explicit request wins
		# Dispatch in capability order — every apply-method is honored (the
		# is_linear_op contract lists matmat/__matmul__/dot/matvec).
		if hasattr(A, "matmat"):
			return FunctionOperator(lambda V: A.matmat(V), (n, m), dtype=dt, batched=True)
		if hasattr(A, "__matmul__"):
			return FunctionOperator(lambda V: A @ V, (n, m), dtype=dt, batched=True)
		if hasattr(A, "matmul"):
			return FunctionOperator(lambda V: A.matmul(V), (n, m), dtype=dt, batched=True)
		if hasattr(A, "dot"):
			return FunctionOperator(lambda V: A.dot(V), (n, m), dtype=dt, batched=True)
		return FunctionOperator(lambda v: A.matvec(v), (n, m), dtype=dt, batched=False)
	raise TypeError(f"Cannot interpret {type(A)} as a linear operator")


def matmat(A: Any, V: jnp.ndarray) -> jnp.ndarray:
	"""Apply any operator-like to an (n, k) block."""
	return aslinop(A).matmat(V)


def quad_form(A: Any, V: jnp.ndarray) -> jnp.ndarray:
	"""Batched quadratic forms ``diag(Vᵀ A V)`` → shape (k,).

	Dispatches to ``A.quad`` when available (e.g. MatrixFunction uses Lanczos
	quadrature, which is computationally distinct from ``Vᵀ(AV)``; see
	reference `trace.py:97`).
	"""
	if hasattr(A, "quad"):
		return jnp.atleast_1d(A.quad(V))
	op = aslinop(A)
	V = jnp.asarray(V, dtype=op.dtype)
	V = V[:, None] if V.ndim == 1 else V
	if jnp.dtype(op.dtype).kind == "c":
		# Hermitian operator: v†Av is real — conjugate the bra, return real.
		return jnp.real(jnp.einsum("ij,ij->j", jnp.conj(V), op.matmat(V)))
	return jnp.einsum("ij,ij->j", V, op.matmat(V))
