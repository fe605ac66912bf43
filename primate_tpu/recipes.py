"""High-level spectral-sum recipes: the compositions the reference documents.

Parity: reference `README.md:20` and `docs/src/table.qmd:8-21` — the reference
*documents* these as `hutch(MatrixFunction(A, f))` compositions the user
writes themselves; here they ship as functions, each one fused adaptive
device program. All accept the estimator knobs of :func:`~primate_tpu.hutch`
(``batch``, ``converge``, ``seed``, ``full``, ...).
"""

from functools import lru_cache
from typing import Optional, Union

import numpy as np
import jax
import jax.numpy as jnp

from .operators import MatrixFunction, aslinop
from .special import stacked
from .trace import hutch

__all__ = [
	"bilinear_form",
	"condition_number",
	"deflated_trace",
	"effective_dim",
	"logdet",
	"trace_bounds",
	"trace_inv",
	"estrada_index",
	"heat_kernel_trace",
	"heat_kernel_signature",
	"numrank",
	"eigencount",
	"pagerank",
	"schatten",
	"topk",
	"slogdet",
	"suggest_degree",
	"shifted_trace",
	"tikhonov",
	"suggest_probes",
	"weighted_trace",
]


@lru_cache(maxsize=64)
def _shift_family_cached(f, shifts: tuple):
	return stacked(lambda x, t: f(x + t), np.asarray(shifts))


def _shift_family(f, shifts: tuple):
	"""``stacked(x ↦ f(x + t), shifts)`` memoized on (f, shifts) — see shifted_trace.

	Unhashable callables (objects defining ``__eq__`` without ``__hash__``) skip
	the cache rather than raising; memoization is an optimization, not a contract.
	"""
	try:
		return _shift_family_cached(f, shifts)
	except TypeError:
		return stacked(lambda x, t: f(x + t), np.asarray(shifts))


@lru_cache(maxsize=256)
def _memo_fun(kind: str, *params: float):
	"""Stable-identity spectral closures for the parameterized recipes.

	MatrixFunction carries ``fun`` as STATIC jit data, so a fresh closure per
	call would recompile the whole fused estimator every invocation (seconds
	of XLA compile for identical parameters). Memoizing on the
	(kind, params) tuple gives repeated calls the same callable identity —
	the same fix `_shift_family` applies to shifted_trace.
	"""
	if kind == "window":  # eigencount's smoothstep difference
		from .special import smoothstep

		a, b, w = params
		rise = smoothstep(a=a - w / 2, b=a + w / 2)
		fall = smoothstep(a=b - w / 2, b=b + w / 2)
		return lambda x: rise(x) - fall(x)
	if kind == "logabs":  # slogdet's log|x| with a floor
		return lambda x: jnp.log(jnp.maximum(jnp.abs(x), 1e-30))
	if kind == "effdim":  # x/(x+λ)
		(lam,) = params
		return lambda x: x / (x + lam)
	if kind == "effdim_fam":
		return stacked(lambda x, v: x / (x + v), np.asarray(params))
	if kind == "abspow":  # |x|^p (Schatten)
		(q,) = params
		return lambda x: jnp.abs(x) ** q
	if kind == "abspow_fam":
		return stacked(lambda x, q: jnp.abs(x) ** q, np.asarray(params))
	if kind == "grampow":  # max(x,0)^(p/2) (Schatten via Gram)
		(q,) = params
		return lambda x: jnp.maximum(x, 0.0) ** (q / 2.0)
	if kind == "grampow_fam":
		return stacked(lambda x, q: jnp.maximum(x, 0.0) ** (q / 2.0), np.asarray(params))
	raise KeyError(kind)


def _slq(A, fun, deg: int, orth: int, fun_kwargs: Optional[dict] = None, **est_kwargs):
	M = MatrixFunction(A, fun=fun, deg=deg, orth=orth, **(fun_kwargs or {}))
	return hutch(M, **est_kwargs)


@lru_cache(maxsize=64)
def _cg_solver_fn(rtol: float, maxiter: Optional[int]):
	"""Stable (memoized) ``(op, precond, V) ↦ A⁻¹V`` callable for FunctionOperator."""
	from .solvers import cg

	def solve_block(op, precond, V):
		return cg(op, V, rtol=rtol, maxiter=maxiter, precond=precond)

	return solve_block


def deflated_trace(
	A,
	fun: Union[str, callable, None] = None,
	k: int = 8,
	which: str = "LM",
	deg: int = 20,
	orth: int = 5,
	fill: Optional[float] = None,
	fun_kwargs: Optional[dict] = None,
	eigsh_kwargs: Optional[dict] = None,
	**est_kwargs,
):
	"""Variance-reduced ``tr(f(A))``: exact top-``k`` eigenspace + stochastic rest.

	Computes the ``k`` extremal eigenpairs with :func:`~primate_tpu.eigsh`
	(blocked LOBPCG), takes ``Σ f(λᵢ)`` exactly, and estimates the remainder on
	the projected operator ``P A P + fill·VVᵀ`` (:class:`DeflatedOperator`):

	    tr(f(A)) = Σᵢ f(λᵢ) + tr(f(P A P + fill·VVᵀ)) − k·f(fill).

	For ``fun=None`` (plain trace) the identity ``tr(A) = tr(VᵀAV) + tr(PAP)``
	is *exact for any orthonormal V*; for nonlinear ``f`` the bias is second
	order in the eigensolver residual. Deflation pays off when the spectrum has
	a few dominant outliers — exactly when plain Hutchinson's variance
	(∝ ‖f(A)‖²_F) is worst. ``fill`` defaults to 1.0 for log/inv (where
	``f(0)`` is singular, and ``f(1) = 0``), else 0.0.

	Beyond-reference capability (the reference has no deflation machinery;
	Hutch++ sketch-deflates with random probes — this deflates with *converged
	eigenvectors*, removing the outliers entirely instead of in expectation).
	"""
	from .eigen import eigsh
	from .operators import DeflatedOperator
	from .special import param_callable

	op = aslinop(A)
	w, V = eigsh(op, k=k, which=which, seed=est_kwargs.get("seed"), **(eigsh_kwargs or {}))
	if fill is None:
		fill = 1.0 if fun in ("log", "inv") else 0.0
	f = param_callable(fun, **(fun_kwargs or {})) if isinstance(fun, str) else fun

	defl = DeflatedOperator(op, jnp.asarray(V), fill=fill)
	# Correct by the ACTUAL deflated count: eigsh's degenerate-eigenvalue dedup
	# can return fewer than k pairs, and each filled direction contributes
	# exactly f(fill) to tr(f(deflated)).
	k_act = int(np.asarray(V).shape[1])
	if fun is None:
		exact = float(np.sum(w))
		correction = -float(k_act) * float(fill)
		rest = hutch(defl, **est_kwargs)
	else:
		exact = float(np.sum(f(w)).real)
		# fill is always REAL (a spectral value): evaluate f at the real dtype —
		# a complex-dtype scalar would make float() raise for Hermitian operators.
		from .random import real_dtype as _real_dtype

		correction = -float(k_act) * float(f(jnp.asarray(fill, _real_dtype(defl.dtype))))
		rest = _slq(defl, fun, deg, orth, fun_kwargs=fun_kwargs, **est_kwargs)
	if isinstance(rest, tuple):
		est, result = rest
		result.estimate = exact + est + correction
		result.info["deflated_eigenvalues"] = np.asarray(w)
		return result.estimate, result
	return exact + rest + correction


def logdet(A, deg: int = 20, orth: int = 5, **kwargs):
	"""``log det(A) = tr(log A)`` for SPD ``A`` via stochastic Lanczos quadrature."""
	return _slq(A, "log", deg, orth, **kwargs)


def slogdet(A, deg: int = 30, orth: int = 5, count_deg: int = 30, **kwargs):
	"""``(sign, log|det A|)`` of a symmetric INDEFINITE operator.

	``log|det| = tr(log|A|)`` (Lanczos quadrature of ``log∘abs`` — Gauss nodes
	never sit exactly at 0 for a nonsingular operator, and |θ| keeps the rule
	real), and ``sign = (−1)^{#negative eigenvalues}`` with the negative count
	estimated by :func:`eigencount` over ``[λ_min, 0)``. Matches
	``numpy.linalg.slogdet`` semantics for symmetric input. For SPD operators
	:func:`logdet` is cheaper (skips the eigencount).

	The count is stochastic: it is rounded to the nearest integer, so the sign
	is reliable when the estimator error is ≲ 0.5 — the default criterion's
	tolerance; raise probes (``converge``/``count``) near-singular spectra.
	Beyond-reference capability.
	"""
	from .lanczos import rayleigh_ritz

	op = aslinop(A)
	# Gate the negative-eigenvalue count on the UNPADDED Ritz minimum: Ritz
	# values lie inside the spectrum, so rw_min < 0 certifies indefiniteness,
	# while the padded interval estimate would dip below 0 for any SPD
	# operator with a small λ_min — triggering a pointless stochastic count
	# whose noise could flip the sign of a positive determinant. The SAME
	# sweep supplies the count interval's lower endpoint (no second sweep).
	rw = np.asarray(rayleigh_ritz(op, deg=int(min(32, op.shape[0])), orth=-1, seed=kwargs.get("seed")))
	rw_min = float(rw.min())
	n_neg = 0
	if rw_min < 0:
		pad = 0.03 * max(float(rw.max()) - rw_min, 1e-12) + 1e-12
		n_neg = eigencount(op, (rw_min - pad, 0.0), deg=count_deg, **{k: v for k, v in kwargs.items() if k != "full"})
		n_neg = int(n_neg)
	sign = -1.0 if (n_neg % 2) else 1.0
	est = _slq(op, _memo_fun("logabs"), deg, orth, **kwargs)
	if isinstance(est, tuple):
		val, result = est
		result.info["sign"] = sign
		result.info["n_negative"] = n_neg
		return (sign, float(val)), result
	return sign, float(est)


# Derivative-sign classes for Golub–Meurant bracketing (see trace_bounds):
# each maps f's alternation pattern to which modified rules bound from below/above.
_BOUND_CLASSES = {
	# f^(2n) < 0, f^(2n+1) > 0 on (0, ∞): log, sqrt, x^p with 0<p<1, ...
	"bernstein": {"lower": ("radau_lo", "lobatto"), "upper": ("gauss", "radau_hi")},
	# f^(2n) > 0, f^(2n+1) < 0: inv, exp(−t·x) with t > 0, x^{-p}, ...
	"completely_monotone": {"lower": ("gauss", "radau_hi"), "upper": ("radau_lo", "lobatto")},
	# all derivatives > 0: exp(t·x) with t > 0 (Estrada), cosh, ...
	"absolutely_monotone": {"lower": ("gauss", "radau_lo"), "upper": ("radau_hi", "lobatto")},
}
_BOUND_CLASSES["cm"] = _BOUND_CLASSES["completely_monotone"]
_BOUND_CLASSES["am"] = _BOUND_CLASSES["absolutely_monotone"]


def trace_bounds(
	A,
	fun: Union[str, callable] = "log",
	deg: int = 20,
	orth: int = -1,
	nv: int = 32,
	pdf: str = "rademacher",
	interval: Optional[tuple] = None,
	kind: Optional[str] = None,
	seed=None,
	full: bool = False,
	fun_kwargs: Optional[dict] = None,
):
	r"""Two-sided Golub–Meurant brackets for the SLQ estimate of ``tr(f(A))``.

	For spectral functions whose derivatives have constant sign on the spectral
	interval, the Gauss / Gauss–Radau / Gauss–Lobatto rules of each probe's
	Jacobi matrix bound the quadratic form ``vᵀf(A)v`` from *known sides*
	(Golub & Meurant, *Matrices, Moments and Quadrature*, ch. 6-7):

	  * ``"bernstein"`` (log, sqrt — f′ completely monotone): Radau-at-λmin and
	    Lobatto bound below; Gauss and Radau-at-λmax bound above.
	  * ``"completely_monotone"`` (inv, exp(−tx)): Gauss and Radau-at-λmax
	    below; Radau-at-λmin and Lobatto above.
	  * ``"absolutely_monotone"`` (exp(+tx)): Gauss and Radau-at-λmin below;
	    Radau-at-λmax and Lobatto above.

	All four rules come from the SAME Lanczos sweep — the extra cost over one
	SLQ estimate is two tiny tridiagonal solves and three (deg+1)-sized batched
	eigensolves, no additional operator applications. The brackets control the
	*quadrature bias* per probe exactly (in exact arithmetic); the Monte-Carlo
	spread over probes remains statistical and is reported alongside.

	``interval = (a, b)`` must satisfy ``a ≤ λmin`` and ``b ≥ λmax`` for the
	bracket guarantees (estimated by an inflated Rayleigh-Ritz sweep when
	absent). ``kind`` is inferred for the builtins ("log"/"sqrt" → bernstein;
	"inv" → completely monotone; "exp" → by the sign of ``t``); custom
	callables must pass it explicitly.

	Returns ``(lower, upper)`` — the tightest per-side probe-averaged rules
	(each rule's mean over ``nv`` isotropic probes is itself an unbiased
	trace estimator whose quadrature bias has known sign). With ``full=True``
	returns a dict with every rule's estimate, per-probe arrays, and the
	interval used.

	Beyond-reference capability: the reference documents plain SLQ only; no
	bias-bracketing machinery exists there.
	"""
	from .integrate import lobatto_rule, quadrature, radau_rule
	from .lanczos import lanczos_block_op
	from .random import as_key, sample_isotropic
	from .special import param_callable

	fun_kwargs = fun_kwargs or {}
	if kind is None:
		if fun == "log" or fun == "sqrt":
			kind = "bernstein"
		elif fun == "inv":
			kind = "completely_monotone"
		elif fun == "exp":
			kind = "absolutely_monotone" if fun_kwargs.get("t", 1.0) > 0 else "completely_monotone"
		else:
			raise ValueError(
				"trace_bounds cannot infer the derivative-sign class of a custom function; "
				"pass kind='bernstein' | 'completely_monotone' | 'absolutely_monotone'"
			)
	assert kind in _BOUND_CLASSES, f"Unknown kind {kind!r}"
	f = param_callable(fun, **fun_kwargs) if isinstance(fun, str) else fun

	op = aslinop(A)
	n = op.shape[0]
	deg = int(min(deg, n))
	orth = deg if (orth < 0 or orth > deg) else int(orth)
	if interval is None:
		from .lanczos import rayleigh_ritz

		rw = np.asarray(rayleigh_ritz(op, deg=int(min(32, op.shape[0])), orth=-1, seed=seed))
		lo, hi = float(rw.min()), float(rw.max())
		pad = 0.03 * max(hi - lo, 1e-12) + 1e-12
		a, b = lo - pad, hi + pad
		if kind in ("bernstein", "completely_monotone") and lo > 0 and a <= 0:
			# log/sqrt-class AND inv-class brackets need a POSITIVE lower
			# endpoint: the Radau/Lobatto rules pin a node at `a`, and additive
			# padding can push it ≤ 0 (log blows up; 1/a goes hugely NEGATIVE,
			# silently inverting the completely-monotone upper bound). Pad
			# multiplicatively instead — still ≤ the Ritz minimum, still > 0.
			a = 0.5 * lo
	else:
		a, b = float(interval[0]), float(interval[1])

	key = as_key(seed)
	from .random import real_dtype

	# Hermitian (complex) operators: REAL probes (α/β and all four rule
	# estimates stay real — the bracket logic below is order-based).
	Vr = sample_isotropic(key, (n, int(nv)), pdf=pdf, dtype=real_dtype(op.dtype))
	V = Vr.astype(op.dtype)
	from .operators.sparse import GramOperator

	if isinstance(op, GramOperator):
		# Gram spectra: Golub-Kahan on the DATA operator (κ(A) conditioning,
		# same matvec budget — matching MatrixFunction.quad's dispatch). The
		# Radau coupling of the BᵀB Jacobi is α_deg·β_deg (one extra adjoint).
		from .bidiag import bidiag_jacobi, lanczos_bidiag_op

		deg = int(min(deg, min(op.A.shape)))
		out = lanczos_bidiag_op(
			op.A, V, deg=deg, orth=min(orth, deg), adjoint=not op.transpose_first, return_residual=True
		)
		dj, ej = bidiag_jacobi(out.alphas, out.betas)
		d, e = dj.T, ej.T
		beta_end = out.alphas[deg - 1] * out.residual
	else:
		out = lanczos_block_op(op, V, deg=deg, ncv=max(2, min(max(orth, 2), deg)), orth=orth, return_basis=False)
		d = out.alphas.T  # (nv, deg)
		e = out.betas[: deg - 1].T  # (nv, deg-1)
		beta_end = out.betas[deg - 1]  # (nv,) — the final residual, couples the Radau extension

	acc = real_dtype(jnp.promote_types(op.dtype, jnp.float32))
	norm2 = jnp.sum(jnp.asarray(Vr, acc) ** 2, axis=0)  # (nv,)

	def rule_estimates(nodes, weights):
		return jnp.sum(f(nodes) * weights, axis=-1) * norm2  # per-probe quadratic forms

	th_g, w_g = quadrature(d, e, deg=deg)
	rules = {
		"gauss": rule_estimates(th_g, w_g),
		"radau_lo": rule_estimates(*radau_rule(d, e, beta_end, a)),
		"radau_hi": rule_estimates(*radau_rule(d, e, beta_end, b)),
		"lobatto": rule_estimates(*lobatto_rule(d, e, beta_end, a, b)),
	}
	means = {name: float(jnp.mean(v)) for name, v in rules.items()}
	sides = _BOUND_CLASSES[kind]
	lower = max(means[r] for r in sides["lower"])
	upper = min(means[r] for r in sides["upper"])
	if upper < lower <= upper + 1e-9 * max(1.0, abs(upper)):
		# Fully converged quadrature: all four rules coincide to rounding and
		# fp noise can cross the (width ≈ 0) bracket — collapse it. A crossing
		# beyond rounding noise is NOT collapsed: it signals an invalid
		# spectral interval (a > λmin or b < λmax) and should be visible.
		lower = upper = 0.5 * (lower + upper)
	if not full:
		return lower, upper
	return {
		"lower": lower,
		"upper": upper,
		"kind": kind,
		"interval": (a, b),
		"rules": means,
		"samples": {name: np.asarray(v) for name, v in rules.items()},
		"nv": int(nv),
		# The bracket controls quadrature bias only; the Monte-Carlo spread of
		# the probe sample remains — report it so users can widen the bracket
		# to a (biased ± CLT) interval on tr(f(A)) itself.
		"mc_stderr": float(jnp.std(rules["gauss"], ddof=1) / jnp.sqrt(jnp.asarray(float(nv)))),
	}


def trace_inv(
	A,
	deg: int = 30,
	orth: int = 5,
	method: str = "slq",
	precond=None,
	rtol: float = 1e-6,
	maxiter: Optional[int] = None,
	**kwargs,
):
	"""``tr(A⁻¹)`` — e.g. the GP log-likelihood gradient term.

	``method="slq"`` (default): stochastic Lanczos quadrature with ``1/x`` —
	``deg`` matvecs per probe, bias set by the Krylov degree.
	``method="cg"``: Hutchinson over CG solves ``vᵀ(A⁻¹v)`` — unbiased up to
	the solve tolerance, and with ``precond="nystrom"`` (or ``"jacobi"``, or a
	prebuilt :class:`~primate_tpu.NystromPreconditioner`) the per-probe cost
	drops to the *deflated* condition number, which on outlier-heavy spectra
	(GP kernels) beats any fixed-degree quadrature. Each probe batch is one
	fused while_loop of SpMMs.
	"""
	if method == "slq":
		return _slq(A, "inv", deg, orth, **kwargs)
	assert method == "cg", f"method must be 'slq' or 'cg', got {method!r}"
	from .operators import FunctionOperator
	from .solvers import nystrom_precond

	op = aslinop(A)
	# Resolve string preconditioners ONCE on the host — a bare string would
	# trace the sketch/QR/eigh build into the fused while_loop body and re-run
	# it every probe batch. A prebuilt preconditioner is a pytree capture.
	if precond == "nystrom":
		precond = nystrom_precond(op, seed=kwargs.get("seed"))
	elif precond == "jacobi":
		from .solvers import DiagPreconditioner, _jacobi_weights, _operator_diagonal

		d, d_stochastic = _operator_diagonal(op)
		acc = jnp.promote_types(op.dtype, jnp.float32)
		precond = DiagPreconditioner(_jacobi_weights(d, d_stochastic, acc))
	# (op, precond) ride as pytree CAPTURES under a cached solver fn, so the
	# fused hutch program is keyed on structure — not on a per-call closure
	# that would bake A in as a constant and retrace every call.
	inv_op = FunctionOperator(
		_cg_solver_fn(float(rtol), None if maxiter is None else int(maxiter)),
		shape=op.shape,
		dtype=op.dtype,
		batched=True,
		captures=(op, precond),
	)
	return hutch(inv_op, **kwargs)


def effective_dim(A, lam: Union[float, np.ndarray] = 1.0, deg: int = 30, orth: int = 5, **kwargs):
	"""Effective dimension ``tr(A(A + λI)⁻¹)`` of a PSD operator (ridge/GP
	degrees of freedom; Hastie-Tibshirani-Friedman §7.6, Zhang 2005).

	The capacity curve over a whole regularization grid is the standard
	diagnostic for choosing λ in kernel ridge regression / GP regression —
	and every grid point shares ONE Lanczos sweep per probe batch: the
	spectral family ``f_λ(x) = x/(x+λ)`` is evaluated on function-independent
	Gauss rules (:func:`~primate_tpu.special.stacked`), so an array ``lam``
	returns the whole curve for the operator applications of a single point.

	Beyond-reference capability (composable there as
	``hutch(MatrixFunction(A, lambda x: x/(x+lam)))``, one full run per λ).
	"""

	if np.ndim(lam) > 0:
		return _slq(A, _memo_fun("effdim_fam", *(float(v) for v in np.asarray(lam).ravel())), deg, orth, **kwargs)
	return _slq(A, _memo_fun("effdim", float(lam)), deg, orth, **kwargs)


def condition_number(A, k: int = 1, maxiter: int = 200, seed=None, method: str = "lobpcg", **eigsh_kwargs):
	"""2-norm condition number ``κ(A) = λ_max/λ_min`` of a symmetric PD operator.

	Both spectral ends from :func:`~primate_tpu.eigsh` (``k`` extremal pairs
	each side; the extra pairs guard against the trailing Ritz value still
	drifting). For indefinite operators this is NOT ``κ`` in the ‖·‖₂ sense —
	use ``abs``: κ = σ_max/σ_min requires singular values; this routine raises
	if the smallest computed eigenvalue is ≤ 0.

	Beyond-reference capability (the reference computes `normalize_unit`'s
	single extreme magnitude via ARPACK but ships no conditioning tool).
	"""
	from .eigen import eigsh

	op = aslinop(A)
	w_hi = eigsh(op, k=k, which="LA", maxiter=maxiter, seed=seed, method=method, return_eigenvectors=False, **eigsh_kwargs)
	w_lo = eigsh(op, k=k, which="SA", maxiter=maxiter, seed=seed, method=method, return_eigenvectors=False, **eigsh_kwargs)
	lo, hi = float(np.min(w_lo)), float(np.max(w_hi))
	if lo <= 0:
		raise ValueError(f"condition_number requires a positive-definite operator; smallest eigenvalue ≈ {lo:.3e}")
	return hi / lo


def estrada_index(A, deg: int = 20, orth: int = 5, t: float = 1.0, **kwargs):
	"""Estrada index ``tr(exp(t·A))`` of a graph adjacency/Laplacian operator.

	An array ``t`` evaluates every timepoint from the SAME Lanczos sweeps
	(stacked spectral function) and returns an array of estimates.
	"""
	if np.ndim(t) > 0:
		return _slq(A, stacked("exp", t), deg, orth, **kwargs)
	return _slq(A, "exp", deg, orth, fun_kwargs={"t": t}, **kwargs)


def heat_kernel_trace(A, t: Union[float, np.ndarray] = 1.0, deg: int = 20, orth: int = 5, **kwargs):
	"""``tr(exp(−t·A))`` — the heat trace of a Laplacian at diffusion time t.

	An array ``t`` returns the whole heat-trace curve for the cost (in operator
	applications) of a single timepoint: the Gauss quadrature rules come from
	one Lanczos sweep per probe batch and are function-independent, so only the
	O(deg) node reweighting is per-``t`` (:func:`~primate_tpu.special.stacked`).
	"""
	if np.ndim(t) > 0:
		return _slq(A, stacked("exp", -np.asarray(t)), deg, orth, **kwargs)
	return _slq(A, "exp", deg, orth, fun_kwargs={"t": -t}, **kwargs)


def heat_kernel_signature(A, timepoints, deg: int = 20, orth: int = 5, **kwargs):
	"""Heat-kernel signature: ``diag(exp(−t·A))`` for each ``t`` in ``timepoints``.

	All timepoints share ONE fused diag program and ONE Lanczos sweep per
	probe (the Krylov subspace of ``−t·A`` is that of ``A``; only the O(deg)
	spectral reweighting is per-``t``) — ``nt`` timepoints cost the matvecs of
	one. Returns ``(nt, n)``.
	"""
	from .diagonal import diag

	ts = np.atleast_1d(np.asarray(timepoints, dtype=float))
	M = MatrixFunction(aslinop(A), fun=stacked("exp", -ts), deg=deg, orth=orth)
	out = diag(M, **kwargs)
	if isinstance(out, tuple):  # full=True: reshape the estimate, keep the result
		est, result = out
		return np.asarray(est).reshape(len(ts), -1), result
	return np.asarray(out).reshape(len(ts), -1)


def numrank(A, threshold: float = 1e-6, deg: int = 20, orth: int = 5, **kwargs):
	"""Numerical rank: ``tr(step(A))`` counting eigenvalues above ``threshold``."""
	est = _slq(A, "numrank", deg, orth, fun_kwargs={"threshold": threshold}, **kwargs)
	if isinstance(est, tuple):
		return (round(float(est[0])), *est[1:])
	return round(float(est))


def eigencount(A, interval: tuple, deg: int = 30, orth: int = 5, width: Optional[float] = None, **kwargs):
	"""Number of eigenvalues inside ``interval = (a, b]`` via a smooth window.

	``tr(1_{(a,b]}(A))`` with the indicator realized as a difference of
	cubic smoothsteps of transition ``width`` (default 2% of the interval):
	Gauss quadrature of a discontinuous indicator converges slowly and with
	high variance when eigenvalues sit near the endpoints; the smoothed
	window restores spectral accuracy at a bias ≤ the eigenvalue mass inside
	the two transition bands.
	"""
	a, b = interval
	w = (0.02 * (b - a)) if width is None else float(width)
	window = _memo_fun("window", float(a), float(b), float(w))
	est = _slq(A, window, deg, orth, **kwargs)
	if isinstance(est, tuple):
		return (round(float(est[0])), *est[1:])
	return round(float(est))


def schatten(A, p: Union[float, np.ndarray] = 1.0, deg: int = 20, orth: int = 5, gram: bool = False, **kwargs):
	"""Schatten p-norm ``(Σ σᵢᵖ)^{1/p}``.

	For symmetric PSD ``A`` the singular values are the eigenvalues, so
	``‖A‖ₚᵖ = tr(Aᵖ)``. For rectangular/indefinite data pass ``gram=True``
	with the data matrix: σᵢ(A)ᵖ = λᵢ(AᵀA)^{p/2} without forming the Gram.

	An array ``p`` estimates every norm from the SAME Lanczos sweeps (stacked
	spectral function) and returns an array.
	"""
	multi = np.ndim(p) > 0
	ps = np.atleast_1d(np.asarray(p, dtype=float))
	if gram:
		from .operators import GramOperator

		op = GramOperator(aslinop(A))
		f = _memo_fun("grampow_fam", *(float(q) for q in ps)) if multi else _memo_fun("grampow", float(p))
		est = _slq(op, f, deg, orth, **kwargs)
	else:
		f = _memo_fun("abspow_fam", *(float(q) for q in ps)) if multi else _memo_fun("abspow", float(p))
		est = _slq(A, f, deg, orth, **kwargs)
	root = (lambda v: np.asarray(v) ** (1.0 / ps)) if multi else (lambda v: float(v) ** (1.0 / float(p)))
	if isinstance(est, tuple):
		return (root(est[0]), *est[1:])
	return root(est)


def bilinear_form(
	A,
	U,
	V=None,
	fun: Union[str, callable] = "identity",
	deg: int = 20,
	orth: int = 5,
	fun_kwargs: Optional[dict] = None,
	**mf_kwargs,
):
	"""Bilinear forms ``uᵀ f(A) v`` per column pair (Golub-Meurant).

	The reference exposes only the quadratic form ``vᵀ f(A) v``
	(`operators.py:126-151`); general entries follow from the polarization
	identity computed with the SAME Lanczos-quadrature machinery:

	    uᵀ f(A) v = ¼ [ (u+v)ᵀ f(A) (u+v) − (u−v)ᵀ f(A) (u−v) ].

	This is deterministic (no Monte-Carlo): accuracy is the Gauss-quadrature
	error, spectrally convergent in ``deg``. With ``U = e_i``, ``V = e_j`` it
	evaluates individual entries ``f(A)[i, j]`` — e.g. Green's functions
	``(A − zI)⁻¹[i, j]``, graph communicability ``exp(A)[i, j]``.

	Args:
		A: symmetric operator (anything :func:`aslinop` accepts).
		U: ``(n,)`` or ``(n, k)`` left vectors.
		V: ``(n,)`` or ``(n, k)`` right vectors; ``None`` → quadratic forms
			``diag(Uᵀ f(A) U)`` (one sweep instead of two).
		fun / deg / orth / fun_kwargs / mf_kwargs: forwarded to
			:class:`MatrixFunction` (incl. ``quad_rule=`` for Radau/Lobatto
			signed-bias rules).

	Returns:
		``(k,)`` array — or ``(nt, k)`` for a stacked ``fun`` family.
	"""
	M = MatrixFunction(aslinop(A), fun=fun, deg=deg, orth=orth, **(fun_kwargs or {}), **mf_kwargs)
	U = jnp.asarray(U, dtype=M.dtype)
	single = U.ndim == 1
	U = U[:, None] if single else U
	if V is None:
		out = M.quad(U)
	else:
		V = jnp.asarray(V, dtype=M.dtype)
		V = V[:, None] if V.ndim == 1 else V
		k = U.shape[1]
		if jnp.dtype(M.dtype).kind == "c":
			# Complex Hermitian: the 2-term identity only recovers Re(u†f(A)v)
			# (each quad is real); the imaginary part needs the u ± i·v pair —
			# 4-term polarization, one batched sweep over 4k vectors.
			P = jnp.concatenate([U + V, U - V, U + 1j * V, U - 1j * V], axis=1)
			q = M.quad(P)
			re = (q[..., :k] - q[..., k : 2 * k]) / 4.0
			# q(u+iv) − q(u−iv) = −4·Im(u†Fv) for Hermitian F — note the order.
			im = (q[..., 3 * k :] - q[..., 2 * k : 3 * k]) / 4.0
			out = re + 1j * im
		else:
			# One batched sweep over the 2k polarization vectors.
			P = jnp.concatenate([U + V, U - V], axis=1)
			q = M.quad(P)
			out = (q[..., :k] - q[..., k:]) / 4.0
	out = np.asarray(out)
	return out[..., 0] if single else out


@jax.tree_util.register_pytree_node_class
class _DiagWeights:
	"""diag(w) as a pytree operator (weights are a LEAF, so repeated
	weighted_trace calls with different weights share one compiled program —
	a FunctionOperator closure would be static jit data and retrace)."""

	def __init__(self, w: jnp.ndarray):
		self.w = w
		self.shape = (w.shape[0], w.shape[0])
		self.dtype = w.dtype

	def matmat(self, V):
		return self.w[:, None] * jnp.asarray(V, self.dtype)

	def matvec(self, v):
		return self.w * jnp.asarray(v, self.dtype)

	def tree_flatten(self):
		return (self.w,), None

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.w = children[0]
		obj.shape = (children[0].shape[0],) * 2 if hasattr(children[0], "shape") and children[0].shape else None
		obj.dtype = getattr(children[0], "dtype", None)
		return obj


@jax.tree_util.register_pytree_node_class
class _PairedQuadOperator:
	"""Quad-only operator whose quadratic form is ``vᵀ B f(A) v``.

	``E[vᵀ B f(A) v] = tr(B f(A))`` for isotropic ``v`` — the sampling target
	of :func:`weighted_trace`. Only ``quad`` is meaningful; it is what
	:func:`~primate_tpu.hutch` consumes.
	"""

	def __init__(self, M, B):
		self.M = M
		self.B = B
		self.shape = M.shape
		self.dtype = M.dtype

	def quad(self, V):
		V = jnp.asarray(V, dtype=self.dtype)
		V = V[:, None] if V.ndim == 1 else V
		FV = self.M.matmat(V)  # f(A) V — (n, k) or (nt, n, k) stacked
		BV = self.B.matmat(V)
		# Bra side conjugated (package convention, see operators.quad_form):
		# (Bv)† f(A) v = v† B f(A) v for Hermitian B. Without the conj the
		# complex case estimates tr(Bᵀ f(A)) — and with pdf="phase" probes
		# E[v vᵀ] = 0, so the estimator would converge to 0 regardless of B.
		return jnp.real(jnp.einsum("ij,...ij->...j", jnp.conj(BV), FV))

	def matmat(self, V):
		V = jnp.asarray(V, dtype=self.dtype)
		return self.B.matmat(self.M.matmat(V))

	def matvec(self, v):
		v = jnp.asarray(v, dtype=self.dtype)
		return self.matmat(v[:, None])[..., 0]

	def __matmul__(self, x):
		x = jnp.asarray(x)
		return self.matvec(x) if x.ndim == 1 else self.matmat(x)

	def tree_flatten(self):
		return (self.M, self.B), None

	@classmethod
	def tree_unflatten(cls, aux, children):
		return cls(*children)


def weighted_trace(
	A,
	B,
	fun: Union[str, callable, None] = None,
	deg: int = 20,
	orth: int = 5,
	fun_kwargs: Optional[dict] = None,
	**est_kwargs,
):
	"""Weighted trace ``tr(f(A) · B)`` by paired Girard-Hutchinson sampling.

	Samples ``(Bv)† f(A) v`` with isotropic probes: unbiased for any REAL ``B``
	since ``E[vvᵀ] = I``. For complex probes the bra is conjugated and the real
	part taken (the package's quad-form convention), so the estimator targets
	``Re tr(B† f(A))`` — identical to ``tr(f(A)B)`` when ``B`` is Hermitian, but
	NOT for a complex non-Hermitian ``B`` (its imaginary part is silently
	dropped). Pass Hermitian ``B`` in the complex case. Covers
	Fisher/Gauss-Newton traces, weighted
	diagonal sums (``B`` a vector → ``tr(f(A) diag(w)) = Σ wᵢ f(A)ᵢᵢ``), and
	restricted traces (``B`` a projector). ``f(A)v`` is evaluated by the
	Lanczos two-term approximation (`MatrixFunction.matvec`), so one sample
	costs one Lanczos sweep plus one ``B`` apply.

	``fun=None`` skips the Lanczos sweep entirely: plain ``tr(A B)`` from
	``(Bv)ᵀ(Av)``. Accepts all :func:`~primate_tpu.hutch` estimator knobs.
	"""
	w = np.asarray(B) if not hasattr(B, "shape") else B
	if isinstance(w, (np.ndarray, jnp.ndarray)) and np.ndim(w) == 1:
		opB = _DiagWeights(jnp.asarray(w))  # pytree (weights are DATA): no per-call retrace
	else:
		opB = aslinop(B)
	opA = aslinop(A)
	if fun is not None:
		opA = MatrixFunction(opA, fun=fun, deg=deg, orth=orth, **(fun_kwargs or {}))
	return hutch(_PairedQuadOperator(opA, opB), **est_kwargs)


def suggest_degree(
	A,
	fun: Union[str, callable] = "log",
	rtol: float = 1e-2,
	atol: float = 0.0,
	nv: int = 8,
	deg0: int = 8,
	max_deg: int = 256,
	orth: int = -1,
	pdf: str = "rademacher",
	interval: Optional[tuple] = None,
	kind: Optional[str] = None,
	seed=None,
	fun_kwargs: Optional[dict] = None,
	full: bool = False,
):
	"""Smallest Krylov degree whose quadrature bias is below tolerance.

	"How large should ``deg`` be?" is the one parameter SLQ users must guess
	(the reference documents only a heuristic: `docs/src/guides/
	matrix_functions.qmd:34-38`'s polynomial-approximation bound). This
	answers it by *measurement*: double ``deg`` from ``deg0``, computing the
	Golub-Meurant two-sided bracket (:func:`trace_bounds`) on the SAME ``nv``
	probes each round (same seed → identical Monte-Carlo sample, so the
	bracket width isolates the deterministic quadrature bias), and stop when

	    upper − lower ≤ atol + rtol · |midpoint|.

	Geometric doubling keeps the total matvec cost under twice the final
	sweep's. The returned degree then sizes production runs::

	    deg = pt.recipes.suggest_degree(A, "log", rtol=1e-3)
	    est = pt.recipes.logdet(A, deg=deg)

	Returns the degree (int); with ``full=True`` returns ``(deg, history)``
	where history rows are ``{"deg", "lower", "upper", "gap"}``.
	"""
	n = aslinop(A).shape[0]
	max_deg = int(min(max_deg, n))
	deg = int(min(max(deg0, 2), max_deg))
	history = []
	while True:
		res = trace_bounds(
			A, fun, deg=deg, orth=orth, nv=nv, pdf=pdf, interval=interval,
			kind=kind, seed=seed, full=True, fun_kwargs=fun_kwargs,
		)
		# Reuse the first round's resolved spectral interval: re-estimating it
		# every doubling round repeats an identical 32-step Rayleigh-Ritz sweep
		# (same seed → same interval) — pure wasted operator applications.
		interval = res["interval"]
		lo, hi = float(res["lower"]), float(res["upper"])
		gap = hi - lo
		history.append({"deg": deg, "lower": lo, "upper": hi, "gap": gap})
		mid = 0.5 * (lo + hi)
		if gap <= atol + rtol * abs(mid) or deg >= max_deg:
			break
		deg = min(2 * deg, max_deg)
	return (deg, history) if full else deg


def suggest_probes(
	A=None,
	fun: Union[str, callable, None] = None,
	eps: float = 0.05,
	eta: float = 0.05,
	method: str = "auto",
	pilot: int = 32,
	deg: int = 20,
	orth: int = -1,
	pdf: str = "rademacher",
	seed=None,
	fun_kwargs: Optional[dict] = None,
	full: bool = False,
	conservative: bool = True,
	**kwargs,
):
	"""How many probe vectors for a ``(1 ± eps)``-accurate trace, w.p. ``1 − eta``?

	Companion to :func:`suggest_degree` — the OTHER parameter SLQ users must
	guess. Two answers:

	* ``method="bound"`` — the a-priori worst-case guarantee the reference
	  documents (`docs/src/guides/intro_trace.qmd:253-261`):
	  ``nv ≥ (24/eps²)·log(2/eta)`` Rademacher probes suffice for any PSD
	  ``f(A)``. No matrix needed; wildly conservative in practice.
	* ``method="clt"`` — a *measured* answer: run a ``pilot``-probe estimate,
	  read the sample variance s² and running mean m̂ off its Welford state,
	  and size ``nv = (z_{1−eta/2} · σ̄ / (eps·|m̂|))²`` so the CLT margin of
	  error lands inside ``eps·|m̂|``. Typically orders of magnitude below the
	  bound (the bound must cover the worst operator; the pilot sees *yours*).
	  Because s² from a small pilot is itself noisy, σ̄² defaults to the χ²
	  upper-confidence bound ``s²·(m−1)/χ²_{eta, m−1}`` (the largest true
	  variance consistent with the pilot at level ``1 − eta``) rather than the
	  point estimate — ``nv`` errs conservative instead of optimistic. Pass
	  ``conservative=False`` for the raw point-estimate sizing.

	``method="auto"`` measures when an operator is given, else falls back to
	the bound. ``fun`` wraps ``A`` in a :class:`MatrixFunction` (``deg``,
	``orth``, ``fun_kwargs``) exactly as the trace recipes do; extra kwargs
	reach the pilot :func:`~primate_tpu.hutch` call.

	Returns ``nv`` (int); with ``full=True`` returns ``(nv, info)`` where info
	carries the pilot estimate/variance or the bound's constants::

	    nv = pt.recipes.suggest_probes(A, "log", eps=0.01)  # measured
	    est = pt.recipes.logdet(A, nv=nv)

	(A follow-up run with ``nv`` total probes has expected CI half-width
	``≈ eps·|tr|``; re-measure with a larger pilot if s² is itself noisy.)
	"""
	assert 0 < eps and 0 < eta < 1, "eps must be positive and eta in (0, 1)"
	if method == "auto":
		method = "clt" if A is not None else "bound"
	if method == "bound":
		nv = int(np.ceil((24.0 / eps**2) * np.log(2.0 / eta)))
		return (nv, {"method": "bound", "eps": eps, "eta": eta}) if full else nv
	assert method == "clt", f"Unknown method '{method}' (expected 'bound', 'clt', or 'auto')"
	assert A is not None, "method='clt' sizes probes from a pilot run — an operator is required"

	from .estimators import clt_quantiles

	op = aslinop(A) if not hasattr(A, "quad") else A
	if fun is not None:
		op = MatrixFunction(op, fun=fun, deg=deg, orth=orth, **(fun_kwargs or {}))
	pilot = max(int(pilot), 4)
	_, res = hutch(op, converge="count", count=pilot, batch=pilot, pdf=pdf, seed=seed, full=True, **kwargs)
	est = float(np.asarray(res.estimator.estimate))
	var = float(np.mean(np.diagonal(np.atleast_2d(np.asarray(res.estimator.converged_variance)))))
	var_used = var
	if conservative and var > 0.0 and np.isfinite(var):
		# χ² upper-confidence bound: (m−1)s²/σ² ~ χ²_{m−1}, so with prob 1−eta
		# the true σ² is at most s²·(m−1)/χ²_{eta, m−1}. Sizing from this bound
		# keeps nv valid even when the pilot variance itself is an unlucky draw.
		from scipy.stats import chi2

		var_used = var * (pilot - 1) / float(chi2.ppf(eta, pilot - 1))
	z, _ = clt_quantiles(1.0 - eta)
	target = eps * abs(est)
	if target == 0.0 or not np.isfinite(target):
		nv = pilot  # degenerate pilot (zero/NaN mean): no relative target exists
	else:
		nv = int(np.ceil(z * z * var_used / (target * target)))
	nv = max(nv, pilot)
	info = {"method": "clt", "pilot": pilot, "estimate": est, "variance": var, "variance_bound": var_used, "z": z}
	return (nv, info) if full else nv


def shifted_trace(
	A,
	fun: Union[str, callable] = "log",
	shifts=None,
	deg: int = 20,
	orth: int = 5,
	fun_kwargs: Optional[dict] = None,
	**est_kwargs,
):
	"""``tr(f(A + t·I))`` for EVERY shift ``t`` from one Lanczos sweep per probe.

	Krylov spaces are shift-invariant — ``K(A + tI, v) = K(A, v)`` — so the
	Jacobi matrix of the shifted operator is ``J + tI``: one sweep yields the
	Gauss rule ``(θ + t, τ)`` for the whole shift grid simultaneously. An
	``nt``-point curve costs exactly the operator applications of one point.

	The flagship use is the GP noise-hyperparameter sweep
	``log det(K + σ²I)`` over a σ grid::

	    curve = pt.recipes.shifted_trace(K, "log", shifts=sigmas**2)

	All shifts share the same probes, so the curve is smooth in ``t`` (errors
	are correlated across shifts — finite differences of the curve are far
	more accurate than independent runs would give). For ``fun="log"``/"sqrt",
	``A + t·I`` must stay positive definite over the grid.

	Returns an array of ``len(shifts)`` estimates (plus the
	:class:`EstimatorResult` when ``full=True``). Extra kwargs reach
	:func:`~primate_tpu.hutch`.
	"""
	from .special import param_callable

	assert shifts is not None, "Provide shifts= (an array of t values for tr(f(A + t·I)))"
	f = param_callable(fun, **(fun_kwargs or {})) if isinstance(fun, str) else fun
	# Memoized family: a fresh closure per call would be new static jit data
	# for MatrixFunction, recompiling the fused hutch program on every
	# invocation with identical arguments (param_callable results are cached,
	# so `f` has a stable identity for builtin names).
	fam = _shift_family(f, tuple(float(t) for t in np.atleast_1d(np.asarray(shifts)).ravel()))
	M = MatrixFunction(aslinop(A), fun=fam, deg=deg, orth=orth)
	return hutch(M, **est_kwargs)


def topk(A, k: int = 6, which: str = "LM", return_eigenvectors: bool = False, **eigsh_kwargs):
	"""Rank-``k`` eigenspace projector ``P_A = V V†`` as a matrix-free operator.

	The "topk" entry of the reference's matrix-function table
	(``docs/src/table.qmd:18`` — "custom projection matrix" for dimensionality
	reduction / feature extraction), shipped as a named recipe: the ``k``
	extremal eigenvectors come from :func:`~primate_tpu.eigsh` and the
	projector applies as two skinny GEMMs (never materialized).

	``tr(P_A) = k`` exactly; ``P_A @ x`` is the best rank-``k`` spectral
	approximation of ``x`` in the chosen eigenspace. ``which`` follows eigsh
	("LM"/"LA"/"SA"/"BE"). With ``return_eigenvectors=True`` returns
	``(P, eigenvalues, V)``.
	"""
	from .eigen import eigsh
	from .operators import FunctionOperator

	op = aslinop(A)
	ew, V = eigsh(op, k=k, which=which, **eigsh_kwargs)
	Vj = jnp.asarray(V)
	proj = FunctionOperator(lambda X: Vj @ (jnp.conj(Vj).T @ X), op.shape, dtype=Vj.dtype, batched=True)
	return (proj, ew, Vj) if return_eigenvectors else proj


def tikhonov(
	A,
	B,
	lam: float = 1.0,
	rtol: float = 1e-8,
	maxiter: Optional[int] = None,
	**cg_kwargs,
):
	"""Tikhonov-regularized solve ``x = (A + λI)⁻¹ b`` — the reference table's
	"tikhonov" matrix function (``docs/src/table.qmd:19``) as a named recipe.

	One fused :func:`~primate_tpu.cg` loop on the operator pencil ``A + λI``
	(SPD for any PSD ``A`` and ``λ > 0``); ``B`` may be a vector or an
	``(n, k)`` block — all right-hand sides advance together. Extra kwargs
	(``precond``, ``full``, ...) reach :func:`~primate_tpu.cg`. For the
	regularization CURVE ``tr(A(A+λI)⁻¹)`` over a λ grid see
	:func:`effective_dim`; for ``tr((A+λI)⁻¹)`` see :func:`trace_inv` on the
	shifted pencil.
	"""
	from .solvers import cg

	op = aslinop(A)
	assert lam > 0 or cg_kwargs.get("precond") is not None, "lam must be positive (or supply a preconditioner for an SPD A)"
	return cg(op + float(lam), B, rtol=rtol, maxiter=maxiter, **cg_kwargs)


def pagerank(
	A,
	alpha: float = 0.85,
	v: Optional[jnp.ndarray] = None,
	rtol: float = 1e-8,
	maxiter: Optional[int] = None,
	**cg_kwargs,
):
	"""Resolvent apply ``x = (1−α)·(I − α·A)⁻¹ v`` — PageRank-style centrality.

	The "pagerank" entry of the reference's table (``docs/src/table.qmd:21``,
	"iterative solver"): for a SYMMETRIC normalized adjacency
	``A = D^{-1/2} W D^{-1/2}`` (spectral radius ≤ 1), ``I − αA`` is positive
	definite for ``α < 1`` and one :func:`~primate_tpu.cg` solve on the
	operator pencil replaces the power iteration. ``v`` is the personalization
	vector (uniform ``1/n`` by default); a ``(n, m)`` block of ``v``'s solves
	all ``m`` centralities in one fused CG loop. Extra kwargs (``precond``,
	``full``, ...) reach :func:`~primate_tpu.cg`.
	"""
	from .solvers import cg

	op = aslinop(A)
	n = op.shape[0]
	assert 0.0 < alpha < 1.0, f"alpha must lie in (0, 1); got {alpha}"
	if v is None:
		v = jnp.full((n,), 1.0 / n, dtype=jnp.promote_types(op.dtype, jnp.float32))
	# I − α·A as an operator pencil via the algebra (ScaledOperator + shift).
	M = (op * (-float(alpha))) + 1.0
	x = cg(M, jnp.asarray(v), rtol=rtol, maxiter=maxiter, **cg_kwargs)
	if isinstance(x, tuple):  # full=True passes through (X, iterations, residuals)
		return ((1.0 - alpha) * x[0],) + x[1:]
	return (1.0 - alpha) * x
