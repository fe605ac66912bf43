"""Chebyshev / Kernel Polynomial Method (KPM): moment-based spectral sums.

Beyond-reference capability (the reference is Lanczos-only): the KPM expands
``tr(f(A))`` and the spectral density in Chebyshev moments

	μ_m = (1/nv) Σ_v vᵀ T_m(Ã) v,   Ã = (A − c·I)/r with spectrum in [-1, 1],

computed by the three-term recurrence ``T_{m+1} = 2Ã T_m − T_{m-1}`` — one
operator application per moment on the whole probe block, no
eigendecompositions and no orthogonalization at all. Jackson damping kills
Gibbs oscillations. Complements SLQ: cheaper per step (no reorth window),
deterministic degree/accuracy trade-off via Chebyshev coefficients, and the
natural choice when ``f`` is smooth on the whole spectral interval.

Accelerator shape: the moment recurrence is a `lax.scan` carrying two (n, nv)
blocks; all nv probes and all moments stream through the device together.
"""

from functools import partial
from typing import Callable, Optional, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .operators import aslinop
from .random import as_key, real_dtype, sample_isotropic
from .special import param_callable

__all__ = [
	"chebyshev_moments",
	"kpm_trace",
	"kpm_density",
	"jackson_coefficients",
	"suggest_chebyshev_degree",
	"ChebyshevFunction",
]


def jackson_coefficients(m: int) -> jnp.ndarray:
	"""Jackson damping factors g_0..g_{m-1} (optimal positive KPM kernel)."""
	k = jnp.arange(m)
	M = m + 1.0
	return ((M - k) * jnp.cos(jnp.pi * k / M) + jnp.sin(jnp.pi * k / M) / jnp.tan(jnp.pi / M)) / M


@partial(jax.jit, static_argnames=("m",))
def _moment_scan(op, V: jnp.ndarray, m: int, c, r) -> jnp.ndarray:
	"""Per-probe moments μ_j^(v) = vᵀ T_j(Ã) v for j < m → (m, nv).

	``op`` is a pytree argument, so the compiled recurrence re-runs for any
	same-shaped operator without retracing. The recurrence carries its two
	block vectors probe-major — (nv, n), contiguous n on vector lanes — so the
	default nv=16..32 probe blocks stream without tile padding.
	"""
	acc = jnp.promote_types(V.dtype, jnp.float32)
	Vt = V.T
	mm_t = getattr(op, "matmat_t", None)

	def apply_scaled(Xt):
		AX = mm_t(Xt) if mm_t is not None else op.matmat(Xt.T).T
		return ((AX.astype(Xt.dtype) - c * Xt) / r).astype(Xt.dtype)

	# Hermitian (complex) operators: moments v†T_j(Ã)v are REAL — conjugate the
	# bra and keep only the real part (both identities on the real path).
	Vc = jnp.conj(Vt.astype(acc))
	moment = lambda Tn: jnp.real(jnp.sum(Vc * Tn.astype(acc), axis=1))  # noqa: E731

	T0 = Vt
	T1 = apply_scaled(Vt)
	mu0 = moment(T0)
	mu1 = moment(T1)

	def step(carry, _):
		Tm1, Tm = carry
		Tn = 2.0 * apply_scaled(Tm) - Tm1
		return (Tm, Tn), moment(Tn)

	if m <= 2:
		return jnp.stack([mu0, mu1][:m])
	(_, _), mus = lax.scan(step, (T0, T1), None, length=m - 2)
	return jnp.concatenate([jnp.stack([mu0, mu1]), mus], axis=0)


def _spectral_interval(op, seed) -> Tuple[float, float]:
	"""Safe [λmin, λmax] bracket from a Rayleigh-Ritz sweep (+3% inflation)."""
	from .lanczos import rayleigh_ritz

	k = int(min(32, op.shape[0]))
	rw = np.asarray(rayleigh_ritz(op, deg=k, orth=-1, seed=seed))
	lo, hi = float(rw.min()), float(rw.max())
	pad = 0.03 * max(hi - lo, 1e-12) + 1e-12
	return lo - pad, hi + pad


def _resolve_interval(op, interval, seed) -> Tuple[float, float]:
	"""``None`` → Rayleigh-Ritz sweep (tight, probabilistic); ``"gershgorin"``
	→ deterministic Gershgorin enclosure (guaranteed to contain the spectrum —
	an eigenvalue outside the mapped [−1, 1] makes the Chebyshev recurrence
	diverge, so entry-accessible operators can pay a looser interval for
	safety); anything else is taken as an explicit ``(lo, hi)``."""
	if interval is None:
		return _spectral_interval(op, seed)
	if isinstance(interval, str):
		assert interval == "gershgorin", f"Unknown interval spec {interval!r}"
		from .operators.prepare import gershgorin_interval

		return gershgorin_interval(op)
	return float(interval[0]), float(interval[1])


def chebyshev_moments(
	A,
	m: int = 64,
	nv: int = 16,
	pdf: str = "rademacher",
	interval: Optional[Tuple[float, float]] = None,
	seed=None,
) -> Tuple[np.ndarray, Tuple[float, float]]:
	"""Estimate the first ``m`` Chebyshev trace moments ``tr(T_j(Ã))``.

	Returns ``(moments (m,), (lmin, lmax))`` — moments are averaged over
	``nv`` isotropic probes and NOT Jackson-damped (damping belongs to the
	reconstruction step).
	"""
	op = aslinop(A)
	interval = _resolve_interval(op, interval, seed)
	lo, hi = interval
	c, r = (hi + lo) / 2.0, (hi - lo) / 2.0
	return np.asarray(_traced_moments(op, m, nv, pdf, c, r, seed)), (lo, hi)


def _traced_moments(op, m, nv, pdf, c, r, seed) -> jnp.ndarray:
	"""Probe-averaged Chebyshev moments as a traced array (shared by the host
	path above and ``kpm_trace(differentiable=True)``)."""
	key = as_key(seed)
	s_dtype = op.dtype if pdf == "phase" else real_dtype(op.dtype)
	V = sample_isotropic(key, (op.shape[0], int(nv)), pdf=pdf, dtype=s_dtype).astype(op.dtype)
	rd = real_dtype(V.dtype)
	return jnp.mean(_moment_scan(op, V, int(m), jnp.asarray(c, rd), jnp.asarray(r, rd)), axis=1)


def _series_weights(fs, m: int, c: float, r: float, damping: str) -> tuple:
	"""``(a, g)``: per-function Chebyshev coefficients (nt, m) and damping (m,)
	— host numpy, identical for the traced and host reconstruction paths."""
	a = np.concatenate([np.atleast_2d(_chebyshev_coefficients(f, m, c, r)) for f in fs])
	g = np.asarray(jackson_coefficients(m)) if damping == "jackson" else np.ones(m)
	return a, g


def _chebyshev_coefficients(fun: Callable, m: int, c: float, r: float, quad_points: int = 4096) -> np.ndarray:
	"""Chebyshev expansion coefficients of f on [c-r, c+r] (Gauss-Chebyshev)."""
	k = np.arange(quad_points)
	x = np.cos(np.pi * (k + 0.5) / quad_points)  # Chebyshev nodes in (-1, 1)
	fx = np.asarray(fun(jnp.asarray(c + r * x)))  # (qp,) — or (nt..., qp) stacked
	j = np.arange(m)[:, None]
	Tjx = np.cos(j * np.arccos(x)[None, :])
	coeff = 2.0 / quad_points * np.einsum("jq,...q->...j", Tjx, fx)
	coeff[..., 0] /= 2.0
	return coeff


def suggest_chebyshev_degree(
	fun: Union[str, Callable],
	interval: Tuple[float, float],
	rtol: float = 1e-8,
	max_deg: int = 2048,
	damping: str = "none",
	**fun_kwargs,
) -> int:
	"""Smallest Chebyshev degree resolving ``fun`` on ``interval`` to ``rtol``.

	The Chebyshev-path companion of :func:`~primate_tpu.recipes.suggest_degree`
	(which sizes the Lanczos path by quadrature brackets). Here no operator is
	needed at all: expand ``fun`` to ``max_deg`` coefficients on the interval
	and truncate where the coefficient envelope falls below
	``rtol · max|a_j|`` — the standard chebfun-style rule; for f analytic on
	the interval the coefficients decay geometrically, so the returned degree
	grows only logarithmically in ``1/rtol``.

	Use the operator's spectral interval (e.g. from
	:func:`~primate_tpu.operators.normalize_unit`'s Krylov estimate, or domain
	knowledge)::

	    m = suggest_chebyshev_degree("exp", (lo, hi), rtol=1e-6)
	    est = kpm_trace(A, "exp", m=m, interval=(lo, hi))

	or pass ``deg="auto"`` to :class:`ChebyshevFunction` / ``m="auto"`` to
	:func:`kpm_trace`, which call this with their resolved interval.
	"""
	f = param_callable(fun, **fun_kwargs) if (fun is None or isinstance(fun, str)) else fun
	lo, hi = float(interval[0]), float(interval[1])
	c, r = (hi + lo) / 2.0, max((hi - lo) / 2.0, 1e-30)
	a = _chebyshev_coefficients(f, int(max_deg), c, r)
	mag = np.max(np.abs(np.atleast_2d(a)).reshape(-1, a.shape[-1]), axis=0)  # stacked → envelope
	scale = float(mag.max())
	if scale == 0.0 or not np.isfinite(scale):
		return 2
	if damping == "jackson":
		# Jackson's positive kernel biases EVERY retained coefficient, so the
		# truncation envelope alone badly under-sizes damped evaluations (a
		# degree picked for 1e-8 truncation can carry ~1e-2 damping bias).
		# Size against the damped error estimate Σ_{j<m}|a_j|(1−g_j) + Σ_{j≥m}|a_j|
		# over a geometric ladder of candidate degrees; the kernel's O(1/m²)
		# bias floor means very tight rtols may be unreachable — return the
		# best (argmin) degree then.
		tail = np.concatenate([np.cumsum(mag[::-1])[::-1], [0.0]])  # tail[m] = Σ_{j≥m}|a_j|
		best_m, best_err = 2, np.inf
		mcand = sorted({int(v) for v in np.geomspace(2, int(max_deg), 40).round()})
		for m in mcand:
			g = np.asarray(jackson_coefficients(m))
			err = float(np.sum(mag[:m] * (1.0 - g)) + tail[m])
			if err < best_err:
				best_m, best_err = m, err
			if err <= rtol * scale:
				return int(max(2, m))
		return int(max(2, best_m))
	keep = np.nonzero(mag >= rtol * scale)[0]
	return int(max(2, (keep[-1] + 1) if keep.size else 1))


def kpm_trace(
	A,
	fun: Union[str, Callable, None] = None,
	m: Union[int, str] = 64,
	nv: int = 32,
	pdf: str = "rademacher",
	interval: Optional[Tuple[float, float]] = None,
	damping: str = "jackson",
	seed=None,
	**fun_kwargs,
) -> float:
	"""``tr(f(A))`` by the Kernel Polynomial Method.

	``tr(f(A)) ≈ Σ_j g_j a_j μ_j`` with Chebyshev coefficients ``a_j`` of f,
	damping ``g_j`` (``"jackson"`` or ``"none"``), and stochastic moments
	``μ_j``. One matvec per moment, nv probes batched.

	The moments are function-independent, so a SEQUENCE of functions (list /
	tuple of names or callables, e.g. exp(-t·x) over timepoints) re-uses the
	single moment sweep and returns one estimate per member — the KPM analog
	of :func:`~primate_tpu.special.stacked`.

	``differentiable=True`` (explicit ``interval`` and fixed ``m`` required)
	returns the traced value; ``jax.grad`` through the moment scan is the
	exact estimator derivative.
	"""
	# `special.stacked` callables advertise their family size via .nout, so a
	# ONE-member family still returns a (1,)-array (matching the Lanczos path).
	differentiable = fun_kwargs.pop("differentiable", False)
	multi = isinstance(fun, (list, tuple)) or getattr(fun, "nout", None) is not None
	funs = list(fun) if isinstance(fun, (list, tuple)) else [fun]
	fs = [param_callable(fi, **fun_kwargs) if (fi is None or isinstance(fi, str)) else fi for fi in funs]
	op = aslinop(A)
	if differentiable:
		# Traced path: the Chebyshev moment recurrence is a fixed lax.scan, so
		# jax.grad through it is the exact derivative of the estimator
		# (reverse memory O(m·n·nv) — the scan carries are saved). The
		# expansion interval must be EXPLICIT: it is treated as a constant
		# (the spectral-range estimate is host-side, and differentiating
		# through a moving interval would add a spurious boundary term).
		assert interval is not None, "kpm_trace(differentiable=True) needs an explicit interval=(lmin, lmax)"
		assert m != "auto", "kpm_trace(differentiable=True) needs a fixed Chebyshev degree m"
		lo, hi = float(interval[0]), float(interval[1])
		c, r = (hi + lo) / 2.0, (hi - lo) / 2.0
		mus = _traced_moments(op, m, nv, pdf, c, r, seed)
		# Coefficients depend only on (f, m, interval) — constants. Under an
		# enclosing jit every jnp op is staged as a tracer, so force them to
		# evaluate at trace time (they must stay host-side numpy).
		with jax.ensure_compile_time_eval():
			a, g = _series_weights(fs, m, c, r, damping)
		multi = multi or a.shape[0] > 1
		ests = (jnp.asarray(g * a, mus.dtype) * mus).sum(axis=-1)
		return ests if multi else ests[0]
	interval = _resolve_interval(op, interval, seed)
	if m == "auto":
		rt = 1e-3 if damping == "jackson" else 1e-8
		m = max(suggest_chebyshev_degree(f, interval, rtol=rt, damping=damping) for f in fs)
	mus, (lo, hi) = chebyshev_moments(op, m=m, nv=nv, pdf=pdf, interval=interval, seed=seed)
	c, r = (hi + lo) / 2.0, (hi - lo) / 2.0
	a, g = _series_weights(fs, m, c, r, damping)  # (nt, m), (m,)
	multi = multi or a.shape[0] > 1  # a `special.stacked` callable is also a family
	ests = (g * a * np.asarray(mus)).sum(axis=-1)
	return ests if multi else float(ests[0])


def kpm_density(
	A,
	grid: Union[int, jnp.ndarray] = 256,
	m: int = 128,
	nv: int = 16,
	pdf: str = "rademacher",
	interval: Optional[Tuple[float, float]] = None,
	seed=None,
) -> Tuple[np.ndarray, np.ndarray]:
	"""KPM spectral density on a grid (Jackson-damped Chebyshev series).

	The classic DOS estimator: φ(t) ≈ (1/(π√(1−x²))) [g₀μ₀ + 2Σ g_j μ_j T_j(x)]
	with x the affinely mapped grid. Complements
	:func:`~primate_tpu.spectral_density` (Gaussian-broadened SLQ).
	"""
	op = aslinop(A)
	interval = _resolve_interval(op, interval, seed)
	mus, (lo, hi) = chebyshev_moments(op, m=m, nv=nv, pdf=pdf, interval=interval, seed=seed)
	c, r = (hi + lo) / 2.0, (hi - lo) / 2.0
	ts = np.linspace(lo, hi, int(grid)) if np.isscalar(grid) else np.asarray(grid)
	# Clamp |x| to cos(π/2m): beyond the expansion's resolution the
	# 1/√(1−x²) factor only amplifies stochastic moment noise into endpoint
	# spikes — bounding it at ~2m/π keeps the amplification at the same
	# order as the kernel's intrinsic broadening.
	xmax = float(np.cos(np.pi / (2 * m)))
	x = np.clip((ts - c) / r, -xmax, xmax)
	g = np.asarray(jackson_coefficients(m))
	j = np.arange(m)[:, None]
	Tjx = np.cos(j * np.arccos(x)[None, :])
	series = g[0] * mus[0] + 2.0 * (g[1:, None] * mus[1:, None] * Tjx[1:]).sum(axis=0)
	n = op.shape[0]
	phi = series / (np.pi * np.sqrt(1.0 - x**2)) / (n * r)  # mass normalized to 1
	return ts, phi


@jax.tree_util.register_pytree_node_class
class ChebyshevFunction:
	"""Implicit ``f(A)`` by Chebyshev expansion — the orthogonalization-free
	complement to :class:`~primate_tpu.MatrixFunction`.

	``matmat`` evaluates the degree-``deg`` Chebyshev approximant of ``f`` on
	the spectral interval via the **Clenshaw recurrence** (two carried blocks,
	one operator application per term, no re-orth window, no eigensolves);
	``quad`` returns per-probe quadratic forms ``vᵀ f(A) v = Σ_j g_j a_j
	(vᵀ T_j(Ã) v)`` from the forward moment recurrence — so
	``hutch(ChebyshevFunction(A, f))`` IS the Kernel Polynomial Method with the
	full adaptive-criterion machinery. Prefer it over Lanczos quadrature when
	``f`` is smooth on the whole interval (exp, smoothstep, polynomials);
	prefer Lanczos when ``f`` has spectrum-edge singularities (log, inv) that
	Gauss quadrature resolves adaptively.

	Both recurrences run probe-major — ``(nv, n)`` blocks through
	``matmat_t`` — so any probe count streams at full lane utilization.

	No reference equivalent (the reference is Lanczos-only; its imate
	comparison table lists Chebyshev methods as the main capability gap,
	`docs/src/imate_compare.qmd`).
	"""

	def __init__(
		self,
		A,
		fun: Union[str, Callable, None] = None,
		deg: Union[int, str] = 64,
		interval: Optional[Tuple[float, float]] = None,
		damping: str = "jackson",
		dtype=None,
		seed=None,
		**fun_kwargs,
	):
		from .operators import aslinop

		self._op = aslinop(A, dtype=dtype)
		self.shape = self._op.shape
		self.dtype = jnp.dtype(dtype) if dtype is not None else self._op.dtype
		self._damping = damping
		interval = _resolve_interval(self._op, interval, seed)
		lo, hi = float(interval[0]), float(interval[1])
		self._interval = (lo, hi)
		c, r = (hi + lo) / 2.0, max((hi - lo) / 2.0, 1e-30)
		# A FAMILY of functions (list/tuple, or a `special.stacked` callable)
		# shares the expansion: the T_j recurrence is f-independent, so only
		# the coefficient rows differ — matmat/quad gain a leading stack axis.
		if isinstance(fun, (list, tuple)):
			fs = [param_callable(fi, **fun_kwargs) if (fi is None or isinstance(fi, str)) else fi for fi in fun]
			if deg == "auto":  # family shares one degree: the largest member needs
				deg = max(suggest_chebyshev_degree(f, (lo, hi)) for f in fs)
			self._deg = int(deg)
			a = np.stack([_chebyshev_coefficients(f, self._deg, c, r) for f in fs])
		else:
			f = param_callable(fun, **fun_kwargs) if (fun is None or isinstance(fun, str)) else fun
			if deg == "auto":
				rt = 1e-3 if damping == "jackson" else 1e-8
				deg = suggest_chebyshev_degree(f, (lo, hi), rtol=rt, damping=damping)
			self._deg = int(deg)
			a = _chebyshev_coefficients(f, self._deg, c, r)  # (m,) — or (nt, m) stacked
		g = np.asarray(jackson_coefficients(self._deg)) if damping == "jackson" else np.ones(self._deg)
		# Damped coefficients are data (pytree leaf): same compiled program for
		# any f/interval at a given degree. They are REAL even for Hermitian
		# (complex) operators — f maps the real spectrum to reals.
		self._ga = jnp.asarray(g * a, real_dtype(jnp.promote_types(self.dtype, jnp.float32)))
		self._c = jnp.asarray(c, self._ga.dtype)
		self._r = jnp.asarray(r, self._ga.dtype)

	@property
	def interval(self) -> Tuple[float, float]:
		return self._interval

	@property
	def stack_shape(self) -> Tuple[int, ...]:
		"""Leading stack axes of `matmat`/`quad` outputs — statically known here
		(the coefficient table fixes the family size), so estimators skip their
		`jax.eval_shape` probe."""
		return (int(self._ga.shape[0]),) if self._ga.ndim > 1 else ()

	def _apply_t(self, Xt: jnp.ndarray) -> jnp.ndarray:
		"""Probe-major shifted apply ``Ã Xᵀ`` with Ã = (A − cI)/r."""
		mm_t = getattr(self._op, "matmat_t", None)
		AX = mm_t(Xt) if mm_t is not None else self._op.matmat(Xt.T).T
		return (AX.astype(Xt.dtype) - self._c.astype(Xt.dtype) * Xt) / self._r.astype(Xt.dtype)

	def matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		"""``f(A) V`` by Clenshaw: b_k = ga_k·V + 2Ã b_{k+1} − b_{k+2}.

		A stacked coefficient family returns ``(nt, n, b)`` — the Clenshaw
		carries gain a leading nt axis (n stays on lanes, probe-major)."""
		V = jnp.asarray(V, self.dtype)
		single = V.ndim == 1
		Vt = (V[:, None] if single else V).T  # (b, n)
		acc = jnp.promote_types(self.dtype, jnp.float32)
		Vt = Vt.astype(acc)
		is_stacked = self._ga.ndim > 1
		ga = jnp.atleast_2d(self._ga)  # (nt, m), real — promotes inside the fusion
		nt, m = ga.shape

		def app(B):  # Ã applied over leading axes: (nt, b, n) -> (nt, b, n)
			return self._apply_t(B.reshape(-1, B.shape[-1])).reshape(B.shape)

		if m == 1:
			out = ga[:, 0][:, None, None] * Vt[None]
		else:

			def step(carry, gk):  # gk (nt,)
				b1, b2 = carry
				b = gk[:, None, None] * Vt[None] + 2.0 * app(b1) - b2
				return (b, b1), None

			z = jnp.zeros((nt,) + Vt.shape, acc)
			(b1, b2), _ = lax.scan(step, (z, z), ga[:, 1:][:, ::-1].T)
			out = ga[:, 0][:, None, None] * Vt[None] + app(b1) - b2
		out = jnp.swapaxes(out, -1, -2)  # (nt, n, b)
		if not is_stacked:
			out = out[0]
		return (out[..., 0] if single else out).astype(self.dtype)

	def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
		return self.matmat(v)

	def __matmul__(self, x):
		return self.matmat(x)

	def quad(self, X: jnp.ndarray) -> jnp.ndarray:
		"""Per-probe ``xᵀ f(A) x`` from the forward moment recurrence (one
		operator application per Chebyshev term, nothing else).

		The T_j recurrence is f-independent, so a stacked coefficient family
		costs no extra operator applications: the per-probe moments are
		reweighted per member and the result is ``(nt, b)``."""
		X = jnp.asarray(X, self.dtype)
		single = X.ndim == 1
		Xt = (X[:, None] if single else X).T
		acc = jnp.promote_types(self.dtype, jnp.float32)
		Xt = Xt.astype(acc)
		is_stacked = self._ga.ndim > 1
		ga = jnp.atleast_2d(self._ga)  # (nt, m), real
		m = ga.shape[1]
		# Hermitian (complex) operators: per-probe moments x†T_j(Ã)x are REAL —
		# conjugated bra, real part, real output dtype (identities when real).
		Xc = jnp.conj(Xt)
		moment = lambda Tn: jnp.real(jnp.sum(Xc * Tn, axis=1))  # noqa: E731
		T0 = Xt
		mu = ga[:, 0][:, None] * moment(T0)  # (nt, b)
		if m > 1:
			T1 = self._apply_t(Xt)
			mu = mu + ga[:, 1][:, None] * moment(T1)

			def step(carry, gk):  # gk (nt,)
				Tm1, Tm, acc_mu = carry
				Tn = 2.0 * self._apply_t(Tm) - Tm1
				acc_mu = acc_mu + gk[:, None] * moment(Tn)
				return (Tm, Tn, acc_mu), None

			if m > 2:
				(_, _, mu), _ = lax.scan(step, (T0, T1, mu), ga[:, 2:].T)
		if not is_stacked:
			mu = mu[0]
		out = mu.astype(real_dtype(self.dtype))
		return out[..., 0] if single else out

	def tree_flatten(self):
		return (self._op, self._ga, self._c, self._r), (
			self.shape, self.dtype, self._deg, self._damping, self._interval,
		)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj._op, obj._ga, obj._c, obj._r = children
		obj.shape, obj.dtype, obj._deg, obj._damping, obj._interval = aux
		return obj
