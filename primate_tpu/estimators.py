"""Estimator framework: streaming estimators + composable on-device stopping rules.

Parity: reference ``src/primate/estimators.py`` (Estimator protocol,
MeanEstimator, ControlVariableEstimator, EstimatorResult, ConvergenceCriterion
algebra, count/tolerance/confidence/knee criteria, string registry).

Accelerator design:
  * A criterion's ``__call__`` evaluates a **jittable predicate** over an
    :class:`EstSnapshot` pytree — so composed criteria trace straight into
    `lax.while_loop` conditions and adaptive estimation runs on-device with no
    host round-trip per batch (the reference evaluates criteria in Python
    between batches, `trace.py:107`).
  * Criteria are themselves **registered pytrees** whose numeric parameters are
    leaves: passing a criterion into a jitted estimator program caches the
    compilation by *structure*, so changing `atol` or `count` re-uses the
    compiled program.
  * The boolean algebra (``|``, ``&``, ``~``) builds Or/And/Not nodes rather
    than opaque lambdas, for the same caching reason.
  * The CLT confidence test needs Student-t quantiles: the t-table is
    precomputed on the host at construction (df = 1..30) and becomes a constant
    in the compiled program; beyond 30 samples the normal quantile is used —
    mirroring reference `estimators.py:254,279-293`.
"""

import typing
from dataclasses import dataclass, field
from typing import Callable, Iterable, NamedTuple, Optional, Union

import numpy as np
import jax
import jax.numpy as jnp

from .stats import Covariance, CovState, Mean, MeanState, cov_matrix
from .utils.kwargs import restrict_kwargs

__all__ = [
	"EstSnapshot",
	"Estimator",
	"MeanEstimator",
	"ControlVariableEstimator",
	"ConfidenceEstimator",
	"EstimatorResult",
	"ConvergenceCriterion",
	"CountCriterion",
	"ToleranceCriterion",
	"ConfidenceCriterion",
	"KneeCriterion",
	"convergence_criterion",
	"CRITERIA",
	"arr_summary",
	"note_capped",
]


def note_capped(capped: bool, maxiter: int, result: "EstimatorResult" = None, name: str = "estimator") -> None:
	"""Surface a budget-capped stop: when a loop exhausts
	``maxiter`` with its convergence criterion still unmet, warn — and when a
	result record is available, flag it in ``info`` and append to ``message`` —
	so an unconverged estimate never silently reads as converged."""
	if not capped:
		return
	import warnings

	warnings.warn(
		f"{name}: stopped by maxiter={maxiter} before the convergence criterion was met; "
		"the estimate may not have the requested accuracy/confidence (raise maxiter, or "
		"resume= from the returned result to continue the same probe stream)",
		stacklevel=3,
	)
	if result is not None:
		result.info["capped"] = True
		result.message = (result.message + " " if result.message else "") + f"[capped at maxiter={maxiter}]"


def arr_summary(x) -> str:
	"""Compact array printer for criterion messages (reference `estimators.py:18-31`)."""
	if x is None:
		return "None"
	x = np.atleast_1d(np.asarray(x))
	with np.printoptions(precision=2, suppress=True, threshold=3, floatmode="fixed"):
		if len(x) == 1:
			return f"{x.item():.3f}"
		elif len(x) <= 3:
			return np.array2string(x, separator=",")
		x1 = np.array2string(x[:2], separator=",").strip("[]")
		x2 = np.array2string(x[-1], separator=",").strip("[]")
		return "[" + x1 + ",...," + x2 + "]"


class EstSnapshot(NamedTuple):
	"""The jittable view of an estimator that criteria consume.

	n: () int32 — samples seen. estimate/delta: (dim,). var: () sample variance
	of the scalar samples (None when not tracked). values: (cap,) recorded
	sample buffer, mask = arange(cap) < n (None when not recording).
	"""

	n: jnp.ndarray
	estimate: jnp.ndarray
	delta: jnp.ndarray
	var: Optional[jnp.ndarray] = None
	values: Optional[jnp.ndarray] = None

	@property
	def n_samples(self):
		"""Alias so plain-callable criteria written against the estimator
		protocol (``est.n_samples``) also work when handed a snapshot."""
		return self.n


@typing.runtime_checkable
class Estimator(typing.Protocol):
	"""Minimal estimator protocol: sample count, update, estimate, delta."""

	n_samples: int

	def __len__(self) -> int: ...

	def update(self, x) -> None: ...

	@property
	def estimate(self): ...


def _as_snapshot(est) -> EstSnapshot:
	if isinstance(est, EstSnapshot):
		return est
	if hasattr(est, "snapshot"):
		return est.snapshot()
	raise TypeError(f"Cannot view {type(est)} as an estimator snapshot")


# ---------------------------------------------------------------------------
# Convergence criteria
# ---------------------------------------------------------------------------


def clt_quantiles(confidence: float) -> tuple:
	"""``(z, t_table)`` for a two-sided CLT interval at ``confidence``.

	The ONE construction of the normal quantile and the df=1..30 Student-t
	table — shared by :class:`ConfidenceCriterion`, :class:`ConfidenceEstimator`
	and ``recipes.suggest_probes`` so the three can never drift apart. Index
	convention: ``t_table[i]`` is the df=i+1 quantile, so n samples (df=n−1)
	reads ``t_table[n−2]``.
	"""
	import scipy.special as spc
	import scipy.stats as st

	z = float(np.sqrt(2.0) * spc.erfinv(confidence))
	t = np.asarray(st.t.ppf((confidence + 1.0) / 2.0, df=np.arange(30) + 1))
	return z, t


class ConvergenceCriterion:
	"""Composable stopping rule; ``crit(est)`` returns a (traceable) boolean.

	Compose lazily with ``|``, ``&``, ``~`` (reference `estimators.py:56-77`).
	Subclasses implement ``check(snapshot) -> jnp.bool_``.
	"""

	def __init__(self, operation: Optional[Callable] = None):
		self._operation = operation

	def check(self, snap: EstSnapshot):
		assert self._operation is not None, "Base criterion requires an operation"
		return self._operation(snap)

	def __call__(self, est) -> jnp.ndarray:
		# Host-facing entry (the fused loops call `check` inside their traced
		# condition instead): run the predicate's eager ops on the LOCAL CPU
		# backend, so an eager composed criterion never dispatches small ops
		# to the accelerator once per host-stepped batch.
		from .stats import _host_cpu

		with jax.default_device(_host_cpu()):
			return self.check(_as_snapshot(est))

	def __or__(self, other: "ConvergenceCriterion"):
		return OrCriterion(self, other)

	def __ror__(self, other):
		return OrCriterion(other, self)

	def __and__(self, other: "ConvergenceCriterion"):
		return AndCriterion(self, other)

	def __rand__(self, other):
		return AndCriterion(other, self)

	def __invert__(self):
		return NotCriterion(self)

	def message(self, est) -> str:
		return "Composite convergence criterion"


def _child_check(child, snap: EstSnapshot):
	"""Evaluate a composite's child on a snapshot. Criterion children use
	``check`` (traceable, rides inside fused loops); plain-callable children —
	accepted per ``convergence_criterion``'s contract — are called directly
	(the snapshot exposes ``n_samples``/``estimate``/``delta``; such
	compositions are not jittable, so they only ever run host-stepped)."""
	return child.check(snap) if isinstance(child, ConvergenceCriterion) else child(snap)


def _child_eval(child, est):
	"""Host-path evaluation: criteria convert to a snapshot themselves; plain
	callables receive the raw estimator, matching the host-loop contract
	``criterion(estimator)`` that `hutch`/`diag` honor for bare callables."""
	return child(est)


def _child_message(child, est) -> str:
	if hasattr(child, "message"):
		return child.message(est)
	return getattr(child, "__name__", "<callable criterion>")


@jax.tree_util.register_pytree_node_class
class OrCriterion(ConvergenceCriterion):
	def __init__(self, left, right):
		self.left, self.right = left, right

	def check(self, snap):
		return jnp.logical_or(_child_check(self.left, snap), _child_check(self.right, snap))

	def __call__(self, est):
		return jnp.logical_or(_child_eval(self.left, est), _child_eval(self.right, est))

	def message(self, est):
		return f"{_child_message(self.left, est)} | {_child_message(self.right, est)}"

	def tree_flatten(self):
		return (self.left, self.right), None

	@classmethod
	def tree_unflatten(cls, aux, children):
		return cls(*children)


@jax.tree_util.register_pytree_node_class
class AndCriterion(ConvergenceCriterion):
	def __init__(self, left, right):
		self.left, self.right = left, right

	def check(self, snap):
		return jnp.logical_and(_child_check(self.left, snap), _child_check(self.right, snap))

	def __call__(self, est):
		return jnp.logical_and(_child_eval(self.left, est), _child_eval(self.right, est))

	def message(self, est):
		return f"{_child_message(self.left, est)} & {_child_message(self.right, est)}"

	def tree_flatten(self):
		return (self.left, self.right), None

	@classmethod
	def tree_unflatten(cls, aux, children):
		return cls(*children)


@jax.tree_util.register_pytree_node_class
class NotCriterion(ConvergenceCriterion):
	def __init__(self, inner):
		self.inner = inner

	def check(self, snap):
		return jnp.logical_not(_child_check(self.inner, snap))

	def __call__(self, est):
		return jnp.logical_not(_child_eval(self.inner, est))

	def message(self, est):
		return f"~({_child_message(self.inner, est)})"

	def tree_flatten(self):
		return (self.inner,), None

	@classmethod
	def tree_unflatten(cls, aux, children):
		return cls(*children)


@jax.tree_util.register_pytree_node_class
class CountCriterion(ConvergenceCriterion):
	"""TRUE once at least ``count`` samples have been seen."""

	def __init__(self, count: int = 200):
		self.count = count

	def check(self, snap: EstSnapshot):
		return snap.n >= self.count

	def message(self, est) -> str:
		snap = _as_snapshot(est)
		return f"Est: {arr_summary(np.asarray(snap.estimate))} (#S:{int(snap.n)})"

	def tree_flatten(self):
		return (self.count,), None

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.count = children[0]
		return obj


@jax.tree_util.register_pytree_node_class
class ToleranceCriterion(ConvergenceCriterion):
	"""TRUE when the last mean-update ``delta`` is small in norm:
	``‖Δ‖ < atol`` or ``‖Δ‖ < rtol · ‖estimate‖``."""

	def __init__(self, rtol: float = 0.01, atol: float = 1.49e-08, ord: Union[str, float, None] = 2.0):
		self.rtol, self.atol, self.ord = rtol, atol, ord

	def check(self, snap: EstSnapshot):
		err = jnp.linalg.norm(jnp.atleast_1d(snap.delta), ord=self.ord)
		est_norm = jnp.linalg.norm(jnp.atleast_1d(snap.estimate), ord=self.ord)
		return jnp.logical_or(err < self.atol, err < self.rtol * est_norm)

	def message(self, est) -> str:
		snap = _as_snapshot(est)
		msg = f"Est: {arr_summary(np.asarray(snap.estimate))}"
		msg += f"(atol={float(self.atol):3f}, rtol={float(self.rtol):3f}, #S:{int(snap.n)})"
		err = float(jnp.linalg.norm(jnp.atleast_1d(snap.delta), ord=self.ord))
		nrm = float(jnp.linalg.norm(jnp.atleast_1d(snap.estimate), ord=self.ord))
		msg += f"\nnorm(it - est, {self.ord}) = {err:.3f}, norm(est, {self.ord}) = {nrm:.3f}"
		return msg

	def tree_flatten(self):
		return (self.rtol, self.atol), self.ord

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.rtol, obj.atol = children
		obj.ord = aux
		return obj


@jax.tree_util.register_pytree_node_class
class ConfidenceCriterion(ConvergenceCriterion):
	"""CLT-based stopping: the (t / normal) margin of error of the sample mean
	falls below ``atol``, or the relative standard error below ``rtol``."""

	def __init__(self, confidence: float = 0.95, atol: float = 0.00, rtol: float = 0.01):
		assert 0 < confidence < 1, "Confidence must be in (0, 1)"
		self.confidence = confidence
		self.atol = 0.0 if atol is None else atol
		self.rtol = 0.0 if rtol is None else rtol
		z, t = clt_quantiles(confidence)
		self.z = z
		self.t_scores = jnp.asarray(t, jnp.float32)

	def _error(self, snap: EstSnapshot):
		assert snap.var is not None, "ConfidenceCriterion requires a variance-tracking estimator"
		n = snap.n
		nf = jnp.maximum(n, 1).astype(jnp.float32)
		std_err = jnp.sqrt(jnp.maximum(snap.var, 0.0).astype(jnp.float32) / nf)
		# t-quantile for df = n-1 lives at index n-2 (t_scores[i] has df=i+1).
		# The reference indexes with n (df = n+1, anti-conservative,
		# `estimators.py:286`) — a bug consciously not replicated.
		score = jnp.where(n < 30, self.t_scores[jnp.clip(n - 2, 0, 29)], self.z)
		moe = score * std_err
		est_scalar = jnp.atleast_1d(snap.estimate)[0].astype(jnp.float32)
		# A running mean of exactly 0 means the relative error is UNDEFINED —
		# treat as infinite so rtol can never trigger spurious convergence.
		rel = jnp.where(
			est_scalar == 0, jnp.inf, jnp.abs(std_err / jnp.where(est_scalar == 0, 1.0, est_scalar))
		)
		underdet = n < 3
		return jnp.where(underdet, jnp.inf, moe), jnp.where(underdet, jnp.inf, rel)

	def check(self, snap: EstSnapshot):
		moe, rel = self._error(snap)
		return jnp.logical_or(moe <= self.atol, rel <= self.rtol)

	def message(self, est) -> str:
		snap = _as_snapshot(est)
		if snap.var is None:  # host estimator without variance tracking
			return f"Est: {arr_summary(np.asarray(snap.estimate))} (#S:{int(snap.n)}; variance untracked)"
		moe, _ = self._error(snap)
		return (
			f"Est: {arr_summary(np.asarray(snap.estimate))} +/- {float(moe):.3f} "
			f"({self.confidence * 100:.0f}% CI, #S:{int(snap.n)})"
		)

	def tree_flatten(self):
		return (self.atol, self.rtol, self.t_scores), (self.confidence, self.z)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.atol, obj.rtol, obj.t_scores = children
		obj.confidence, obj.z = aux
		return obj


@jax.tree_util.register_pytree_node_class
class KneeCriterion(ConvergenceCriterion):
	"""Kneedle knee detection on the cumulative-mean difference curve.

	Requires a recording estimator; all cumulative statistics are computed with
	masking over the fixed-capacity sample buffer so the test is jittable.
	"""

	def __init__(self, S: float = 1.0):
		self.S = S

	def check(self, snap: EstSnapshot):
		if snap.values is None:
			return jnp.asarray(False)
		v = snap.values.astype(jnp.float32)
		cap = v.shape[0]
		idx = jnp.arange(cap)
		m = snap.n
		valid = idx < m
		v = jnp.where(valid, v, 0.0)
		cum_mean = jnp.cumsum(v) / jnp.arange(1, cap + 1)
		diffs = jnp.abs(jnp.diff(cum_mean))
		diffs = jnp.where(idx[:-1] < m - 1, diffs, 0.0)
		y = jnp.cumsum(diffs)
		y_valid = idx[:-1] < m - 1
		y_min = jnp.min(jnp.where(y_valid, y, jnp.inf))
		y_max = jnp.max(jnp.where(y_valid, y, -jnp.inf))
		denom = jnp.where(y_max > y_min, y_max - y_min, 1.0)
		y_norm = (y - y_min) / denom
		# x-coordinate normalized to [0, 1] over the valid prefix.
		mlen = jnp.maximum(m - 1, 2).astype(jnp.float32)  # len(y) in the reference
		x_norm = idx[:-1].astype(jnp.float32) / jnp.maximum(mlen - 1.0, 1.0)
		diff_curve = jnp.where(y_valid, y_norm - x_norm, -jnp.inf)
		max_i = jnp.argmax(diff_curve)
		max_diff = diff_curve[max_i]
		last = diff_curve[jnp.maximum(m - 2, 0)]
		threshold = max_diff - (self.S / jnp.maximum(mlen - 1.0, 1.0))
		knee = jnp.logical_and(max_diff > threshold, last < threshold)
		return jnp.logical_and(m >= 3, knee)

	def message(self, est) -> str:
		snap = _as_snapshot(est)
		return f"Est: {arr_summary(np.asarray(snap.estimate))} (#S:{int(snap.n)}, S={float(self.S):3f})"

	def tree_flatten(self):
		return (self.S,), None

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.S = children[0]
		return obj


def is_jittable_criterion(criterion) -> bool:
	"""True when the criterion flattens to pure array/scalar leaves.

	The built-in criteria are registered pytrees whose ``check`` is a traced
	predicate, so they ride inside the fused `lax.while_loop`. A user-defined
	criterion that is NOT a registered pytree flattens to itself as a leaf
	and would crash jit — estimators detect this and fall back to the
	host-stepped loop (reference semantics: arbitrary Python criteria).
	"""
	import jax as _jax

	ok = (jnp.ndarray, np.ndarray, np.generic, int, float, bool)
	return all(isinstance(leaf, ok) for leaf in _jax.tree_util.tree_leaves(criterion))


def criterion_needs_values(criterion) -> bool:
	"""True when any node of a (possibly composed) criterion consumes the
	recorded-samples buffer (``snapshot.values``) — currently `KneeCriterion`.
	Estimators use this to enable recording automatically; without it a knee
	criterion silently never fires (``values is None`` → always False)."""
	if isinstance(criterion, KneeCriterion) or getattr(criterion, "needs_values", False):
		return True
	children = [getattr(criterion, a, None) for a in ("left", "right", "inner")]
	return any(c is not None and criterion_needs_values(c) for c in children)


CRITERIA = {
	"count": CountCriterion,
	"tolerance": ToleranceCriterion,
	"confidence": ConfidenceCriterion,
	"knee": KneeCriterion,
}


def convergence_criterion(criterion: Union[str, ConvergenceCriterion], **kwargs) -> ConvergenceCriterion:
	"""Resolve a criterion name (+ routed kwargs) or pass an instance through.

	Any callable is accepted (a plain Python predicate on the estimator runs
	on the host-stepped paths); registered-pytree criteria additionally run
	inside the fused device loops.
	"""
	if isinstance(criterion, ConvergenceCriterion) or (callable(criterion) and not isinstance(criterion, str)):
		return criterion
	assert isinstance(criterion, str) and criterion.lower() in CRITERIA, f"Invalid criterion {criterion}"
	crit_cls = CRITERIA[criterion.lower()]
	return crit_cls(**restrict_kwargs(crit_cls, kwargs))


def default_trace_criterion() -> ConvergenceCriterion:
	"""The reference's default for `hutch`: 200 samples OR 95% CI within ±1.0."""
	return CountCriterion(count=200) | ConfidenceCriterion(confidence=0.95, atol=1.0, rtol=0.0)


# ---------------------------------------------------------------------------
# Estimators (host-facing classes over the jittable state pytrees)
# ---------------------------------------------------------------------------


class MeanEstimator:
	"""Sample-mean estimator with optional Welford covariance and sample recording.

	Thin host wrapper over :class:`~primate_tpu.stats.MeanState` /
	:class:`~primate_tpu.stats.CovState`; the fused device estimators construct
	one from their final loop state via :meth:`from_state`.
	"""

	def __init__(self, dim: int = 1, covariance: bool = False, record: bool = False, dtype=None):
		self.dim = dim
		self._moments = Covariance(dim=dim, dtype=dtype) if covariance else Mean(dim=dim, dtype=dtype)
		self.delta = np.full(dim, np.inf)
		self.values: Optional[list] = [] if record else None

	@classmethod
	def from_state(cls, state: Union[MeanState, CovState], delta=None, values=None, n_values: Optional[int] = None):
		dim = state.mu.shape[0]
		obj = cls(dim=dim, covariance=isinstance(state, CovState), record=values is not None)
		# One transfer up front: device states would otherwise sync on every
		# later attribute read (and pin eager host math to the accelerator).
		obj._moments._state = jax.device_get(state)
		obj.delta = np.full(dim, np.inf) if delta is None else np.asarray(delta)
		if values is not None:
			n_keep = int(state.n) if n_values is None else int(n_values)
			obj.values = list(np.asarray(values)[:n_keep])
		return obj

	@property
	def n_samples(self) -> int:
		return self._moments.n

	def __len__(self) -> int:
		return self.n_samples

	@property
	def mean(self):
		mu = self._moments.mu
		return mu.item() if self.dim == 1 else np.ravel(mu)

	@property
	def estimate(self):
		if self.n_samples == 0:
			return np.nan if self.dim == 1 else np.full(self.dim, np.nan)
		return self.mean

	@property
	def converged_variance(self):
		if isinstance(self._moments, Covariance):
			return self._moments.covariance()
		return None

	def update(self, x) -> None:
		# ONE device->host transfer when handed device samples; all estimator
		# math then stays on the host (see stats.Mean.update).
		x = np.atleast_1d(np.asarray(x))
		x = x[:, None] if x.ndim == 1 else x
		old_mu = np.asarray(self._moments.mu).copy()
		self._moments.update(x)
		self.delta = np.asarray(self._moments.mu) - old_mu
		if self.values is not None:
			self.values.extend(np.asarray(x).ravel().tolist())

	def snapshot(self) -> EstSnapshot:
		from .stats import _host_cpu

		state = self._moments._state
		with jax.default_device(_host_cpu()):  # host math; see stats.Mean.update
			var = None
			if isinstance(state, CovState):
				# Scalar proxy for any dim: mean of the per-output sample
				# variances (== the sample variance at dim 1) — matches the
				# fused-loop snapshots, so confidence criteria work on stacked
				# estimators.
				var = jnp.mean(jnp.diagonal(cov_matrix(state, ddof=1)))
			values = jnp.asarray(self.values) if self.values else None
			est = state.mu if self.n_samples > 0 else jnp.full(self.dim, jnp.nan, state.mu.dtype)
			return EstSnapshot(n=state.n, estimate=est, delta=jnp.asarray(self.delta), var=var, values=values)


class ControlVariableEstimator(MeanEstimator):
	"""Mean estimator corrected by control variates with known expectations.

	``estimate = mean(samples) − α·(mean(cv) − E[cv])`` with α estimated from
	the running covariance when not supplied (reference `estimators.py:148-204`).
	"""

	def __init__(self, ecv, alpha=None, record: bool = False):
		ecv = np.atleast_1d(ecv).ravel()
		super().__init__(dim=len(ecv), covariance=False, record=record)
		if alpha is not None:
			alpha = np.atleast_1d(alpha).ravel()
			assert len(ecv) == len(alpha), "Coefficients alpha must have same length as the control variables."
		self.alpha = alpha
		self.ecv = ecv
		self.cov = Covariance(dim=len(ecv) + 1)
		self._estimate_cor = alpha is None
		self.delta = np.inf

	@property
	def n_samples(self) -> int:
		return self.cov.n

	def update(self, samples) -> None:
		samples = np.atleast_1d(np.asarray(samples))  # one pull; host math below
		samples = samples[None, :] if samples.ndim == 1 else samples
		old = self.estimate
		self.cov.update(samples)
		if self._estimate_cor and self.cov.n > 1:
			C = np.asarray(self.cov(ddof=1))
			if self.cov.dim == 2:
				self.alpha = np.atleast_1d(C[0, 1] / C[1, 1])
			else:
				self.alpha = np.linalg.solve(C[1:, 1:], C[1:, 0])
		new = self.estimate
		self.delta = np.inf if (np.isnan(old) or np.isnan(new)) else abs(new - old)
		if self.values is not None:
			# Record only the primary-sample column (flat floats) — row lists
			# would break the 1-d masking in recording consumers (Knee, plots).
			self.values.extend(np.atleast_2d(np.asarray(samples))[:, 0].ravel().tolist())

	@property
	def estimate(self) -> float:
		if self.cov.n == 0 or self.alpha is None:
			return np.nan
		mu = np.asarray(self.cov.mu)
		return float(mu[0] - np.dot(np.ravel(self.alpha), mu[1:] - self.ecv))

	def snapshot(self) -> EstSnapshot:
		var = None
		if self.cov.n > 1:
			# Variance of the CORRECTED estimator, not the raw samples: the
			# Schur complement C00 − C01 C11⁻¹ C10 (what the optimal α leaves
			# behind). Reporting raw C00 made ConfidenceCriterion compute a
			# margin of error as if the control variates did nothing —
			# oversampling by the full variance-reduction factor.
			C = np.atleast_2d(np.asarray(self.cov(ddof=1)))
			if np.all(np.isfinite(C)):
				c01 = C[0, 1:]
				try:
					var = float(C[0, 0] - c01 @ np.linalg.solve(C[1:, 1:], c01))
				except np.linalg.LinAlgError:
					var = float(C[0, 0])
				var = max(var, 0.0)
			else:
				var = C[0, 0]
		return EstSnapshot(
			n=jnp.asarray(self.cov.n, jnp.int32),
			estimate=jnp.atleast_1d(jnp.asarray(self.estimate, jnp.float32)),
			delta=jnp.atleast_1d(jnp.asarray(self.delta, jnp.float32)),
			var=var,
			values=jnp.asarray(self.values) if self.values else None,
		)


class ConfidenceEstimator(MeanEstimator):
	"""Sample-mean estimator that carries its own CLT confidence interval.

	The reference *planned* this class — ``from .stats import
	ControlVariableEstimator, ConfidenceEstimator`` sits commented in its
	`__init__.py:10` — but never shipped it; this is the working version.
	It is a variance-tracking :class:`MeanEstimator` whose ``margin_of_error``
	/ ``interval`` use the same Student-t (n < 30) / normal quantile ladder as
	:class:`ConfidenceCriterion`, so ``est.margin_of_error`` always agrees with
	the stopping rule that consumed the estimator.

	>>> est = ConfidenceEstimator(confidence=0.95)
	>>> est.update(samples)
	>>> lo, hi = est.interval          # 95% CI for the running mean
	"""

	def __init__(self, confidence: float = 0.95, dim: int = 1, record: bool = False, dtype=None):
		assert 0 < confidence < 1, "Confidence must be in (0, 1)"
		super().__init__(dim=dim, covariance=True, record=record, dtype=dtype)
		self.confidence = confidence
		self._z, self._t = clt_quantiles(confidence)

	@property
	def stderr(self) -> float:
		"""Standard error of the running mean (scalar-proxy variance at dim>1)."""
		if self.n_samples < 2:
			return np.inf
		var = float(np.mean(np.diagonal(np.atleast_2d(np.asarray(self.converged_variance)))))
		return float(np.sqrt(max(var, 0.0) / self.n_samples))

	@property
	def margin_of_error(self) -> float:
		n = self.n_samples
		if n < 3:
			return np.inf
		score = self._t[min(max(n - 2, 0), 29)] if n < 30 else self._z
		return float(score * self.stderr)

	@property
	def interval(self) -> tuple:
		"""(lo, hi) confidence interval around :attr:`estimate`."""
		mu, moe = self.estimate, self.margin_of_error
		if self.dim == 1:
			return float(mu) - moe, float(mu) + moe
		return np.asarray(mu) - moe, np.asarray(mu) + moe

	def __repr__(self) -> str:
		if self.n_samples == 0:
			return f"ConfidenceEstimator(confidence={self.confidence}, <empty>)"
		return (
			f"ConfidenceEstimator({arr_summary(np.atleast_1d(np.asarray(self.estimate)))} "
			f"+/- {self.margin_of_error:.4g} @ {self.confidence * 100:.0f}%, #S:{self.n_samples})"
		)


@dataclass
class EstimatorResult:
	"""Result record for the statistical estimators (reference `estimators.py:79-99`)."""

	estimator: Optional[MeanEstimator] = None
	criterion: Union[ConvergenceCriterion, str, None] = None
	estimate: Union[float, np.ndarray] = 0.0
	message: str = ""
	nit: int = 0
	info: dict = field(default_factory=dict)
	samples: Optional[np.ndarray] = None

	def __iter__(self) -> Iterable:
		return iter((self.estimator, self.criterion, self.estimate, self.message, self.nit, self.info))
