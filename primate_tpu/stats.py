"""On-device streaming statistics: Welford mean/covariance as pytrees.

Parity: reference ``src/primate/stats.py`` (Mean / Covariance / confidence_interval).

Design notes (accelerator-first):
  * The jittable core is a pair of NamedTuple states (:class:`MeanState`,
    :class:`CovState`) plus pure update functions — these are carried through
    `lax.while_loop` bodies so that estimator updates and convergence checks run
    **on-device** with no host round-trips (the reference updates a Python
    object per batch, `stats.py:66-86`).
  * Batched Welford updates use the same merge algebra as the reference
    (batch mean shift + cross-term correction), so streaming moments match
    `np.mean`/`np.cov` to rounding at every step.
  * Cross-chip: states are small pytrees; under `pjit`/`shard_map`, per-chip
    sample blocks reduce with `psum` of ``(n, n*mu, S-contributions)``.
"""

from typing import NamedTuple, Union

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
	"MeanState",
	"CovState",
	"make_mean_state",
	"make_cov_state",
	"mean_update",
	"cov_update",
	"cov_matrix",
	"Mean",
	"Covariance",
	"confidence_interval",
]


class MeanState(NamedTuple):
	"""Streaming mean: ``n`` samples seen, running mean ``mu`` of shape (dim,)."""

	n: jnp.ndarray  # () int32
	mu: jnp.ndarray  # (dim,)


class CovState(NamedTuple):
	"""Streaming mean + scatter: ``S`` accumulates centered outer products.

	``cov = S / (n - ddof)``. For dim == 1, ``S`` has shape (1, 1).
	"""

	n: jnp.ndarray  # () int32
	mu: jnp.ndarray  # (dim,)
	S: jnp.ndarray  # (dim, dim)


def make_mean_state(dim: int = 1, dtype=jnp.float32) -> MeanState:
	return MeanState(n=jnp.zeros((), jnp.int32), mu=jnp.zeros(dim, dtype))


def make_cov_state(dim: int = 1, dtype=jnp.float32) -> CovState:
	return CovState(n=jnp.zeros((), jnp.int32), mu=jnp.zeros(dim, dtype), S=jnp.zeros((dim, dim), dtype))


def _as_batch(X: jnp.ndarray) -> jnp.ndarray:
	"""Promote samples to (batch, dim): 0-d -> (1,1), 1-d (n,) -> (n,1)."""
	X = jnp.atleast_1d(jnp.asarray(X))
	return X[:, None] if X.ndim == 1 else X


def mean_update(state: MeanState, X: jnp.ndarray) -> MeanState:
	"""Merge a batch ``X`` of shape (batch, dim) into the running mean. Pure/jittable."""
	X = _as_batch(X)
	b = X.shape[0]
	batch_mean = jnp.mean(X, axis=0)
	new_n = state.n + b
	w = b / new_n.astype(X.dtype)
	return MeanState(n=new_n, mu=state.mu + w * (batch_mean - state.mu))


def cov_update(state: CovState, X: jnp.ndarray) -> CovState:
	"""Merge a batch into running mean + scatter (batched Welford). Pure/jittable."""
	X = _as_batch(X)
	b = X.shape[0]
	batch_mean = jnp.mean(X, axis=0)
	delta = batch_mean - state.mu
	new_n = state.n + b
	w = b / new_n.astype(X.dtype)
	mu = state.mu + w * delta
	Xc = X - batch_mean[None, :]
	# Cross-term shift merges the old moments with the batch moments. Bra sides
	# conjugate so complex samples produce the Hermitian covariance
	# E[(x−μ)(x−μ)†] (a real PSD diagonal); conj is a no-op on the real path.
	shift = jnp.outer(jnp.conj(delta), delta) * (state.n.astype(X.dtype) * b / new_n.astype(X.dtype))
	S = state.S + jnp.conj(Xc).T @ Xc + shift
	return CovState(n=new_n, mu=mu, S=S)


def cov_matrix(state: CovState, ddof: int = 1) -> jnp.ndarray:
	"""Covariance estimate ``S / (n - ddof)``; +inf while underdetermined. Jittable."""
	denom = state.n - ddof
	safe = jnp.maximum(denom, 1).astype(state.S.dtype)
	return jnp.where(denom > 0, state.S / safe, jnp.inf)


def _host_cpu():
	"""The local CPU device — host-facing wrapper math runs here, so eager jnp
	ops never dispatch to the accelerator and sync on every update/read; the
	fused estimators never touch these classes."""
	return jax.local_devices(backend="cpu")[0]


class Mean:
	"""Host-facing streaming mean (wraps :class:`MeanState`)."""

	def __init__(self, dim: int = 1, dtype=None):
		self.dim = dim
		# numpy state from the start, built on the LOCAL cpu backend: a
		# device-resident zero state would commit every subsequent eager op to
		# the accelerator, and creating-then-pulling it there costs a sync per
		# constructed estimator.
		with jax.default_device(_host_cpu()):
			self._state = jax.device_get(make_mean_state(dim, dtype or jnp.asarray(0.0).dtype))

	@property
	def n(self) -> int:
		return int(self._state.n)

	@property
	def mu(self) -> jnp.ndarray:
		return self._state.mu

	def update(self, X) -> None:
		# Host-facing class: pull device samples ONCE, then run the Welford math
		# on the LOCAL CPU backend and land the state as numpy. Converting X
		# with plain jnp.asarray commits it to the accelerator and every eager
		# op + attribute read follows it there, each with its own sync.
		# The fused estimators use the raw pytree mean_update/cov_update
		# directly and are unaffected.
		X = np.asarray(X)
		with jax.default_device(_host_cpu()):
			X = _as_batch(jnp.asarray(X))
			assert X.shape[1] == self.dim, f"Expected shape (n, {self.dim}), got {X.shape}"
			if X.dtype != self._state.mu.dtype:
				# Only ever WIDEN the accumulated state: a lower-precision batch
				# must not silently downcast an f64 Welford history to f32.
				wide = jnp.promote_types(self._state.mu.dtype, X.dtype)
				self._state = MeanState(self._state.n, np.asarray(self._state.mu, wide))
				X = X.astype(wide)
			self._state = jax.device_get(mean_update(self._state, X))

	def mean(self) -> Union[float, jnp.ndarray]:
		if self.n == 0:
			return np.nan
		return self.mu.item() if self.dim == 1 else self.mu

	__call__ = mean


class Covariance(Mean):
	"""Host-facing streaming covariance (wraps :class:`CovState`), Welford-stable."""

	def __init__(self, dim: int = 1, dtype=None):
		self.dim = dim
		with jax.default_device(_host_cpu()):  # see Mean.__init__
			self._state = jax.device_get(make_cov_state(dim, dtype or jnp.asarray(0.0).dtype))

	@property
	def S(self) -> jnp.ndarray:
		return self._state.S

	def update(self, X) -> None:
		X = np.asarray(X)  # one pull for device samples; local math below (see Mean.update)
		with jax.default_device(_host_cpu()):
			X = _as_batch(jnp.asarray(X))
			assert X.shape[1] == self.dim, f"Expected shape (n, {self.dim}), got {X.shape}"
			if X.dtype != self._state.mu.dtype:
				wide = jnp.promote_types(self._state.mu.dtype, X.dtype)  # widen-only, as in Mean
				self._state = CovState(self._state.n, np.asarray(self._state.mu, wide), np.asarray(self._state.S, wide))
				X = X.astype(wide)
			self._state = jax.device_get(cov_update(self._state, X))

	def covariance(self, ddof: int = 1) -> Union[float, jnp.ndarray]:
		with jax.default_device(_host_cpu()):  # host math; see Mean.update
			cov = jax.device_get(cov_matrix(self._state, ddof=ddof))
		return cov.item() if self.dim == 1 else cov

	def __call__(self, ddof: int = 1) -> Union[float, jnp.ndarray]:
		return self.covariance(ddof=ddof)

	def mean(self) -> Union[float, jnp.ndarray]:
		if self.n == 0:
			return np.nan
		return self.mu.item() if self.dim == 1 else self.mu


def confidence_interval(a, confidence: float = 0.95, sdist: str = "t") -> tuple:
	"""Confidence interval for the sample mean of measurements ``a`` (host-side).

	Parity: reference `stats.py:102-113`. Uses the Student-t sampling
	distribution by default, or the normal approximation with ``sdist="normal"``.
	"""
	import scipy.stats as st

	a = np.asarray(a).ravel()
	assert 0.0 <= confidence <= 1.0, "Invalid confidence measure"
	mean = float(np.mean(a))
	if sdist == "t":
		sem = st.sem(a, ddof=1)
		m = st.t.ppf((1 + confidence) / 2.0, len(a) - 1)
		return mean - m * sem, mean + m * sem
	elif sdist == "normal":
		scale = np.std(a, ddof=1) / np.sqrt(len(a))
		return st.norm.interval(confidence, loc=mean, scale=scale)
	raise ValueError(f"Unknown sampling distribution '{sdist}'.")


def __getattr__(name):
	# The reference planned `from .stats import ControlVariableEstimator,
	# ConfidenceEstimator` (commented in its `__init__.py:10`); both live in
	# `estimators` here — mirror that import location lazily (no import cycle).
	if name in ("ConfidenceEstimator", "ControlVariableEstimator"):
		from . import estimators

		return getattr(estimators, name)
	raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
