"""Estimator/criteria framework tests (mirrors reference `tests/test_estimators.py`)."""

import numpy as np
import pytest
import jax.numpy as jnp
import primate_tpu as pt
from primate_tpu.estimators import (
	ConfidenceCriterion,
	ControlVariableEstimator,
	CountCriterion,
	KneeCriterion,
	MeanEstimator,
	ToleranceCriterion,
	convergence_criterion,
)


def test_mean_estimator_matches_numpy():
	rng = np.random.default_rng(1234)
	x = rng.normal(size=100)
	est = MeanEstimator()
	for chunk in np.array_split(x, 7):
		est.update(chunk)
	assert np.isclose(est.estimate, x.mean(), atol=1e-12)
	assert len(est) == 100


def test_mean_estimator_covariance_matches_numpy():
	rng = np.random.default_rng(5)
	x = rng.normal(size=200)
	est = MeanEstimator(covariance=True)
	for chunk in np.array_split(x, 11):
		est.update(chunk)
	assert np.isclose(est.estimate, x.mean(), atol=1e-12)
	assert np.isclose(est.converged_variance, np.var(x, ddof=1), atol=1e-10)


def test_mean_estimator_record():
	est = MeanEstimator(record=True)
	est.update(np.arange(10.0))
	assert len(est.values) == 10
	assert np.allclose(est.values, np.arange(10.0))


def test_count_criterion():
	est = MeanEstimator()
	cc = CountCriterion(5)
	assert not bool(cc(est))
	est.update(np.ones(5))
	assert bool(cc(est))


def test_tolerance_criterion():
	est = MeanEstimator()
	tc = ToleranceCriterion(atol=1e-3, rtol=0.0)
	est.update(np.ones(3))
	assert not bool(tc(est))  # first delta is large
	est.update(np.ones(500))  # mean barely moves now
	assert bool(tc(est))


def test_confidence_criterion_behavior():
	rng = np.random.default_rng(1234)
	est = MeanEstimator(covariance=True)
	cc = ConfidenceCriterion(confidence=0.95, atol=0.05, rtol=0.0)
	assert not bool(cc(est))
	est.update(rng.normal(size=2))
	assert not bool(cc(est))  # < 3 samples: never converged
	for _ in range(50):
		est.update(rng.normal(size=100, scale=0.1))
	assert bool(cc(est))


def test_confidence_interval_coverage():
	"""Empirical coverage of the 95% CLT interval ≈ 95% (±5%) over 400 trials."""
	rng = np.random.default_rng(1234)
	n_trials, n_samples, mu = 400, 40, 2.0
	covered = 0
	cc = ConfidenceCriterion(confidence=0.95)
	for _ in range(n_trials):
		x = rng.normal(loc=mu, size=n_samples)
		est = MeanEstimator(covariance=True)
		est.update(x)
		moe, _ = cc._error(est.snapshot())
		covered += abs(est.estimate - mu) <= float(moe)
	coverage = covered / n_trials
	assert 0.90 <= coverage <= 1.0, f"coverage={coverage}"


def test_knee_criterion():
	est = MeanEstimator(record=True)
	kc = KneeCriterion(S=1.0)
	assert not bool(kc(est))  # no values yet
	# A sequence whose cumulative mean flattens out should trigger a knee.
	rng = np.random.default_rng(0)
	est.update(10.0 + rng.normal(size=5))
	for _ in range(40):
		est.update(10.0 + 0.001 * rng.normal(size=5))
	assert bool(kc(est))


def test_criteria_composition_semantics():
	est = MeanEstimator()
	est.update(np.ones(7))
	both = CountCriterion(5) & CountCriterion(10)
	either = CountCriterion(5) | CountCriterion(10)
	neg = ~CountCriterion(5)
	assert not bool(both(est)) and bool(either(est)) and not bool(neg(est))
	est.update(np.ones(5))
	assert bool(both(est))


def test_criteria_messages():
	est = MeanEstimator(covariance=True)
	est.update(np.random.default_rng(0).normal(size=10))
	for crit in (CountCriterion(5), ToleranceCriterion(), ConfidenceCriterion()):
		assert isinstance(crit.message(est), str) and len(crit.message(est)) > 0
	comp = CountCriterion(5) | ConfidenceCriterion()
	assert "|" in comp.message(est)


def test_convergence_criterion_factory():
	cc = convergence_criterion("count", count=7, unused_kwarg=1)
	assert isinstance(cc, CountCriterion)
	cc2 = convergence_criterion(cc)
	assert cc2 is cc
	for name in ("count", "tolerance", "confidence", "knee"):
		assert convergence_criterion(name) is not None


def test_control_variable_estimator_beats_plain_mean():
	"""CV-corrected estimates have lower error than the plain mean in most trials
	(reference `tests/test_estimators.py`)."""
	rng = np.random.default_rng(1234)
	mu_y, wins = 1.0, 0
	n_trials = 60
	for _ in range(n_trials):
		z = rng.normal(size=300)
		y = 0.5 + z  # target, true mean 0.5... control variate z with E[z]=0
		cve = ControlVariableEstimator(ecv=0.0)
		cve.update(np.stack([y, z], axis=1))
		plain_err = abs(y.mean() - 0.5)
		cv_err = abs(cve.estimate - 0.5)
		wins += cv_err <= plain_err
	assert wins >= int(0.8 * n_trials), f"control variate won only {wins}/{n_trials}"


def test_estimator_snapshot_is_jittable():
	import jax

	est = MeanEstimator(covariance=True)
	est.update(np.random.default_rng(1).normal(size=50))
	snap = est.snapshot()
	crit = CountCriterion(10) | ConfidenceCriterion(atol=10.0)

	@jax.jit
	def check(c, s):
		return c.check(s)

	assert bool(check(crit, snap)) == bool(crit(est))


def test_confidence_zero_mean_does_not_converge():
	"""A running mean of exactly 0 must not satisfy the rtol branch
	(regression: rel error was 0 instead of inf at est == 0)."""
	import jax.numpy as jnp
	from primate_tpu.estimators import ConfidenceCriterion, EstSnapshot

	cc = ConfidenceCriterion(confidence=0.95, atol=0.0, rtol=0.01)
	snap = EstSnapshot(
		n=jnp.asarray(10), estimate=jnp.zeros(1), delta=jnp.zeros(1), var=jnp.asarray(5.0), values=None
	)
	assert not bool(cc.check(snap))


def test_confidence_t_score_df():
	"""t-quantile must use df = n-1 (the reference's off-by-two is not kept)."""
	import scipy.stats as st
	import jax.numpy as jnp
	from primate_tpu.estimators import ConfidenceCriterion, EstSnapshot

	cc = ConfidenceCriterion(confidence=0.95, atol=1.0)
	snap = EstSnapshot(
		n=jnp.asarray(3), estimate=jnp.ones(1), delta=jnp.zeros(1), var=jnp.asarray(1.0), values=None
	)
	moe, _ = cc._error(snap)
	want = st.t.ppf(0.975, df=2) * np.sqrt(1.0 / 3.0)
	assert abs(float(moe) - want) < 1e-5


def test_custom_python_criterion_falls_back_to_host_loop():
	"""A user criterion that is not a registered pytree must still work."""
	import primate_tpu as pt

	class StopAt100:
		def __call__(self, est):
			return est.n_samples >= 100

		def check(self, snap):  # pragma: no cover - host path uses __call__
			raise RuntimeError

		def message(self, est):
			return "custom"

	A = pt.symmetric(24, pd=True, seed=0)
	est = pt.hutch(A, converge=StopAt100(), seed=1)
	assert np.isfinite(est)
	d = pt.diag(A, converge=StopAt100(), seed=2)
	assert np.asarray(d).shape == (24,)


def test_diag_confidence_criterion_works():
	import primate_tpu as pt

	A = pt.symmetric(32, pd=True, seed=3)
	d = pt.diag(A, converge="confidence", atol=0.2, seed=4)
	assert np.abs(np.asarray(d) - np.diag(np.asarray(A))).mean() < 0.5


def test_confidence_estimator_interval_matches_scipy():
	"""ConfidenceEstimator (the reference's planned-but-unshipped class,
	`__init__.py:10` commented import) — its CI matches scipy's t-interval."""
	import scipy.stats as st
	from primate_tpu import ConfidenceEstimator

	rng = np.random.default_rng(7)
	x = rng.normal(2.0, 1.5, size=25)
	est = ConfidenceEstimator(confidence=0.95)
	for chunk in np.split(x, 5):
		est.update(chunk)
	assert est.n_samples == 25
	assert np.isclose(est.estimate, x.mean())
	lo, hi = est.interval
	slo, shi = st.t.interval(0.95, df=24, loc=x.mean(), scale=st.sem(x, ddof=1))
	# Our t-quantile uses df = n-1 via the table index convention of
	# ConfidenceCriterion (index n-2 → df=n-1); matches scipy exactly.
	assert np.isclose(lo, slo, atol=1e-8) and np.isclose(hi, shi, atol=1e-8)


def test_confidence_estimator_agrees_with_criterion():
	"""margin_of_error crosses atol exactly when ConfidenceCriterion fires."""
	from primate_tpu import ConfidenceCriterion, ConfidenceEstimator

	rng = np.random.default_rng(11)
	est = ConfidenceEstimator(confidence=0.95)
	crit = ConfidenceCriterion(confidence=0.95, atol=0.3, rtol=0.0)
	fired = False
	for _ in range(200):
		est.update(rng.normal(5.0, 1.0, size=4))
		fired = bool(crit(est))
		if fired:
			break
	assert fired
	assert est.margin_of_error <= 0.3
	assert "+/-" in repr(est)


def test_confidence_estimator_stats_import_location():
	"""The reference planned `from .stats import ConfidenceEstimator` — honor it."""
	from primate_tpu.stats import ConfidenceEstimator, ControlVariableEstimator  # noqa: F401

	est = ConfidenceEstimator()
	assert est.margin_of_error == np.inf  # undefined before 3 samples


def test_covariance_complex_matches_numpy():
	"""Review r3b: complex samples produce the Hermitian covariance E[(x-u)(x-u)^H]
	(np.cov convention), not the unconjugated (complex-valued) scatter."""
	from primate_tpu.stats import Covariance

	rng = np.random.default_rng(0)
	x = rng.normal(size=40) + 1j * rng.normal(size=40)
	cov = Covariance(dim=1)
	cov.update(x[:25])
	cov.update(x[25:])
	got = cov.covariance()
	want = np.cov(x)
	assert abs(np.imag(got)) < 1e-10
	assert np.isclose(np.real(got), np.real(want), rtol=1e-10)


def test_control_variable_snapshot_var_is_residual():
	"""Review r3b: the snapshot's var must be the CORRECTED estimator's residual
	variance (Schur complement), not the raw sample variance — otherwise
	ConfidenceCriterion ignores the control variates' reduction entirely."""
	from primate_tpu.estimators import ControlVariableEstimator

	rng = np.random.default_rng(1)
	cv = rng.normal(size=(400, 1))
	s = 2.0 + cv[:, 0] + 0.1 * rng.normal(size=400)
	est = ControlVariableEstimator(ecv=[0.0])
	est.update(np.column_stack([s, cv[:, 0]]))
	snap = est.snapshot()
	raw_var = float(np.var(s, ddof=1))
	assert float(snap.var) < 0.05 * raw_var  # CV explains ~99% of the variance
	want = np.var(s - cv[:, 0], ddof=1)
	assert abs(float(snap.var) - want) < 0.2 * want


def test_maxiter_capped_stop_is_surfaced():
	"""A run that exhausts maxiter with its criterion unmet must
	warn and label the result — never silently read as converged."""
	import warnings as _w

	import primate_tpu as pt

	A = pt.symmetric(32, pd=True, seed=0)
	# Tolerance impossible in 2 batches → capped.
	with pytest.warns(UserWarning, match="maxiter=2"):
		est, res = pt.hutch(A, batch=4, converge="tolerance", atol=0.0, rtol=0.0, maxiter=2, seed=1, full=True)
	assert res.info.get("capped") is True
	assert "capped at maxiter=2" in res.message
	# full=False still warns.
	with pytest.warns(UserWarning, match="maxiter=2"):
		pt.hutch(A, batch=4, converge="tolerance", atol=0.0, rtol=0.0, maxiter=2, seed=1)
	# A converged run carries no cap flag and no warning.
	with _w.catch_warnings():
		_w.simplefilter("error")
		est2, res2 = pt.hutch(A, batch=4, converge="count", count=8, maxiter=64, seed=1, full=True)
	assert "capped" not in res2.info and "capped" not in res2.message

	# diag: fused path.
	with pytest.warns(UserWarning, match="diag: stopped by maxiter=3"):
		d, dres = pt.diag(A, converge="tolerance", atol=0.0, rtol=0.0, maxiter=3, seed=2, full=True)
	assert dres.info.get("capped") is True and "capped at maxiter=3" in dres.message
	# diag: host-stepped path (callback forces it).
	with pytest.warns(UserWarning, match="diag: stopped by maxiter=3"):
		d2, dres2 = pt.diag(A, converge="tolerance", atol=0.0, rtol=0.0, maxiter=3, seed=2, full=True, callback=lambda r: None)
	assert dres2.info.get("capped") is True
	# hutch: host-stepped path.
	with pytest.warns(UserWarning, match="hutch: stopped by maxiter=2"):
		pt.hutch(A, batch=4, converge="tolerance", atol=0.0, rtol=0.0, maxiter=2, seed=1, callback=lambda r: None)
