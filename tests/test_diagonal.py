"""Diagonal estimator tests (mirrors reference `tests/test_diagonal.py`)."""

import numpy as np
import pytest
import jax.numpy as jnp
import primate_tpu as pt


def test_diag_converges():
	rng = np.random.default_rng(1234)
	n = 25
	A = pt.symmetric(n, pd=True, seed=rng)
	d_true = np.diag(np.asarray(A))
	d, info = pt.diag(A, seed=rng, full=True, converge="tolerance", atol=1e-3, maxiter=3000)
	assert np.asarray(d).shape == (n,)
	# criterion satisfied at stop
	assert bool(info.criterion(info.estimator))
	assert np.abs(np.asarray(d) - d_true).max() < 0.5


def test_diag_count_criterion():
	rng = np.random.default_rng(4)
	n = 20
	A = pt.symmetric(n, pd=True, seed=rng)
	d, info = pt.diag(A, seed=rng, converge="count", count=64, full=True)
	assert info.nit >= 64


def test_diag_callback_path_matches_fused():
	rng = np.random.default_rng(10)
	n = 16
	A = pt.symmetric(n, pd=True, seed=rng)
	d1 = pt.diag(A, seed=77, converge="count", count=32)
	calls = []
	d2 = pt.diag(A, seed=77, converge="count", count=32, callback=lambda r: calls.append(1))
	assert len(calls) > 0
	assert np.allclose(np.asarray(d1), np.asarray(d2), atol=1e-10)


def test_diag_batch_matches_truth_and_budget():
	"""batch>1 merges probes per iteration: same accuracy per PROBE budget,
	criterion/maxiter count iterations."""
	rng = np.random.default_rng(21)
	n = 64
	A = pt.symmetric(n, pd=True, seed=rng)
	d_true = np.diag(np.asarray(A))
	d, info = pt.diag(A, seed=5, converge="count", count=16, batch=32, full=True)
	assert info.nit == 16  # iterations, not probes
	# 16 iterations × 32 probes = 512 probes worth of accuracy
	err_b = np.abs(np.asarray(d) - d_true).max()
	d1, info1 = pt.diag(A, seed=5, converge="count", count=16, batch=1, full=True)
	err_1 = np.abs(np.asarray(d1) - d_true).max()
	assert err_b < err_1  # 32× probes at the same iteration count
	assert err_b < 0.35


def test_diag_batch_host_path_matches_fused():
	"""The callback (host-stepped) path reproduces the fused batch path exactly."""
	A = pt.symmetric(24, pd=True, seed=3)
	d1 = pt.diag(A, seed=9, converge="count", count=8, batch=4)
	calls = []
	d2 = pt.diag(A, seed=9, converge="count", count=8, batch=4, callback=lambda r: calls.append(r.nit))
	assert calls and np.allclose(np.asarray(d1), np.asarray(d2), atol=1e-10)


def test_diag_batch_resume_bit_exact():
	"""Resume with the same batch continues the identical probe stream."""
	A = pt.symmetric(32, pd=True, seed=11)
	d_full, r_full = pt.diag(A, seed=13, converge="count", count=12, batch=8, full=True)
	d_half, r_half = pt.diag(A, seed=13, converge="count", count=6, batch=8, full=True)
	d_res, r_res = pt.diag(A, seed=13, converge="count", count=12, batch=8, full=True, resume=r_half)
	assert r_res.nit == r_full.nit
	assert np.array_equal(np.asarray(d_res), np.asarray(d_full))


def test_diag_batch_stacked_family():
	"""Stacked MatrixFunction + batch: every family member's diagonal from the
	shared sweeps, probes blocked per iteration."""
	rng = np.random.default_rng(31)
	ew = rng.uniform(0.5, 2.0, 48)
	A = pt.symmetric(48, pd=True, ew=ew, seed=33)
	fam = pt.special.stacked(lambda x, t: jnp.exp(t * x), np.asarray([-1.0, -2.0]))
	M = pt.MatrixFunction(A, fun=fam, deg=24, orth=-1)
	d = pt.diag(M, seed=35, converge="count", count=24, batch=16)
	assert np.asarray(d).shape == (2, 48)
	w, U = np.linalg.eigh(np.asarray(A))
	for i, t in enumerate([-1.0, -2.0]):
		d_true = np.einsum("ij,j,ij->i", U, np.exp(t * w), U)
		assert np.abs(np.asarray(d)[i] - d_true).max() < 0.2, f"t={t}"


def test_xdiag_error_decreases_with_budget():
	"""Convergence-rate regression: OLS slope of log-error vs log-budget < -0.10
	(reference `tests/test_diagonal.py:15-34`)."""
	rng = np.random.default_rng(1234)
	n = 40
	A = pt.symmetric(n, pd=True, seed=rng)
	d_true = np.diag(np.asarray(A))
	budgets = np.array([8, 16, 32, 64, 80])
	errs = []
	for m in budgets:
		d = pt.xdiag(A, m=int(m), seed=1234)
		errs.append(np.linalg.norm(d - d_true))
	slope = np.polyfit(np.log(budgets), np.log(np.asarray(errs) + 1e-12), 1)[0]
	assert slope < -0.10, f"error does not decrease with budget: slope={slope}, errs={errs}"


def test_xdiag_exact_at_full_budget():
	rng = np.random.default_rng(2)
	n = 24
	A = pt.symmetric(n, pd=True, seed=rng)
	d = pt.xdiag(A, m=2 * n, seed=5)
	assert np.abs(d - np.diag(np.asarray(A))).max() < 1e-1


def test_diagpp_exact_low_rank():
	"""Exact (to rounding) when rank(A) ≤ nb: the residual vanishes."""
	import primate_tpu as pt

	n, r = 64, 12
	ew = np.concatenate([np.zeros(n - r), np.linspace(1.0, 4.0, r)])
	A = pt.symmetric(n, ew=ew, seed=2)
	d_true = np.diag(np.asarray(A))
	d = pt.diagpp(A, m=r + 4, seed=3)
	assert np.allclose(d, d_true, atol=1e-5)


def test_diagpp_beats_plain_diag_on_decaying_spectrum():
	"""At equal matvec budgets, deflation must cut the error on a decaying spectrum."""
	import primate_tpu as pt

	n = 96
	ew = 10.0 * 0.85 ** np.arange(n)
	A = pt.symmetric(n, pd=True, ew=ew, seed=4)
	d_true = np.diag(np.asarray(A))
	errs_pp, errs_gh = [], []
	for s in range(6):
		d_pp = pt.diagpp(A, m=16, seed=s)  # 48 matvecs
		d_gh = pt.diag(A, seed=s, converge="count", count=48, maxiter=48)
		errs_pp.append(np.linalg.norm(d_pp - d_true))
		errs_gh.append(np.linalg.norm(np.asarray(d_gh) - d_true))
	assert np.mean(errs_pp) < 0.5 * np.mean(errs_gh), (np.mean(errs_pp), np.mean(errs_gh))


def test_diagpp_empty_and_seeded():
	import primate_tpu as pt

	assert pt.diagpp(np.zeros((0, 0))).shape == (0,)
	A = pt.symmetric(32, pd=True, seed=5)
	assert np.allclose(pt.diagpp(A, m=8, seed=9), pt.diagpp(A, m=8, seed=9))


def test_diag_callback_sees_progress():
	"""Callbacks receive live estimate/nit (previously stuck at 0)."""
	import primate_tpu as pt

	A = np.asarray(pt.symmetric(40, pd=True, seed=0))
	seen = []
	pt.diag(A, converge="count", count=8, seed=1, callback=lambda r: seen.append((r.nit, np.asarray(r.estimate).copy())))
	assert seen and seen[0][0] == 1 and seen[-1][0] >= 8
	assert np.any(seen[-1][1] != 0)


def test_diag_knee_rejected():
	import primate_tpu as pt
	import pytest as _pytest

	A = np.asarray(pt.symmetric(20, pd=True, seed=0))
	with _pytest.raises(NotImplementedError):
		pt.diag(A, converge="knee")


def test_diag_empty_operator_returns_array():
	import primate_tpu as pt

	est = pt.diag(np.zeros((0, 0)))
	assert isinstance(est, np.ndarray) and est.shape == (0,)


def test_diag_resume_bit_exact():
	"""diag resume: split runs ≡ one uninterrupted run (fused and host paths)."""
	A = pt.symmetric(50, pd=True, seed=0)
	d_full, r_full = pt.diag(A, converge="count", count=384, seed=4, full=True)
	d_half, r_half = pt.diag(A, converge="count", count=192, seed=4, full=True)
	d_res, r_res = pt.diag(A, converge="count", count=384, seed=4, full=True, resume=r_half)
	assert r_res.nit == r_full.nit == 384
	assert np.abs(d_full - d_res).max() < 1e-12
	# Host-stepped (callback) resume of the same fused state; snapshot unmutated.
	calls = []
	d_res2 = pt.diag(A, converge="count", count=384, seed=4, resume=r_half, callback=lambda r: calls.append(r.nit))
	assert np.abs(d_full - d_res2).max() < 1e-12
	assert calls[0] == 193 and calls[-1] == 384
	assert int(r_half.info["state"]["mean"].n) == 192


def test_diag_host_path_tracks_m2_for_resume():
	"""The callback (host-stepped) path keeps the Welford m2 current, so its
	snapshot resumes into the fused path bit-faithfully — and never with a
	vacuous var=0 confidence state."""
	A = jnp.asarray(pt.symmetric(32, pd=True, seed=1))
	d1, res1 = pt.diag(A, converge="count", count=40, seed=2, full=True, callback=lambda r: None)
	assert np.asarray(res1.info["state"]["m2"]).max() > 0
	d2 = pt.diag(A, converge="count", count=80, seed=2, resume=res1)
	d_direct = pt.diag(A, converge="count", count=80, seed=2)
	assert np.allclose(np.asarray(d2), np.asarray(d_direct), atol=1e-10)


def test_diag_sketchers_reject_stacked():
	A = pt.symmetric(24, pd=True, seed=3)
	M = pt.MatrixFunction(jnp.asarray(A), fun=pt.stacked("exp", [0.5, 1.0]), deg=8)
	for fn in (pt.diagpp, pt.xdiag):
		with pytest.raises(NotImplementedError, match="stacked"):
			fn(M, seed=0)


def test_diag_resume_rejects_batch_mismatch():
	"""Review r3: resuming with a different batch breaks the bit-identical
	probe-stream guarantee — rejected with a clear error."""
	import pytest

	A = pt.symmetric(32, pd=True, seed=11)
	_, r_half = pt.diag(A, seed=13, converge="count", count=6, batch=8, full=True)
	with pytest.raises(ValueError, match="batch"):
		pt.diag(A, seed=13, converge="count", count=12, batch=4, full=True, resume=r_half)


def test_diag_count_path_matches_while_loop_bitwise():
	"""The one-shot count path (round 5) must be bit-identical to the adaptive
	while_loop path — same probe stream, same sequential mean/m2 — including
	through resume across the two paths."""
	import primate_tpu.diagonal as D

	import scipy.sparse as sps

	from primate_tpu.operators import CSROperator

	# CSR's slot-ordered ELL apply is reduction-order-invariant across batch
	# widths, so the two paths are BITWISE equal (a dense GEMM's tiling order
	# varies with the block width — only allclose there).
	S = sps.random(96, 96, density=0.1, random_state=2, format="csr")
	S = S + S.T + sps.diags(np.abs(S).sum(axis=1).A1 + 1.0)
	A = CSROperator.from_scipy(S, dtype=jnp.float32)
	fast = pt.diag(A, converge="count", count=8, seed=11, batch=16)
	orig = D._DIAG_BLOCK_BUDGET
	try:
		D._DIAG_BLOCK_BUDGET = 0  # force the while_loop path
		slow = pt.diag(A, converge="count", count=8, seed=11, batch=16)
		_, r_half = pt.diag(A, converge="count", count=4, seed=11, batch=16, full=True)
	finally:
		D._DIAG_BLOCK_BUDGET = orig
	assert np.array_equal(np.asarray(fast), np.asarray(slow))
	# resume a while-loop-produced state through the count path
	resumed = pt.diag(A, converge="count", count=8, seed=11, batch=16, resume=r_half)
	assert np.array_equal(np.asarray(resumed), np.asarray(fast))
	# dense operators: same estimator, GEMM tiling differs -> allclose
	Ad = np.asarray(pt.symmetric(96, pd=True, seed=2), np.float32)
	fast_d = pt.diag(Ad, converge="count", count=8, seed=11, batch=16)
	try:
		D._DIAG_BLOCK_BUDGET = 0
		slow_d = pt.diag(Ad, converge="count", count=8, seed=11, batch=16)
	finally:
		D._DIAG_BLOCK_BUDGET = orig
	assert np.allclose(fast_d, slow_d, rtol=1e-4, atol=1e-4)
