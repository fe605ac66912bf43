"""Trace estimator tests (mirrors reference `tests/test_trace.py`)."""

import numpy as np
import pytest
import jax.numpy as jnp
import primate_tpu as pt
from primate_tpu.estimators import EstimatorResult


def _fixture(n=54, seed=1234):
	rng = np.random.default_rng(seed)
	ew = rng.uniform(size=n, low=1 / n, high=1.0)
	A = pt.symmetric(n, pd=True, ew=ew, seed=rng)
	return A, float(ew.sum()), rng


def test_hutch():
	A, tr, rng = _fixture()
	n = A.shape[0]
	est = pt.hutch(A, seed=rng)
	assert np.abs(tr - est) <= 10 * (1 / np.sqrt(n))

	est, info = pt.hutch(A, seed=rng, full=True)
	assert isinstance(info, EstimatorResult)
	assert info.nit > 0 and isinstance(info.message, str) and len(info.message) > 0


def test_hutch_callback_invoked():
	A, _, _ = _fixture()
	calls = []
	pt.hutch(A, callback=lambda r: calls.append(r.nit), seed=0)
	assert len(calls) > 0
	assert calls == sorted(calls)  # sample counts increase monotonically


def test_hutch_seed_reproducible():
	A, _, _ = _fixture(n=32)
	e1 = pt.hutch(A, seed=99, converge="count", count=96)
	e2 = pt.hutch(A, seed=99, converge="count", count=96)
	assert e1 == e2


def test_hutch_criterion_kwargs_routed():
	A, tr, _ = _fixture(n=32)
	est, info = pt.hutch(A, seed=1, converge="confidence", confidence=0.9, atol=0.5, full=True)
	assert np.isfinite(est)


def test_hutchpp():
	A, tr, rng = _fixture()
	n = A.shape[0]
	est = pt.hutchpp(A, m=n, seed=rng)
	assert np.abs(tr - est) <= 1 / np.sqrt(n)
	est, info = pt.hutchpp(A, m=n, seed=rng, full=True)
	assert isinstance(info, EstimatorResult)
	assert info.nit > 0 and info.samples is not None


def test_hutchpp_modes_agree():
	A, tr, _ = _fixture(n=33)
	e_red = pt.hutchpp(A, m=33, seed=5, mode="reduced")
	e_full = pt.hutchpp(A, m=33, seed=5, mode="full")
	assert np.isclose(e_red, e_full, atol=1e-8)


def test_hutch_mf_identity_composition():
	"""hutch(A) ≡ hutch(MatrixFunction(A, identity)) at the same seed — the key
	composition identity (reference `tests/test_trace.py:48-57`)."""
	rng = np.random.default_rng(1234)
	n = 50
	ew = rng.uniform(size=n, low=1 / n, high=1.0)
	A = pt.symmetric(n, pd=True, ew=ew, seed=rng)
	M = pt.MatrixFunction(A, deg=n, orth=n)
	est1 = pt.hutch(A, converge="count", count=150, seed=1234)
	est2 = pt.hutch(M, converge="count", count=150, seed=1234)
	assert np.isclose(est1, est2, atol=1e-6)


@pytest.mark.parametrize("pdf", ["rademacher", "normal", "sphere"])
def test_xtrace_exact_at_full_rank(pdf):
	"""XTrace at m == n: machine-exact for the sphere pdf (its leave-one-out
	scale makes the correction exact); small residual variance otherwise
	(verified the reference's own identities behave identically)."""
	A, tr, rng = _fixture(n=40)
	est = pt.xtrace(A, pdf=pdf, seed=rng)
	tol = 1e-6 if pdf == "sphere" else 0.25
	assert np.abs(tr - est) <= tol, f"pdf={pdf}: {est} vs {tr}"


@pytest.mark.parametrize("batch", [1, 7, 25, 50])
@pytest.mark.slow
def test_xtrace_batch_sizes(batch):
	A, tr, rng = _fixture(n=40)
	est = pt.xtrace(A, batch=batch, seed=rng)  # default pdf is sphere → exact
	assert np.abs(tr - est) <= 1e-2


def test_xtrace_full_result():
	A, tr, rng = _fixture(n=30)
	est, info = pt.xtrace(A, seed=rng, full=True)
	assert isinstance(info, EstimatorResult)
	assert info.nit == 30  # runs to m == n by default


def test_hutch_logdet_slq():
	"""Stochastic Lanczos quadrature: tr(log A) via hutch ∘ MatrixFunction."""
	rng = np.random.default_rng(8)
	n = 48
	ew = rng.uniform(size=n, low=0.5, high=2.0)
	A = pt.symmetric(n, pd=True, ew=ew, seed=rng)
	true_logdet = float(np.sum(np.log(ew)))
	M = pt.MatrixFunction(A, fun="log", deg=n, orth=-1)
	est = pt.hutch(M, seed=11, converge="count", count=600, batch=64)
	assert np.abs(est - true_logdet) / abs(true_logdet) < 0.05


def test_hutchpp_tiny_and_rounding():
	"""nb rounds UP to a multiple of 3 and stays ≥3 (no divide-by-zero NaN)."""
	est = pt.hutchpp(pt.symmetric(2, pd=True, seed=0), seed=1)
	assert np.isfinite(est)
	A = pt.symmetric(30, pd=True, seed=2)
	for m in (1, 4, 5):
		assert np.isfinite(pt.hutchpp(A, m=m, seed=3))


def test_xtrace_fused_round_matches_eager_path():
	"""The jitted per-round program (`_xtrace_round`, the accelerator path)
	reproduces the eager growth path bit-for-bit at m=n: exact trace."""
	import jax
	import jax.numpy as jnp
	import primate_tpu.trace as tr
	from primate_tpu.random import as_key

	n = 48
	A = pt.symmetric(n, pd=True, seed=3)
	op = pt.operators.DenseOperator(jnp.asarray(A))
	key = as_key(11)
	dt = op.dtype
	state = tuple(jnp.zeros(s, dt) for s in [(n, 0), (n, 0), (n, 0), (0, 0), (0, 0)])
	ts = None
	for it, ns in enumerate([16, 16, 16]):
		state, ts = tr._xtrace_round(op, *state, key, it, ns=ns, pdf="sphere", with_estimates=True)
	est = float(np.mean(np.asarray(ts)))
	true = float(np.trace(np.asarray(A)))
	assert abs(est - true) < 1e-6  # leave-one-out exactness at m == n

	# with_estimates=False returns the same state, empty estimates
	state2 = tuple(jnp.zeros(s, dt) for s in [(n, 0), (n, 0), (n, 0), (0, 0), (0, 0)])
	for it, ns in enumerate([16, 16, 16]):
		state2, t2 = tr._xtrace_round(op, *state2, key, it, ns=ns, pdf="sphere", with_estimates=False)
		assert t2.shape == (0,)
	for a, b in zip(state, state2):
		assert np.array_equal(np.asarray(a), np.asarray(b))


def test_hutchpp_reports_honest_matvec_count():
	"""nit = 3*nb (sketch + exact term + deflated probes); the reference
	reports 2*nb for the same three passes (`trace.py:180`) — not replicated."""
	import primate_tpu as pt

	A = np.asarray(pt.symmetric(30, pd=True, seed=0))
	est, res = pt.hutchpp(A, m=9, seed=1, full=True)
	assert res.nit == 27


def test_hutch_resume_bit_exact():
	"""Resuming from a checkpointed Welford state continues the SAME probe
	stream: split runs are bit-identical to one uninterrupted run (SURVEY §5.4)."""
	A = pt.symmetric(80, pd=True, seed=0)
	e_full, r_full = pt.hutch(A, batch=32, converge="count", count=1024, seed=9, full=True)
	e_half, r_half = pt.hutch(A, batch=32, converge="count", count=512, seed=9, full=True)
	e_res, r_res = pt.hutch(A, batch=32, converge="count", count=1024, seed=9, full=True, resume=r_half)
	assert r_res.nit == r_full.nit == 1024
	assert abs(e_full - e_res) < 1e-12

	# Round-trip the state through the checkpoint file format.
	import tempfile, os as _os
	from primate_tpu.estimators import MeanEstimator
	from primate_tpu.stats import CovState
	from primate_tpu.utils.checkpoint import load_pytree, save_pytree

	p = _os.path.join(tempfile.mkdtemp(), "ck")
	save_pytree(p, r_half.estimator._moments._state)
	est = MeanEstimator.from_state(CovState(*[np.asarray(x) for x in load_pytree(p)]))
	e_res2 = pt.hutch(A, batch=32, converge="count", count=1024, seed=9, resume=est)
	assert abs(e_full - e_res2) < 1e-12

	# Host-stepped (callback) path resumes identically and does not mutate the
	# caller's estimator (a second resume from the same snapshot stays valid).
	n_before = r_half.estimator.n_samples
	calls = []
	e_res3 = pt.hutch(
		A, batch=32, converge="count", count=1024, seed=9,
		resume=r_half.estimator, callback=lambda r: calls.append(r.nit),
	)
	assert abs(e_full - e_res3) < 1e-12
	assert r_half.estimator.n_samples == n_before
	assert calls[0] == 544 and calls[-1] == 1024


def test_xtrace_resume_bit_exact():
	"""xtrace resume: the grown subspace + round index continue the same probe
	stream — split runs ≡ one uninterrupted run, and resuming to the default
	m == n stop reaches exactness."""
	A = pt.symmetric(48, pd=True, seed=0)
	tr = float(np.trace(np.asarray(A)))
	e_full, r_full = pt.xtrace(A, batch=12, converge="count", count=48, seed=3, full=True)
	e_half, r_half = pt.xtrace(A, batch=12, converge="count", count=24, seed=3, full=True)
	e_res, r_res = pt.xtrace(A, batch=12, converge="count", count=48, seed=3, full=True, resume=r_half)
	assert r_res.nit == r_full.nit == 48
	assert abs(e_full - e_res) < 1e-9
	assert abs(e_res - tr) < 1e-6  # m == n exactness via the resumed path
	# Resuming at the stop recomputes (wholesale) instead of returning NaN.
	e_same, _ = pt.xtrace(A, batch=12, converge="count", count=48, seed=3, full=True, resume=r_res)
	assert abs(e_same - e_full) < 1e-9


def test_hutchpp_adaptive_mode():
	"""hutchpp(converge=...) deflates with a sketch then runs the adaptive hutch
	machinery on the projected remainder — big win over plain hutch on spiky
	spectra at the same sample count."""
	rng = np.random.default_rng(0)
	n = 150
	ew = np.concatenate([np.array([80.0, 50.0, 30.0]), rng.uniform(0.1, 1.0, n - 3)])
	A = pt.symmetric(n, pd=True, ew=ew, seed=1)
	tr = float(ew.sum())
	est, res = pt.hutchpp(A, m=18, converge="confidence", atol=0.5, seed=2, full=True)
	assert abs(est - tr) < 3.0
	assert "sketch_trace" in res.info and res.info["sketch_rank"] == 18
	# Deflation beats plain Hutchinson at the same residual sample count.
	e_plain = pt.hutch(A, batch=32, converge="count", count=max(res.nit, 32), seed=2)
	assert abs(est - tr) < abs(float(e_plain) - tr)
	# Non-adaptive path is unchanged by the new kwarg.
	e0 = pt.hutchpp(A, m=18, seed=2)
	assert abs(e0 - tr) < 6.0


def test_callable_pdf_key_style_fused():
	"""jax-style pdf(key, shape, dtype) callables ride inside the fused program
	(reference parity: hutch accepts Callable pdfs, `trace.py:34`)."""
	import jax.random as jr

	A, tr, _ = _fixture(50)

	def keypdf(key, shape, dtype):
		return jr.normal(key, shape, dtype)

	est = pt.hutch(A, pdf=keypdf, seed=1, converge="count", count=512)
	assert abs(est - tr) <= 10 / np.sqrt(50)
	# reproducible
	assert est == pt.hutch(A, pdf=keypdf, seed=1, converge="count", count=512)
	# sketch estimators take key-style callables too
	assert abs(pt.hutchpp(A, pdf=keypdf, seed=4) - tr) <= 10 / np.sqrt(50)
	assert abs(pt.xtrace(A, pdf=keypdf, seed=5) - tr) <= 10 / np.sqrt(50)


def test_callable_pdf_size_style_host():
	"""numpy-style pdf(size=...) closures (the reference's own convention,
	`trace.py:97`) run on the host-stepped path; fused-only estimators raise."""
	import pytest

	A, tr, _ = _fixture(50)
	rng = np.random.default_rng(7)

	def sizepdf(size=None):
		return rng.choice([-1.0, 1.0], size=size)

	est = pt.hutch(A, pdf=sizepdf, converge="count", count=256)
	assert abs(est - tr) <= 10 / np.sqrt(50)
	for fn in (pt.hutchpp, pt.xtrace, pt.xnystrace):
		with pytest.raises(NotImplementedError, match="jax-style"):
			fn(A, pdf=sizepdf, seed=1)


def test_xnystrace_tiny_operator_exact():
	"""n < 3 short-circuits to the exact trace (the leave-one-out sketch needs
	2 ≤ m ≤ N, impossible there); no NaN from a rank-deficient core."""
	for n in (1, 2):
		A = jnp.asarray(np.diag(np.arange(1.0, n + 1)))
		est = pt.xnystrace(A, seed=0)
		assert np.isclose(est, np.arange(1.0, n + 1).sum())


def test_sketch_estimators_reject_stacked_operators():
	"""hutchpp/xtrace/xnystrace fail fast on family-valued operators (their QR
	sketch has no single range); hutch handles the same operator fine."""
	A = pt.symmetric(32, pd=True, seed=0)
	M = pt.MatrixFunction(jnp.asarray(A), fun=pt.stacked("exp", [0.5, 1.0]), deg=10)
	for fn in (pt.hutchpp, pt.xtrace, pt.xnystrace):
		with pytest.raises(NotImplementedError, match="stacked"):
			fn(M, seed=0)


def test_hutch_resume_host_path_reports_accumulated_nit():
	"""A resumed run that is already converged reports the held sample count,
	not 0 — on BOTH the fused and the callback-forced host-stepped paths."""
	A = jnp.asarray(pt.symmetric(40, pd=True, seed=1))
	_, res = pt.hutch(A, converge="count", count=64, seed=3, full=True)
	_, res_fused = pt.hutch(A, converge="count", count=64, seed=3, full=True, resume=res)
	_, res_host = pt.hutch(A, converge="count", count=64, seed=3, full=True, resume=res, callback=lambda r: None)
	assert res_fused.nit == 64 and res_host.nit == 64


def test_hutchpp_adaptive_nit_includes_sketch_matvecs():
	A = jnp.asarray(pt.symmetric(64, pd=True, seed=2))
	_, res = pt.hutchpp(A, m=18, converge="count", count=64, seed=4, full=True)
	assert res.nit == 64 + 2 * 18  # residual samples + sketch/deflate applications


def test_xtrace_tolerance_criterion_can_fire():
	"""Review r3b: delta is the round-over-round estimate movement, so
	tolerance criteria stop xtrace before the full m = n budget."""
	A = pt.symmetric(60, pd=True, seed=3)
	est, res = pt.xtrace(np.asarray(A), batch=4, converge="tolerance", rtol=0.5, seed=5, full=True)
	assert res.nit < 60  # fired well before exactness (never fired pre-fix)
	est_full = pt.xtrace(np.asarray(A), batch=4, seed=5)
	assert abs(est - est_full) / abs(est_full) < 0.5


def test_hutch_rejects_zero_batch():
	A = pt.symmetric(16, pd=True, seed=0)
	with pytest.raises(AssertionError, match="positive"):
		pt.hutch(A, batch=0)
	with pytest.raises(AssertionError, match="positive"):
		pt.hutchpp(A, batch=0)


def test_xtrace_chain_fresh_matches_staged_chain():
	"""The fresh-start fused chain (state built inside the program)
	is bit-identical to seeding _xtrace_chain with host-side empty state —
	and both match the public xtrace estimate on the same schedule."""
	import primate_tpu.trace as tr
	from primate_tpu.operators import aslinop

	n, batch = 48, 16
	A = pt.symmetric(n, pd=True, seed=5)
	op = aslinop(jnp.asarray(A))
	key = tr.as_key(11)
	schedule = (batch, batch)
	state0 = (
		jnp.zeros((n, 0), op.dtype), jnp.zeros((n, 0), op.dtype), jnp.zeros((n, 0), op.dtype),
		jnp.zeros((0, 0), op.dtype), jnp.zeros((0, 0), op.dtype),
	)
	st_a, t_a = tr._xtrace_chain(op, key, state0, jnp.zeros((), jnp.int32), schedule=schedule, pdf="sphere")
	st_b, t_b = tr._xtrace_chain_fresh(op, key, schedule=schedule, pdf="sphere", n=n, dtype=op.dtype)
	assert np.array_equal(np.asarray(t_a), np.asarray(t_b))
	for a, b in zip(st_a, st_b):
		assert np.array_equal(np.asarray(a), np.asarray(b))
	est = pt.xtrace(jnp.asarray(A), batch=batch, converge="count", count=2 * batch, seed=11)
	assert np.isclose(float(np.mean(np.asarray(t_a))), float(est), rtol=1e-10)
