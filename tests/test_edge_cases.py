"""Edge shapes and degenerate inputs: the reference's validation/clamping rules."""

import numpy as np
import pytest
import jax.numpy as jnp

import primate_tpu as pt


def test_lanczos_deg_one():
	A = pt.symmetric(8, pd=True, seed=0)
	a, b = pt.lanczos(A, deg=1)
	assert np.asarray(a).shape == (1,) and np.asarray(b).shape == (0,)


def test_lanczos_deg_clamped_to_n():
	A = pt.symmetric(6, pd=True, seed=1)
	a, b = pt.lanczos(A, deg=100, orth=-1)  # deg clamps to n
	assert np.asarray(a).shape == (6,)
	ew = np.linalg.eigvalsh(np.asarray(A))
	assert np.allclose(np.sort(np.asarray(pt.eigvalsh_tridiag(a, b))), ew, atol=1e-8)


def test_lanczos_rejects_bad_v0():
	A = pt.symmetric(8, seed=2)
	with pytest.raises(AssertionError):
		pt.lanczos(A, v0=np.ones(5))


def test_hutch_single_probe_batch():
	A = pt.symmetric(16, pd=True, seed=3)
	est = pt.hutch(A, batch=1, converge="count", count=64, seed=4)
	assert np.isfinite(est)


def test_hutch_tiny_matrix():
	A = jnp.asarray([[2.0]])
	est = pt.hutch(A, converge="count", count=16, seed=5)
	assert abs(est - 2.0) < 1e-6  # 1x1: every quadratic form is exact


def test_xtrace_batch_larger_than_n():
	A = pt.symmetric(10, pd=True, seed=6)
	est = pt.xtrace(A, batch=64, seed=7)  # clamps to n columns
	assert abs(est - float(jnp.trace(jnp.asarray(A)))) < 1e-6


def test_diag_tiny():
	A = pt.symmetric(4, pd=True, seed=8)
	d = pt.diag(A, seed=9, converge="count", count=400)
	assert np.allclose(np.asarray(d), np.diag(np.asarray(A)), atol=0.3)


def test_matrix_function_min_degree():
	A = pt.symmetric(12, pd=True, seed=10)
	M = pt.MatrixFunction(A, fun="identity", deg=2, orth=-1)
	v = np.random.default_rng(0).normal(size=12)
	out = np.asarray(M @ v)
	assert np.all(np.isfinite(out))
	with pytest.raises(AssertionError):
		pt.MatrixFunction(A, deg=1)


def test_quadrature_single_node():
	nodes, weights = pt.quadrature(jnp.asarray([2.0]), jnp.zeros(0), deg=1)
	assert np.allclose(np.asarray(nodes), [2.0]) and np.allclose(np.asarray(weights), [1.0])


def test_mean_estimator_empty():
	est = pt.MeanEstimator()
	assert est.n_samples == 0
	assert np.isnan(est.estimate)


def test_hutchpp_small_m():
	A = pt.symmetric(30, pd=True, seed=11)
	est = pt.hutchpp(A, m=3, seed=12)
	assert np.isfinite(est)


def test_scipy_bridge_works_without_x64():
	"""Regression: a scipy LinearOperator advertising float64 must still work
	when jax_enable_x64 is OFF (JAX's default) — the pure_callback result
	spec is canonicalized to f32 instead of crashing."""
	import subprocess, sys, textwrap

	code = textwrap.dedent("""
		import jax
		jax.config.update("jax_platforms", "cpu")   # x64 stays OFF
		import numpy as np, scipy.sparse as sp, scipy.sparse.linalg as spla
		import primate_tpu as pt
		n = 48
		M = sp.eye(n, format="csr") * 3.0
		est = pt.hutch(spla.aslinearoperator(M), seed=1, converge="count", count=16)
		assert abs(est - 3.0 * n) < 1e-3, est
		print("OK")
	""")
	r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
	assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]


def test_block_lanczos_tiny_matrix_default_width():
	"""Regression: default b=4 on a 3x3 operator clamps instead of crashing."""
	from primate_tpu.block_krylov import block_jacobi_dense, block_lanczos

	A = np.diag([1.0, 2.0, 3.0])
	out = block_lanczos(A, seed=0)  # default b=4 > n=3
	T = np.asarray(block_jacobi_dense(out.Ablocks, out.Bblocks))
	assert np.allclose(np.sort(np.linalg.eigvalsh(T)), [1.0, 2.0, 3.0], atol=1e-8)


def test_block_lanczos_no_recompile_across_matrices():
	"""Regression: the core is cached by operator STRUCTURE — two different
	same-shaped matrices share one compiled executable."""
	import jax
	from primate_tpu.block_krylov import _block_lanczos_core
	from primate_tpu.operators import DenseOperator

	V0 = jnp.asarray(np.random.default_rng(0).normal(size=(16, 4)))
	A1 = DenseOperator(jnp.asarray(pt.symmetric(16, pd=True, seed=1)))
	A2 = DenseOperator(jnp.asarray(pt.symmetric(16, pd=True, seed=2)))
	_block_lanczos_core(A1, V0, deg=3)
	n_compiles = _block_lanczos_core._cache_size()
	_block_lanczos_core(A2, V0, deg=3)
	assert _block_lanczos_core._cache_size() == n_compiles


def test_classify_pdf_uninspectable_callable_is_size():
	"""Regression: samplers with no inspectable signature (C-implemented)
	classify as numpy-style 'size' callables, not jax-style 'key' ones."""
	import time

	from primate_tpu.random import classify_pdf

	# time.time is a C builtin whose signature inspect.signature() rejects —
	# a stand-in for C-implemented/wrapped numpy-style samplers.
	assert classify_pdf(time.time) == "size"
	# numpy Generator methods carry a real `size=` signature → "size" directly
	assert classify_pdf(np.random.default_rng(0).standard_normal) == "size"


def test_clt_quantile_ladder_is_shared():
	"""ConfidenceCriterion / ConfidenceEstimator / suggest_probes use ONE
	quantile construction."""
	from primate_tpu.estimators import clt_quantiles

	z, t = clt_quantiles(0.95)
	crit = pt.ConfidenceCriterion(confidence=0.95)
	est = pt.ConfidenceEstimator(confidence=0.95)
	assert np.isclose(crit.z, z) and np.isclose(est._z, z)
	assert np.allclose(np.asarray(crit.t_scores), t.astype(np.float32))
	assert np.allclose(est._t, t)


def test_suggest_probes_pdf_reaches_pilot():
	"""Regression: pdf= forwards to the pilot run. On A = c·I the Rademacher
	quad form is EXACT (variance 0 → pilot minimum), Gaussian probes are not."""
	A = np.eye(64) * 2.0
	nv_rad, info_rad = pt.recipes.suggest_probes(A, eps=0.001, pilot=16, seed=3, full=True)
	nv_nrm, info_nrm = pt.recipes.suggest_probes(A, eps=0.001, pdf="normal", pilot=16, seed=3, full=True)
	assert info_rad["variance"] < 1e-8 and nv_rad == 16
	assert info_nrm["variance"] > 1.0 and nv_nrm > 16
