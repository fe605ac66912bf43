"""Batched CG solver tests, including the full GP log-likelihood composition."""

import numpy as np
import pytest
import jax
import scipy.sparse as sps
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu.operators.sparse import DIAOperator
from primate_tpu.solvers import cg, solve


def _spd(n=64, seed=0):
	ew = np.random.default_rng(seed).uniform(0.5, 2.0, n)
	return np.asarray(pt.symmetric(n, pd=True, ew=ew, seed=seed))


def test_cg_single_rhs():
	A = _spd()
	b = np.random.default_rng(1).normal(size=64)
	x = np.asarray(cg(A, b, rtol=1e-10))
	assert np.allclose(A @ x, b, atol=1e-6)


def test_cg_block_rhs_and_full():
	A = _spd()
	B = np.random.default_rng(2).normal(size=(64, 5))
	X, nit, res = cg(A, B, rtol=1e-10, full=True)
	assert np.allclose(A @ np.asarray(X), B, atol=1e-6)
	assert res.shape == (5,) and nit <= 640


def test_cg_jacobi_preconditioner_on_illconditioned():
	n = 80
	d = np.logspace(0, 4, n)
	A = np.diag(d) + 0.1 * _spd(n, seed=3)
	A = (A + A.T) / 2
	b = np.random.default_rng(4).normal(size=n)
	x_pc, nit_pc, _ = cg(jnp.asarray(A), b, rtol=1e-8, precond="jacobi", full=True)
	x, nit, _ = cg(jnp.asarray(A), b, rtol=1e-8, full=True)
	assert np.allclose(A @ np.asarray(x_pc), b, atol=1e-3 * np.linalg.norm(b))
	assert nit_pc <= nit  # Jacobi helps on a diagonally dominated spectrum


def test_cg_on_sparse_dia():
	n = 256
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1])
	op = DIAOperator.from_scipy(L)
	b = np.random.default_rng(5).normal(size=n)
	x = np.asarray(solve(op, b, rtol=1e-10, precond="jacobi"))
	assert np.allclose(L @ x, b, atol=1e-6)


def test_gp_log_likelihood_composition():
	"""-2·loglik = logdet(K) + yᵀK⁻¹y + n·log(2π): SLQ + CG end to end."""
	n = 96
	ew = np.random.default_rng(6).uniform(0.5, 2.0, n)
	K = np.asarray(pt.symmetric(n, pd=True, ew=ew, seed=6))
	y = np.random.default_rng(7).normal(size=n)

	ld = pt.recipes.logdet(K, deg=40, orth=-1, converge="count", count=512, seed=8)
	quad = float(y @ np.asarray(solve(K, y, rtol=1e-10)))

	true_ld = np.linalg.slogdet(K)[1]
	true_quad = float(y @ np.linalg.solve(K, y))
	assert abs(ld - true_ld) / abs(true_ld) < 0.1
	assert abs(quad - true_quad) / abs(true_quad) < 1e-6


def test_nystrom_preconditioner_spiky_spectrum():
	"""On a GP-like spectrum (few dominant eigenvalues + flat bulk) the Nyström
	preconditioner must slash the CG iteration count vs no preconditioning."""
	from primate_tpu.solvers import nystrom_precond

	n = 256
	ew = np.concatenate([np.linspace(1.0, 2.0, n - 8), np.geomspace(50.0, 5000.0, 8)])
	K = np.asarray(pt.symmetric(n, pd=True, ew=ew, seed=10), np.float64)
	b = np.random.default_rng(11).normal(size=n)

	x0, nit0, _ = cg(jnp.asarray(K), b, rtol=1e-8, full=True)
	pre = nystrom_precond(jnp.asarray(K), rank=16, seed=12)
	x1, nit1, _ = cg(jnp.asarray(K), b, rtol=1e-8, precond=pre, full=True)
	assert np.allclose(K @ np.asarray(x1), b, atol=1e-5 * np.linalg.norm(b))
	assert nit1 < 0.5 * nit0, (nit1, nit0)

	# String spelling builds the preconditioner internally.
	x2, nit2, _ = cg(jnp.asarray(K), b, rtol=1e-8, precond="nystrom", precond_rank=16, precond_seed=12, full=True)
	assert nit2 == nit1
	assert np.allclose(np.asarray(x2), np.asarray(x1), atol=1e-8)


def test_nystrom_precond_apply_is_spd():
	"""P⁻¹ must be symmetric positive definite for CG to be valid."""
	from primate_tpu.solvers import nystrom_precond

	n = 64
	K = np.asarray(pt.symmetric(n, pd=True, seed=13), np.float64)
	pre = nystrom_precond(jnp.asarray(K), rank=12, seed=14)
	Pinv = np.asarray(pre.apply_t(jnp.eye(n, dtype=jnp.float64)))
	assert np.allclose(Pinv, Pinv.T, atol=1e-12)
	assert np.linalg.eigvalsh(Pinv).min() > 0


def test_nystrom_precond_differentiable_path():
	"""The preconditioner pytree flows through the custom_linear_solve program."""
	n = 48
	ew = np.concatenate([np.linspace(0.5, 1.0, n - 4), [30.0, 40.0, 60.0, 80.0]])
	K = jnp.asarray(np.asarray(pt.symmetric(n, pd=True, ew=ew, seed=15), np.float64))
	b = jnp.asarray(np.random.default_rng(16).normal(size=n))

	from primate_tpu.solvers import nystrom_precond

	pre = nystrom_precond(K, rank=8, seed=17)

	def quad(Kmat):
		return jnp.dot(b, solve(Kmat, b, rtol=1e-10, precond=pre))

	g = jax.grad(quad)(K)
	# d(bᵀK⁻¹b)/dK = −K⁻¹b bᵀK⁻¹ (symmetrized by the solve structure)
	x = np.linalg.solve(np.asarray(K), np.asarray(b))
	assert np.allclose(np.asarray(g), -np.outer(x, x), atol=1e-6)


def test_cg_warm_start_stops_at_documented_tolerance():
	"""rtol is relative to ‖b‖ on BOTH paths — a good warm start must not force
	the shifted system to a much stricter absolute target."""
	ew = np.linspace(0.5, 4.0, 64)
	K = jnp.asarray(pt.symmetric(64, pd=True, ew=ew, seed=3))
	b = jnp.asarray(np.random.default_rng(4).normal(size=64))
	x_cold = pt.cg(K, b, rtol=1e-6)
	x0 = x_cold + 1e-3 * jnp.asarray(np.random.default_rng(5).normal(size=64))
	x_warm = pt.cg(K, b, X0=x0, rtol=1e-6)
	rw = np.linalg.norm(np.asarray(K @ x_warm - b)) / np.linalg.norm(np.asarray(b))
	assert rw <= 2e-6  # meets the documented target (with fp slack), not 1e-6·‖b−K·x0‖/‖b‖


def test_nystrom_precond_rank_deficient_spectrum():
	"""Review r3c: sketch rank past the numerical rank must yield a PD
	preconditioner (lam_s floor), not the singular I - UU^T that diverged."""
	from primate_tpu.solvers import cg, nystrom_precond

	n = 200
	lam = np.maximum(10 * np.exp(-0.8 * np.arange(n)), 1e-6)
	A = np.asarray(pt.symmetric(n, pd=True, ew=lam[::-1], seed=1))
	b = np.random.default_rng(0).normal(size=n)
	P = nystrom_precond(A, rank=64, seed=5)
	assert np.all(np.isfinite(np.asarray(P.coef))) and float(np.asarray(P.coef).min()) > -1.0
	x, it, _ = cg(A, b, precond=P, rtol=1e-8, maxiter=1000, full=True)
	rel = float(np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b))
	assert rel < 1e-6 and int(np.asarray(it)) < 100, (rel, int(np.asarray(it)))


def test_jacobi_precond_clamps_stochastic_diag():
	"""Review r3c: the stochastic diagonal estimate is clamped positive before
	inversion — a noisy <=0 entry must not flip the preconditioned residual."""
	from primate_tpu.solvers import _stochastic_diag, DiagPreconditioner, cg
	from primate_tpu.operators import FunctionOperator

	n = 120
	rng = np.random.default_rng(3)
	ew = rng.uniform(0.05, 2.0, n)
	A = np.asarray(pt.symmetric(n, pd=True, ew=ew, seed=4))
	Aj = jnp.asarray(A)
	op = FunctionOperator(lambda X: Aj @ X, (n, n), dtype=Aj.dtype, batched=True)  # matrix-free: forces estimation
	b = rng.normal(size=n)
	x = cg(op, jnp.asarray(b), precond="jacobi", rtol=1e-8, maxiter=2000)
	rel = float(np.linalg.norm(A @ np.asarray(x) - b) / np.linalg.norm(b))
	assert rel < 1e-5, rel


def test_jacobi_precond_exact_on_wide_dynamic_range():
	"""A legitimate SPD diagonal spanning >3 orders of magnitude must get the
	EXACT 1/d Jacobi preconditioner; non-positive entries still get floored, with a
	warning."""
	import warnings as _w

	n = 64
	d = np.logspace(-6, 2, n)  # 8 orders of magnitude, all positive
	A = np.diag(d)
	b = np.ones(n)
	with _w.catch_warnings():
		_w.simplefilter("error")  # exact path must NOT warn
		x, nit, _ = cg(jnp.asarray(A), jnp.asarray(b), rtol=1e-10, precond="jacobi", full=True)
	# Exact Jacobi on a diagonal matrix converges in one iteration.
	assert nit <= 2, nit
	assert np.allclose(np.asarray(x), b / d, rtol=1e-6)

	# A (stochastic-estimate-like) diagonal with a negative entry: floored + warned.
	d_bad = d.copy()
	d_bad[3] = -1.0
	with pytest.warns(UserWarning, match="floored"):
		x2 = cg(jnp.asarray(A), jnp.asarray(b), rtol=1e-8, precond=jnp.asarray(d_bad), full=True)[0]
	assert np.allclose(np.asarray(x2), b / d, rtol=1e-5)


def test_jacobi_weights_provenance_floor_policy():
	"""Exact diagonals keep exact 1/d for any positive entry; stochastic
	estimates floor tiny-positive entries too (review r4: exact 1/d of a noisy
	near-zero estimate is a huge wrong weight that stalls PCG)."""
	from primate_tpu.solvers import _jacobi_weights

	d = jnp.asarray(np.array([1.0, 1e-7, -0.5]))
	with pytest.warns(UserWarning, match="floored"):
		w_exact = np.asarray(_jacobi_weights(d, False, jnp.float64))
	assert np.isclose(w_exact[1], 1e7)  # legit tiny entry: exact weight
	floor_w = w_exact[2]
	assert floor_w < 1e5  # negative entry: floored
	with pytest.warns(UserWarning, match="floored"):
		w_stoch = np.asarray(_jacobi_weights(d, True, jnp.float64))
	assert np.isclose(w_stoch[1], floor_w) and np.isclose(w_stoch[2], floor_w)
	assert np.isclose(w_stoch[0], 1.0)
