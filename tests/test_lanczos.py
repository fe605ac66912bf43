"""Lanczos tests: spectrum recovery, Rayleigh-Ritz, batching equivalence.

Mirrors reference `tests/test_lanczos.py` and extends with the device-specific
single-probe vs batched-block equivalence checks (SURVEY §4).
"""

import numpy as np
import jax.numpy as jnp
import primate_tpu as pt


def test_lanczos_full_reorth_recovers_spectrum():
	rng = np.random.default_rng(1234)
	n = 30
	ew = rng.uniform(size=n, low=-1.0, high=1.0)
	A = pt.symmetric(n, ew=ew, seed=rng)
	a, b = pt.lanczos(A, deg=n, orth=n, seed=rng)
	rw = np.asarray(pt.eigvalsh_tridiag(a, b))
	assert np.allclose(np.sort(rw), np.sort(ew), atol=1e-10)


def test_rayleigh_ritz_extremes():
	rng = np.random.default_rng(1234)
	n = 50
	ew = rng.uniform(size=n, low=0.0, high=1.0)
	A = pt.symmetric(n, ew=ew, pd=True, seed=rng)
	rw = np.asarray(pt.rayleigh_ritz(A, deg=n, orth=-1, seed=rng))
	assert np.isclose(rw.min(), ew.min(), atol=1e-2)
	assert np.isclose(rw.max(), ew.max(), atol=1e-2)


def test_lanczos_basis_orthonormal():
	rng = np.random.default_rng(5)
	n = 24
	A = pt.symmetric(n, pd=True, seed=rng)
	(a, b), Q = pt.lanczos(A, deg=n, orth=n, return_basis=True, seed=rng)
	Q = np.asarray(Q)  # (n, deg)
	G = Q.T @ Q
	assert np.allclose(G, np.eye(n), atol=1e-8)
	# Q tridiagonalizes A: Qᵀ A Q should equal T(a, b)
	T = Q.T @ np.asarray(A) @ Q
	assert np.allclose(np.diag(T), np.asarray(a), atol=1e-8)
	assert np.allclose(np.diag(T, 1), np.asarray(b), atol=1e-8)


def test_lanczos_batched_equals_single():
	"""One fused block sweep must reproduce per-probe serial sweeps."""
	rng = np.random.default_rng(7)
	n, nv, deg = 20, 4, 12
	A = pt.symmetric(n, pd=True, seed=rng)
	V0 = rng.normal(size=(n, nv))
	ab_batched = pt.lanczos(A, v0=V0, deg=deg, orth=deg)
	for j in range(nv):
		a_j, b_j = pt.lanczos(A, v0=V0[:, j], deg=deg, orth=deg)
		assert np.allclose(np.asarray(ab_batched[0][:, j]), np.asarray(a_j), atol=1e-10)
		assert np.allclose(np.asarray(ab_batched[1][:, j]), np.asarray(b_j), atol=1e-10)


def test_lanczos_early_exit_invariant_subspace():
	"""Starting inside an invariant subspace must terminate cleanly (β → 0)."""
	n = 16
	ew = np.zeros(n)
	ew[:3] = [1.0, 2.0, 3.0]
	U = np.linalg.qr(np.random.default_rng(0).normal(size=(n, n)))[0]
	A = U @ np.diag(ew) @ U.T
	v0 = U[:, :3] @ np.ones(3)  # lives in the rank-3 invariant subspace
	a, b = pt.lanczos(jnp.asarray(A), v0=v0, deg=10, orth=10, rtol=1e-7)
	# After ~3 steps the recurrence must deflate: trailing alphas are zero.
	assert np.allclose(np.asarray(a)[4:], 0.0, atol=1e-8)
	rw = np.sort(np.asarray(pt.eigvalsh_tridiag(a, b)))
	assert np.allclose(rw[-3:], [1.0, 2.0, 3.0], atol=1e-8)


def test_lanczos_no_reorth_still_tridiagonalizes():
	rng = np.random.default_rng(11)
	n = 12
	A = pt.symmetric(n, pd=True, seed=rng)
	a, b = pt.lanczos(A, deg=6, orth=0, seed=rng)
	assert np.asarray(a).shape == (6,) and np.asarray(b).shape == (5,)
	assert np.all(np.isfinite(np.asarray(a))) and np.all(np.isfinite(np.asarray(b)))


def test_rayleigh_ritz_batched_probes():
	"""Block v0 (n, nv): Ritz values must match the per-column results
	(regression: batched (deg, nv) coefficients need transposing for eigh)."""
	import jax.numpy as jnp

	A = pt.symmetric(24, pd=True, seed=3)
	V0 = np.random.default_rng(4).normal(size=(24, 3))
	rw = np.asarray(pt.rayleigh_ritz(A, deg=24, orth=-1, v0=jnp.asarray(V0)))
	assert rw.shape == (3, 24)
	for j in range(3):
		rw_j = np.asarray(pt.rayleigh_ritz(A, deg=24, orth=-1, v0=jnp.asarray(V0[:, j])))
		assert np.allclose(np.sort(rw[j]), np.sort(rw_j), atol=1e-8)


def test_lanczos_windowed_basis_natural_order():
	"""With ncv < deg the ring-buffer window must come back in natural order
	q_{deg-ncv}..q_{deg-1} (regression: rotated slot order)."""
	import jax.numpy as jnp

	A = pt.symmetric(16, pd=True, seed=5)
	v0 = np.random.default_rng(6).normal(size=16)
	# orth=0: the recurrence is independent of the window size, so the full
	# basis is the ground truth for the windowed run.
	(_, _), Q_full = pt.lanczos(A, v0=jnp.asarray(v0), deg=10, orth=0, ncv=10, return_basis=True)
	(_, _), Q_win = pt.lanczos(A, v0=jnp.asarray(v0), deg=10, orth=0, ncv=4, return_basis=True)
	assert np.allclose(np.asarray(Q_win), np.asarray(Q_full)[:, -4:], atol=1e-10)


def test_bf16_basis_window_keeps_accuracy():
	"""`basis_dtype=bf16` truncates only the re-orth window storage: Jacobi
	coefficients (and hence quadrature) stay within ~1e-4 of the f32-window
	run, and full re-orth still recovers a prescribed spectrum."""
	import jax
	import jax.numpy as jnp
	from primate_tpu.lanczos import lanczos_block

	rng = np.random.default_rng(11)
	n = 120
	ew = rng.uniform(0.1, 1.0, n)
	A = pt.symmetric(n, pd=True, ew=ew, seed=rng)
	Af = jnp.asarray(A, jnp.float32)
	V0 = jax.random.normal(jax.random.PRNGKey(4), (n, 4), jnp.float32)

	out32 = lanczos_block(lambda X: Af @ X, V0, deg=20, ncv=5, orth=5, rtol=0.0)
	outbf = lanczos_block(lambda X: Af @ X, V0, deg=20, ncv=5, orth=5, rtol=0.0, basis_dtype=jnp.bfloat16)
	assert outbf.Q.dtype == jnp.bfloat16
	assert np.allclose(np.asarray(out32.alphas), np.asarray(outbf.alphas), atol=1e-3)
	assert np.allclose(np.asarray(out32.betas), np.asarray(outbf.betas), atol=1e-3)

	full = lanczos_block(lambda X: Af @ X, V0[:, :1], deg=n, ncv=n, orth=n, rtol=0.0, basis_dtype=jnp.bfloat16)
	a = np.asarray(full.alphas[:, 0], float)
	b = np.asarray(full.betas[: n - 1, 0], float)
	evs = np.sort(np.asarray(pt.eigvalsh_tridiag(a, b)))
	assert np.abs(evs - np.sort(ew)).max() < 1e-3


def test_orthogonal_polynomial_basis():
	"""OrthogonalPolynomialBasis: evaluation ≡ ortho_poly; Gauss rule of the
	basis integrates p_d·p_e to δ_de; jacobi_matrix eigenvalues = nodes."""
	rng = np.random.default_rng(13)
	n = 14
	A = pt.symmetric(n, pd=True, seed=rng)
	basis = pt.OrthogonalPolynomialBasis(A, deg=n, orth=n, seed=3)
	assert len(basis) == n

	theta, tau = basis.gauss_quadrature()
	P = np.asarray(basis(np.asarray(theta)))  # (n, n)
	G = np.einsum("j,jd,je->de", np.asarray(tau), P, P)
	assert np.allclose(G, np.eye(n), atol=1e-6)

	J = np.asarray(basis.jacobi_matrix())
	assert np.allclose(np.sort(np.linalg.eigvalsh(J)), np.sort(np.asarray(theta)), atol=1e-10)

	# direct construction from coefficients matches
	b2 = pt.OrthogonalPolynomialBasis(alphas=np.asarray(basis.alphas), betas=np.asarray(basis.betas[1:]))
	assert np.allclose(np.asarray(b2(np.linspace(0, 1, 9))), np.asarray(basis(np.linspace(0, 1, 9))))


def test_orthogonal_polynomial_basis_robustness():
	"""Review fixes: early-termination truncation (no inf/NaN), ambiguous
	(deg,)-betas rejection, trailing/offdiag convention agreement, and the
	unknown-kwargs warning on lanczos()."""
	import warnings

	import jax
	import jax.numpy as jnp
	import pytest
	from primate_tpu.lanczos import lanczos_block

	# Identity: Lanczos terminates after one step; basis truncates to p_0 only.
	b = pt.OrthogonalPolynomialBasis(jnp.eye(8, dtype=jnp.float32), deg=8, seed=0)
	P = np.asarray(b(np.linspace(-1.0, 2.0, 5)))
	assert len(b) == 1 and np.isfinite(P).all()

	A = pt.symmetric(10, pd=True, seed=1)
	out = lanczos_block(
		lambda X: jnp.asarray(A, jnp.float32) @ X,
		jax.random.normal(jax.random.PRNGKey(0), (10, 1), jnp.float32),
		deg=6, ncv=6, orth=6, rtol=0.0,
	)
	a_, bt_ = np.asarray(out.alphas[:, 0]), np.asarray(out.betas[:, 0])
	with pytest.raises(AssertionError, match="ambiguous"):
		pt.OrthogonalPolynomialBasis(alphas=a_, betas=bt_)
	x = np.linspace(0.0, 1.0, 7)
	trailing = pt.OrthogonalPolynomialBasis(alphas=a_, betas=bt_, betas_kind="trailing")
	offdiag = pt.OrthogonalPolynomialBasis(alphas=a_, betas=bt_[:5])
	assert np.allclose(np.asarray(trailing(x)), np.asarray(offdiag(x)))

	with warnings.catch_warnings(record=True) as w:
		warnings.simplefilter("always")
		pt.lanczos(A, deg=4, bogus_kwarg=1)
	assert any("bogus_kwarg" in str(x.message) for x in w)


def test_bf16_basis_auto_two_pass_matvec_accuracy():
	"""basis_dtype=bf16 with two_pass='auto' keeps matvec near f32 accuracy
	(the one-pass path would reconstruct y from the truncated window)."""
	import jax
	import jax.numpy as jnp

	n = 150
	A = pt.symmetric(n, pd=True, seed=2)
	M32 = pt.MatrixFunction(A, fun="exp", deg=25, orth=8, dtype=jnp.float32)
	Mbf = pt.MatrixFunction(A, fun="exp", deg=25, orth=8, dtype=jnp.float32, basis_dtype=jnp.bfloat16)
	assert Mbf._use_two_pass(4) and not M32._use_two_pass(4)
	V = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (n, 4), jnp.float32))
	y32, ybf = np.asarray(M32 @ V), np.asarray(Mbf @ V)
	assert np.abs(y32 - ybf).max() / np.abs(y32).max() < 5e-4


def test_bf16_operator_keeps_f32_jacobi_coefficients():
	"""The core accumulates α/β in f32 for low-precision operators; the public
	driver must not cast them back down to bf16 (3-digit Ritz values)."""
	import jax.numpy as jnp

	ew = np.linspace(0.5, 2.0, 64)
	A = np.asarray(pt.symmetric(64, ew=ew, seed=1))
	a, b = pt.lanczos(jnp.asarray(A, jnp.bfloat16), deg=64, orth=-1, seed=2)
	assert a.dtype == jnp.float32 and b.dtype == jnp.float32
	rw = np.sort(np.asarray(pt.eigvalsh_tridiag(a, b)))
	# bf16 MATVECS limit accuracy (~1e-2); bf16 COEFFICIENTS would be ~1e-1.
	assert np.abs(rw - ew).max() < 2e-2
