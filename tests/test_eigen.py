"""eigsh: blocked-LOBPCG extremal eigensolver (scipy-compatible surface)."""

import numpy as np
import pytest
import jax.numpy as jnp

import primate_tpu as pt


def _fixture(n=64, lo=0.5, hi=3.0, seed=1):
	ew = np.linspace(lo, hi, n)
	A = pt.symmetric(n, pd=True, ew=ew, seed=seed)
	return A, ew


def test_eigsh_largest_algebraic():
	A, ew = _fixture()
	w, V = pt.eigsh(A, k=4, which="LA", seed=0)
	assert np.allclose(w, ew[-4:], atol=1e-4)
	# Residual ‖AV − VΛ‖ and orthonormality
	r = np.asarray(A) @ V - V * w[None, :]
	assert np.abs(r).max() < 1e-3
	assert np.allclose(V.T @ V, np.eye(4), atol=1e-6)


def test_eigsh_smallest_algebraic():
	A, ew = _fixture()
	w = pt.eigsh(A, k=4, which="SA", seed=0, return_eigenvectors=False)
	assert np.allclose(w, ew[:4], atol=1e-4)


def test_eigsh_both_ends():
	A, ew = _fixture()
	w, _ = pt.eigsh(A, k=4, which="BE", seed=0)
	assert np.allclose(w, np.concatenate([ew[:2], ew[-2:]]), atol=1e-4)


def test_eigsh_largest_magnitude_indefinite():
	"""LM on an indefinite spectrum must pick the negative end when it wins."""
	ew = np.sort(np.concatenate([-np.linspace(2.5, 3.0, 3), np.linspace(0.2, 2.0, 61)]))
	B = pt.symmetric(64, ew=ew, seed=2)
	w = pt.eigsh(B, k=3, which="LM", seed=0, return_eigenvectors=False)
	assert np.allclose(np.sort(np.abs(w)), np.sort(np.abs(ew))[-3:], atol=1e-3)


def test_eigsh_on_sparse_operator():
	import scipy.sparse as sps
	from primate_tpu.operators.sparse import DIAOperator

	n = 256
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	op = DIAOperator.from_scipy(L, dtype=jnp.float64)
	kk = np.arange(1, n + 1)
	ew = np.sort(3.0 - 2.0 * np.cos(kk * np.pi / (n + 1)))
	w = pt.eigsh(op, k=3, which="LA", seed=0, return_eigenvectors=False)
	assert np.allclose(w, ew[-3:], atol=1e-6)


def test_eigsh_validates():
	A, _ = _fixture(16)
	with pytest.raises(AssertionError):
		pt.eigsh(A, k=16)
	with pytest.raises(AssertionError):
		pt.eigsh(A, k=2, which="XX")


def test_svds_matches_numpy():
	rng = np.random.default_rng(11)
	X = rng.normal(size=(80, 40)) @ np.diag(np.linspace(0.1, 4.0, 40)) 
	U, s, Vh = pt.svds(X, k=5, seed=0)
	s_true = np.linalg.svd(X, compute_uv=False)
	assert np.allclose(np.sort(s), np.sort(s_true)[-5:], rtol=1e-5)
	# Triplet consistency: X ≈ U diag(s) Vh on the recovered subspace
	assert np.allclose(X @ Vh.T, U * s[None, :], atol=1e-4)
	assert np.allclose(U.T @ U, np.eye(5), atol=1e-4)


def test_svds_wide_matrix():
	rng = np.random.default_rng(12)
	X = rng.normal(size=(30, 90))
	U, s, Vh = pt.svds(X, k=3, seed=1)
	s_true = np.linalg.svd(X, compute_uv=False)
	assert np.allclose(np.sort(s), np.sort(s_true)[-3:], rtol=1e-5)
	assert np.allclose(X @ Vh.T, U * s[None, :], atol=1e-4)
	assert np.allclose(Vh @ Vh.T, np.eye(3), atol=1e-4)


def test_svds_values_only_and_validation():
	rng = np.random.default_rng(13)
	X = rng.normal(size=(50, 20))
	s = pt.svds(X, k=2, seed=2, return_vectors=False)
	assert s.shape == (2,)
	with pytest.raises(AssertionError):
		pt.svds(X, k=20)


# ---- randomized low-rank approximation: rsvd / rand_nystrom ----------------


def test_rsvd_recovers_singular_triplets():
	rng = np.random.default_rng(0)
	m, n, k = 120, 80, 8
	sv = np.concatenate([np.linspace(10, 5, k), 1e-3 * rng.uniform(size=n - k)])
	U0, _ = np.linalg.qr(rng.normal(size=(m, n)))
	V0, _ = np.linalg.qr(rng.normal(size=(n, n)))
	X = (U0 * sv) @ V0.T
	U, s, Vh = pt.rsvd(X, k=k, seed=1)
	assert np.abs(s - sv[:k]).max() < 1e-5  # descending, like np.linalg.svd
	assert np.allclose(U.T @ U, np.eye(k), atol=1e-6)
	assert np.allclose(Vh @ Vh.T, np.eye(k), atol=1e-6)
	# Near-optimal reconstruction: within 1.5x of the best rank-k error.
	err = np.linalg.norm(X - (U * s) @ Vh)
	assert err < 1.5 * np.linalg.norm(sv[k:]) + 1e-6


def test_rsvd_matrix_free_and_seeded():
	"""rsvd runs on an implicit operator and is deterministic under a seed."""
	n = 64
	ew = np.concatenate([np.linspace(6, 3, 4), 1e-4 * np.ones(n - 4)])
	A = pt.symmetric(n, pd=True, ew=ew, seed=2)
	gram = pt.operators.GramOperator(A)  # implicit AᵀA, never formed
	U1, s1, _ = pt.rsvd(gram, k=4, seed=3)
	U2, s2, _ = pt.rsvd(gram, k=4, seed=3)
	assert np.array_equal(s1, s2) and np.array_equal(U1, U2)
	assert np.abs(s1 - np.sort(ew)[::-1][:4] ** 2).max() < 1e-4


def test_rand_nystrom_psd_factors():
	rng = np.random.default_rng(4)
	n, k = 100, 6
	ew = np.concatenate([np.linspace(20, 10, k), 1e-5 * rng.uniform(size=n - k)])
	A = pt.symmetric(n, ew=ew, pd=True, seed=5)
	w, U = pt.rand_nystrom(A, rank=k, seed=6)
	assert np.all(np.diff(w) <= 0)  # descending
	assert np.abs(w - ew[:k][np.argsort(ew[:k])[::-1]]).max() < 1e-3
	assert np.allclose(U.T @ U, np.eye(k), atol=1e-8)
	# PSD approximation error bounded by the tail mass.
	Ah = (U * w) @ U.T
	assert np.linalg.norm(np.asarray(A) - Ah, 2) < 10 * ew[k:].max() + 1e-3


def test_rand_nystrom_complex_hermitian():
	ew = np.concatenate([np.linspace(8, 4, 4), 1e-5 * np.ones(56)])
	H = pt.random.hermitian(60, ew=ew, seed=7)
	w, U = pt.rand_nystrom(H, rank=4, seed=8)
	assert np.abs(w - ew[:4]).max() < 1e-3
	assert np.allclose(np.conj(U).T @ U, np.eye(4), atol=1e-8)
	# Factors are genuinely complex eigenvector approximations: residual check.
	r = np.asarray(H) @ U - U * w[None, :]
	assert np.abs(r).max() < 0.05


def test_rand_nystrom_feeds_deflated_trace():
	"""The advertised workflow: Nyström factors → exact+stochastic trace split."""
	rng = np.random.default_rng(9)
	n, k = 80, 5
	ew = np.concatenate([np.linspace(50, 20, k), rng.uniform(0.1, 1.0, n - k)])
	A = pt.symmetric(n, ew=ew, pd=True, seed=10)
	w, U = pt.rand_nystrom(A, rank=k, seed=11)
	# Exact part = tr(U†AU), NOT Σw: Nyström eigenvalues are biased low under a
	# heavy tail, while the Rayleigh-quotient trace keeps the split exact for
	# ANY orthonormal U — tr(A) = tr(U†AU) + tr(PAP), P = I − UU†.
	Uj = jnp.asarray(U)
	exact = float(jnp.trace(jnp.conj(Uj).T @ (A @ Uj)))
	D = pt.operators.DeflatedOperator(A, Uj)
	rest = pt.hutch(D, converge="count", count=256, seed=12)
	est = exact + float(rest)
	# Variance comes only from the small tail, so the tolerance scales with it.
	assert abs(est - ew.sum()) < 10 / np.sqrt(n) * np.sqrt(ew[k:].max())


# ---------------------------------------------------------------- trlan


@pytest.mark.parametrize("which", ["LA", "SA", "LM", "BE"])
def test_eigsh_trlan_matches_spectrum(which):
	"""Thick-restart Lanczos recovers prescribed extremal eigenvalues."""
	rng = np.random.default_rng(1234)
	n, k = 200, 5
	ew = np.sort(rng.uniform(0.1, 2.0, n))
	A = pt.symmetric(n, ew=ew, seed=rng)
	w, V = pt.eigsh(A, k=k, which=which, seed=3, method="trlan")
	if which == "LA":
		expect = ew[-k:]
	elif which == "SA":
		expect = ew[:k]
	elif which == "LM":
		expect = np.sort(ew[np.argsort(-np.abs(ew))[:k]])
	else:  # BE
		expect = np.sort(np.concatenate([ew[: k // 2], ew[-(k - k // 2) :]]))
	assert np.abs(np.sort(w) - expect).max() < 1e-8
	r = np.asarray(A) @ V - V * w[None, :]
	assert np.abs(r).max() < 1e-6
	assert np.allclose(V.T @ V, np.eye(k), atol=1e-8)


def test_eigsh_trlan_indefinite_lm():
	"""LM on an indefinite spectrum picks the magnitude-dominant (negative) end."""
	ew = np.concatenate([np.linspace(-3, -1, 50), np.linspace(0.5, 2.5, 150)])
	A = pt.symmetric(200, ew=ew, seed=11)
	w = pt.eigsh(A, k=4, which="LM", seed=7, method="trlan", return_eigenvectors=False)
	expect = np.sort(ew[np.argsort(-np.abs(ew))[:4]])
	assert np.abs(np.sort(w) - expect).max() < 1e-8


def test_eigsh_trlan_complex_hermitian():
	ew = np.linspace(0.2, 3.0, 120)
	H = pt.random.hermitian(120, ew=ew, seed=5)
	w, V = pt.eigsh(H, k=3, which="LA", seed=11, method="trlan")
	assert np.abs(np.sort(w) - ew[-3:]).max() < 1e-7
	r = np.asarray(H) @ V - V * w[None, :]
	assert np.abs(r).max() < 1e-5


def test_eigsh_trlan_multiplicity_via_restarts():
	"""Restart randomization recovers a triple eigenvalue single-vector Lanczos
	would otherwise see once (one Krylov copy per distinct eigenvalue)."""
	ew = np.sort(np.concatenate([np.full(3, 2.0), np.linspace(0.1, 1.0, 97)]))
	A = pt.symmetric(100, ew=ew, seed=0)
	w = pt.eigsh(A, k=4, which="LA", seed=2, method="trlan", return_eigenvectors=False)
	assert np.abs(np.sort(w) - np.array([1.0, 2.0, 2.0, 2.0])).max() < 1e-7


def test_eigsh_trlan_early_breakdown_renewal():
	"""Five distinct eigenvalues: Krylov spans in ~5 steps, the cycle renews the
	basis with orthogonalized random directions instead of stalling."""
	ew = np.repeat(np.array([0.5, 1.0, 1.5, 2.0, 2.5]), 30)
	A = pt.symmetric(150, ew=ew, seed=1)
	w, V = pt.eigsh(A, k=3, which="LA", seed=4, method="trlan")
	assert np.abs(w - 2.5).max() < 1e-6  # top eigenvalue has multiplicity 30
	r = np.asarray(A) @ V - V * w[None, :]
	assert np.abs(r).max() < 1e-5


# ---------------------------------------------------- filtered (spectrum slicing)


def test_filtered_eigsh_recovers_interior_slice():
	"""Every eigenpair inside the interval, to near machine precision."""
	rng = np.random.default_rng(0)
	ew = np.sort(rng.uniform(0.0, 10.0, 300))
	A = pt.symmetric(300, ew=ew, seed=1)
	true = ew[(ew >= 4.0) & (ew <= 5.0)]
	w, V = pt.filtered_eigsh(A, (4.0, 5.0), seed=2)
	assert len(w) == len(true)
	assert np.abs(np.sort(w) - true).max() < 1e-6
	r = np.asarray(A) @ V - V * w[None, :]
	assert np.abs(r).max() < 1e-4
	assert np.allclose(V.T @ V, np.eye(len(w)), atol=1e-8)


def test_filtered_eigsh_grows_when_undercounted():
	"""k far below the true slice count: the sketch saturates and auto-grows."""
	ew = np.sort(np.concatenate([np.linspace(4.2, 4.8, 20), np.linspace(0, 10, 180)]))
	A = pt.symmetric(200, ew=ew, seed=6)
	true = ew[(ew >= 4.0) & (ew <= 5.0)]
	w, V = pt.filtered_eigsh(A, (4.0, 5.0), k=3, seed=7)
	assert len(w) == len(true)
	assert np.abs(np.sort(w) - true).max() < 1e-6


def test_filtered_eigsh_complex_hermitian():
	ew = np.linspace(-2, 2, 200)
	H = pt.random.hermitian(200, ew=ew, seed=4)
	true = ew[(ew >= -0.5) & (ew <= 0.5)]
	w, V = pt.filtered_eigsh(H, (-0.5, 0.5), seed=5)
	assert len(w) == len(true)
	assert np.abs(np.sort(w) - true).max() < 1e-6
	r = np.asarray(H) @ V - V * w[None, :]
	assert np.abs(r).max() < 1e-4


def test_filtered_eigsh_sparse_operator():
	import scipy.sparse as sps

	n = 400
	L = sps.diags([-np.ones(n - 1), 2.5 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	kk = np.arange(1, n + 1)
	lam = 2.5 - 2 * np.cos(kk * np.pi / (n + 1))
	true = np.sort(lam[(lam >= 2.0) & (lam <= 2.4)])
	w, V = pt.filtered_eigsh(L, (2.0, 2.4), seed=8)
	assert len(w) == len(true)
	assert np.abs(np.sort(w) - true).max() < 1e-6


def test_filtered_eigsh_empty_slice_and_outside_range():
	"""A spectral gap returns empty quickly (stall detector); an interval
	outside the spectral range returns empty immediately with a warning."""
	import warnings

	ew = np.concatenate([np.linspace(0.5, 2.0, 100), np.linspace(6.0, 8.0, 100)])
	A = pt.symmetric(200, ew=ew, seed=1)
	w, V = pt.filtered_eigsh(A, (3.0, 5.0), k=4, maxiter=30, seed=2)  # gap: no eigenvalues
	assert len(w) == 0 and V.shape == (200, 0)
	with warnings.catch_warnings(record=True) as ws:
		warnings.simplefilter("always")
		w2, V2 = pt.filtered_eigsh(A, (20.0, 30.0), seed=3)  # outside the range
	assert len(w2) == 0 and V2.shape == (200, 0)
	assert any("outside" in str(x.message) for x in ws)


def test_filtered_eigsh_unresolvable_slice_fails_fast():
	"""A slice far below the filter's Chebyshev resolution returns empty with a
	warning immediately instead of burning the whole iteration budget on
	ghosts (round-3 usability guard)."""
	import time
	import warnings

	import scipy.sparse as sps

	n = 2000
	L = sps.diags([-np.ones(n - 1), 2.1 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	kk = np.arange(1, n + 1)
	lam = np.sort(2.1 - 2 * np.cos(kk * np.pi / (n + 1)))
	mid = n // 2
	t0 = time.time()
	with warnings.catch_warnings(record=True) as w:
		warnings.simplefilter("always")
		ww, V = pt.filtered_eigsh(L, (float(lam[mid]), float(lam[mid + 1])), k=2, seed=1)
	assert len(ww) == 0 and V.shape == (n, 0)
	assert any("resolution" in str(x.message) for x in w)
	assert time.time() - t0 < 30  # no filter sweeps were run


def test_eigsh_complex_degenerate_eigenvalue_returns_k():
	"""Review r3e: a multiplicity-2 extremal eigenvalue of a complex Hermitian
	operator must yield BOTH eigenspace directions (the old pairwise-overlap
	dedup could drop the second genuine basis vector)."""
	rng = np.random.default_rng(7)
	n = 40
	ew = np.concatenate([np.linspace(0.1, 1.0, n - 2), [3.0, 3.0]])
	for seed in range(5):
		H = pt.random.hermitian(n, ew=ew, seed=seed)
		w, V = pt.eigsh(H, k=2, which="LA", seed=seed + 100)
		assert len(w) == 2 and V.shape == (n, 2)
		assert np.allclose(np.sort(w), [3.0, 3.0], atol=1e-3), (seed, w)
		# the two returned vectors span a genuine 2-D eigenspace
		G = V.conj().T @ V
		assert np.allclose(G, np.eye(2), atol=1e-4), seed
		R = np.asarray(H) @ V - V * w[None, :]
		assert np.linalg.norm(R, axis=0).max() < 1e-3, seed


def test_rand_nystrom_indefinite_roundoff_no_nan():
	"""Review r3e: a PSD-up-to-roundoff operator (small negative eigenvalue)
	must not silently return NaN factors from the core Cholesky."""
	rng = np.random.default_rng(3)
	n = 80
	ew = np.concatenate([[-1e-5], np.geomspace(2.0, 1e-3, n - 1)])  # decaying: rank-10 captures the top
	A = np.asarray(pt.symmetric(n, ew=ew, seed=5), np.float64)
	w, U = pt.rand_nystrom(A, rank=10, seed=7)
	assert np.all(np.isfinite(w)) and np.all(np.isfinite(U))
	assert np.all(w >= 0)
	# factors still approximate the dominant eigenspace (single-pass Nyström
	# with modest oversampling on a slow-decay spectrum: ~10% top-eigenvalue
	# underestimate is expected; the point here is finiteness)
	assert 1.5 < w[0] <= 2.0 + 1e-6


def test_eigsh_lobpcg_converges_at_large_n():
	"""The LOBPCG stop is a relative residual independent of n: at 64k rows
	the top eigenvalues of a clustered 3-D stencil reach rel 1e-4 (a stop
	that scaled with n quit after one iteration)."""
	import jax.numpy as jnp

	from benchmarks.matrices import fem_laplacian_3d
	from primate_tpu.operators.sparse import DIAOperator

	side = 40
	op = DIAOperator.from_scipy(fem_laplacian_3d(side), dtype=jnp.float32)
	mu = 2.0 - 2.0 * np.cos(np.arange(1, side + 1) * np.pi / (side + 1))
	lam = np.sort(1.0 + (mu[:, None, None] + mu[None, :, None] + mu[None, None, :]).ravel())[::-1][:6]
	w = np.sort(np.asarray(pt.eigsh(op, k=6, which="LA", seed=6, return_eigenvectors=False), np.float64))[::-1]
	assert np.max(np.abs(w - lam) / lam) < 1e-4
