"""Complex-Hermitian operator support (beyond the real-symmetric reference).

Quantum/tight-binding Hamiltonians — KPM's and SLQ's home turf — are complex
Hermitian. The Lanczos recurrence conjugates the bra side of every inner
product; α/β (hence the Jacobi matrix, quadrature, and all estimator state)
stay REAL, and probes stay real (unbiased: E[vvᵀ] = I and v†Av ∈ ℝ).
"""

import numpy as np
import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu.lanczos import lanczos_block
from primate_tpu.random import hermitian
from primate_tpu.tridiag import eigvalsh_tridiag


def _herm(n, ew, seed):
	A = np.asarray(hermitian(n, ew=ew, seed=seed))
	assert np.allclose(A, A.conj().T)
	return jnp.asarray(A)


def test_hermitian_fixture_spectrum():
	ew = np.sort(np.random.default_rng(0).uniform(0.1, 2.0, 32))
	A = _herm(32, ew, seed=1)
	got = np.linalg.eigvalsh(np.asarray(A))
	assert np.allclose(got, ew, atol=1e-12)
	assert np.asarray(A).dtype == np.complex128


def test_lanczos_block_complex_recovers_spectrum():
	rng = np.random.default_rng(2)
	n = 40
	ew = rng.uniform(0.5, 2.0, n)
	A = _herm(n, ew, seed=3)
	v0 = jnp.asarray(rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3)))
	out = lanczos_block(lambda V: A @ V, v0, deg=n, ncv=n, orth=n)
	assert out.alphas.dtype == jnp.float64 and out.betas.dtype == jnp.float64
	for k in range(3):
		ev = np.sort(np.asarray(eigvalsh_tridiag(out.alphas[:, k], out.betas[:-1, k])))
		assert np.allclose(ev, np.sort(ew), atol=1e-10)
	# complex orthonormal basis: Q† Q = I per probe
	Q = np.asarray(out.Q)[:, :, 0]
	G = Q.conj() @ Q.T
	assert np.abs(G - np.eye(n)).max() < 1e-12


def test_matrix_function_matvec_complex():
	rng = np.random.default_rng(4)
	n = 48
	ew = rng.uniform(0.2, 1.5, n)
	A = _herm(n, ew, seed=5)
	lam, U = np.linalg.eigh(np.asarray(A))
	v = rng.normal(size=n) + 1j * rng.normal(size=n)
	for fun, f in [("exp", np.exp), ("log", np.log), (None, lambda x: x)]:
		FA = (U * f(lam)) @ U.conj().T
		M = pt.MatrixFunction(A, fun=fun, deg=n, orth=n)
		got = np.asarray(M @ jnp.asarray(v))
		assert np.abs(got - FA @ v).max() < 1e-10, fun
		# two-pass path agrees
		M2 = pt.MatrixFunction(A, fun=fun, deg=n, orth=n, two_pass=True)
		assert np.abs(np.asarray(M2 @ jnp.asarray(v)) - FA @ v).max() < 1e-10, fun


def test_quad_is_real_and_correct():
	rng = np.random.default_rng(6)
	n = 36
	ew = rng.uniform(0.3, 2.0, n)
	A = _herm(n, ew, seed=7)
	lam, U = np.linalg.eigh(np.asarray(A))
	logA = (U * np.log(lam)) @ U.conj().T
	X = rng.normal(size=(n, 5)) + 1j * rng.normal(size=(n, 5))
	M = pt.MatrixFunction(A, "log", deg=n, orth=n)
	q = np.asarray(M.quad(jnp.asarray(X)))
	assert q.dtype == np.float64  # real output for Hermitian operators
	want = np.einsum("ij,ij->j", X.conj(), logA @ X).real
	assert np.allclose(q, want, atol=1e-8)


def test_hutch_trace_complex():
	rng = np.random.default_rng(8)
	n = 96
	ew = rng.uniform(0.1, 1.0, n)
	A = _herm(n, ew, seed=9)
	est = pt.hutch(A, converge="count", count=512, seed=10)
	assert np.isrealobj(np.asarray(est)) or np.iscomplexobj(est) is False
	assert abs(float(est) - ew.sum()) <= 10 / np.sqrt(n) * np.sqrt(ew.sum())
	# logdet through MatrixFunction
	ld = pt.hutch(pt.MatrixFunction(A, "log", deg=24, orth=8), converge="count", count=1024, seed=11)
	assert abs(float(ld) - np.log(ew).sum()) / abs(np.log(ew).sum()) < 0.05


def test_diag_complex_real_output():
	rng = np.random.default_rng(12)
	n = 64
	A = _herm(n, rng.uniform(0.5, 1.5, n), seed=13)
	d = np.asarray(pt.diag(A, converge="count", count=3000, seed=14))
	assert d.dtype == np.float64
	assert np.abs(d - np.diag(np.asarray(A)).real).mean() < 0.05


def test_spectral_density_complex():
	rng = np.random.default_rng(15)
	n = 128
	ew = np.concatenate([rng.uniform(0.0, 0.5, n // 2), rng.uniform(1.5, 2.0, n // 2)])
	A = _herm(n, ew, seed=16)
	ts, phi = pt.spectral_density(A, deg=48, nv=8, seed=17)
	assert np.all(np.isfinite(phi))
	# two-lobe spectrum: density in the gap is far below the lobes
	gap = phi[(ts > 0.8) & (ts < 1.2)].mean()
	lobe = phi[(ts > 0.0) & (ts < 0.5)].mean()
	assert gap < 0.2 * lobe


def test_same_seed_real_vs_complex_independent_paths():
	"""A real matrix lifted to complex dtype gives the same hutch estimate."""
	n = 80
	ew = np.random.default_rng(18).uniform(0.2, 1.2, n)
	Ar = np.asarray(pt.symmetric(n, ew=ew, pd=True, seed=19))
	Ac = jnp.asarray(Ar.astype(np.complex128))
	er = pt.hutch(jnp.asarray(Ar), converge="count", count=256, seed=20)
	ec = pt.hutch(Ac, converge="count", count=256, seed=20)
	assert np.isclose(float(er), float(ec), rtol=1e-12)


def test_xtrace_complex_loo_parity_and_exactness():
	"""The complex leave-one-out identities match a brute-force computation
	(per-probe, to rounding) and the estimator is exact at m = n."""
	from primate_tpu.trace import _xtrace_estimates

	rng = np.random.default_rng(30)
	n, m = 24, 10
	ew = rng.uniform(0.2, 2.0, n)
	A = np.asarray(_herm(n, ew, seed=31))
	Om = rng.normal(size=(n, m))  # real probes, scale = 1 (non-sphere)
	Y = A @ Om
	Q, R = np.linalg.qr(Y)
	t_fast = np.asarray(_xtrace_estimates(
		jnp.asarray(Om.astype(np.complex128)), jnp.asarray(A @ Q), jnp.asarray(Q),
		jnp.asarray(R), jnp.asarray(np.linalg.inv(R)), jnp.asarray(False)))
	assert t_fast.dtype == np.float64
	for i in range(m):
		idx = [j for j in range(m) if j != i]
		Qi, _ = np.linalg.qr(Y[:, idx])
		r = Om[:, i] - Qi @ (Qi.conj().T @ Om[:, i])
		t_i = np.real(np.trace(Qi.conj().T @ A @ Qi) + r.conj() @ A @ r)
		assert abs(t_fast[i] - t_i) < 1e-9

	est = pt.xtrace(jnp.asarray(A), seed=32)  # default stop: m == n → exact
	assert abs(float(est) - ew.sum()) < 1e-8
	est_s = pt.xtrace(jnp.asarray(A), pdf="sphere", batch=8, seed=33)
	assert abs(float(est_s) - ew.sum()) < 1e-8


def test_hutchpp_complex():
	rng = np.random.default_rng(34)
	n = 48
	ew = rng.uniform(0.2, 2.0, n)
	A = _herm(n, ew, seed=35)
	for mode in ("reduced", "full"):
		e = pt.hutchpp(A, m=24, mode=mode, seed=36)
		assert np.isrealobj(e) and abs(e - ew.sum()) < 1.5, mode
	# adaptive mode routes through DeflatedOperator (conjugated projections)
	ea = pt.hutchpp(A, m=24, converge="count", count=256, seed=37)
	assert abs(ea - ew.sum()) < 1.5


def test_xnystrace_complex_lowrank_exact():
	rng = np.random.default_rng(38)
	n = 28
	ew = np.concatenate([rng.uniform(1.0, 2.0, 6), np.zeros(n - 6)])
	A = _herm(n, ew, seed=39)
	est = pt.xnystrace(A, m=12, seed=40)  # rank 6 < m → exact to rounding
	assert abs(est - ew.sum()) < 1e-6
	est_f = pt.xnystrace(_herm(n, rng.uniform(0.2, 2.0, n), seed=41), m=20, seed=42)
	assert np.isrealobj(est_f) and np.isfinite(est_f)


def test_diagpp_xdiag_complex():
	rng = np.random.default_rng(43)
	n = 24
	ew = rng.uniform(0.2, 2.0, n)
	A = _herm(n, ew, seed=44)
	dtrue = np.diag(np.asarray(A)).real
	xd = pt.xdiag(A, m=2 * n, seed=45)
	assert xd.dtype == np.float64 and np.abs(xd - dtrue).mean() < 0.1
	# diagpp: exact (to rounding) when rank(A) <= nb
	ew_lr = np.concatenate([rng.uniform(1.0, 2.0, 5), np.zeros(n - 5)])
	Alr = _herm(n, ew_lr, seed=46)
	dlr = pt.diagpp(Alr, m=8, seed=47)
	assert np.abs(dlr - np.diag(np.asarray(Alr)).real).max() < 1e-8


def test_sketch_estimators_real_lift_consistency():
	"""A real matrix lifted to complex dtype gives the same same-seed estimate
	through every sketch-based estimator (the conjugations are identities)."""
	n = 24
	ew = np.random.default_rng(48).uniform(0.2, 2.0, n)
	Ar = np.asarray(pt.symmetric(n, ew=ew, pd=True, seed=49))
	Ac = jnp.asarray(Ar.astype(np.complex128))
	Arj = jnp.asarray(Ar)
	assert np.isclose(pt.xtrace(Arj, seed=50), pt.xtrace(Ac, seed=50), rtol=1e-12)
	assert np.isclose(pt.hutchpp(Arj, m=12, seed=51), pt.hutchpp(Ac, m=12, seed=51), rtol=1e-12)
	assert np.isclose(pt.xnystrace(Arj, m=12, seed=52), pt.xnystrace(Ac, m=12, seed=52), rtol=1e-10)
	assert np.allclose(pt.xdiag(Arj, m=2 * n, seed=53), pt.xdiag(Ac, m=2 * n, seed=53), rtol=1e-12)
	assert np.allclose(pt.diagpp(Arj, m=8, seed=54), pt.diagpp(Ac, m=8, seed=54), rtol=1e-12)


def test_cg_complex_hermitian():
	rng = np.random.default_rng(60)
	n = 64
	A = _herm(n, rng.uniform(0.5, 2.0, n), seed=61)
	b = rng.normal(size=n) + 1j * rng.normal(size=n)
	x = pt.solve(A, jnp.asarray(b), rtol=1e-10)
	assert np.linalg.norm(np.asarray(A) @ np.asarray(x) - b) < 1e-6
	# block RHS + Nyström preconditioner
	B = rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3))
	X, nit, res = pt.cg(A, jnp.asarray(B), precond="nystrom", precond_rank=16, rtol=1e-10, full=True, precond_seed=62)
	assert np.linalg.norm(np.asarray(A) @ np.asarray(X) - B) < 1e-6 and np.all(np.isreal(res))


def test_eigsh_complex():
	rng = np.random.default_rng(63)
	n = 96
	ew = np.sort(rng.uniform(-2.0, 2.0, n))
	A = _herm(n, ew, seed=64)
	w, V = pt.eigsh(A, k=4, which="LA", seed=65)
	assert np.allclose(np.sort(w), ew[-4:], atol=1e-6)
	Vn = np.asarray(V)
	assert np.abs(np.asarray(A) @ Vn - Vn * w[None, :]).max() < 1e-4  # true eigenvectors
	w_sa = pt.eigsh(A, k=3, which="SA", seed=66, return_eigenvectors=False)
	assert np.allclose(np.sort(w_sa), ew[:3], atol=1e-5)
	w_be, _ = pt.eigsh(A, k=4, which="BE", seed=67)
	assert np.allclose(np.sort(w_be), np.concatenate([ew[:2], ew[-2:]]), atol=1e-5)


def test_svds_complex():
	rng = np.random.default_rng(68)
	X = rng.normal(size=(60, 30)) + 1j * rng.normal(size=(60, 30))
	sv = np.linalg.svd(np.asarray(X), compute_uv=False)
	U, s, Vh = pt.svds(jnp.asarray(X), k=5, seed=69)
	assert np.allclose(np.sort(s), np.sort(sv[:5]), atol=1e-8)
	# U s Vh reproduces the best rank-5 approximation (phase-free check)
	Ut, st, Vt = np.linalg.svd(np.asarray(X))
	best5 = (Ut[:, :5] * sv[:5]) @ Vt[:5]
	assert np.abs((np.asarray(U) * s) @ np.asarray(Vh) - best5).max() < 1e-8


def test_kpm_and_chebyshev_complex():
	rng = np.random.default_rng(70)
	n = 96
	ew = rng.uniform(-1.5, 1.5, n)
	A = _herm(n, ew, seed=71)
	lam, U = np.linalg.eigh(np.asarray(A))
	# undamped full-degree Chebyshev matvec is exact for analytic f
	C = pt.ChebyshevFunction(A, fun="exp", deg=64, damping="none")
	v = rng.normal(size=n) + 1j * rng.normal(size=n)
	want = (U * np.exp(lam)) @ U.conj().T @ v
	assert np.abs(np.asarray(C @ jnp.asarray(v)) - want).max() < 1e-10
	# quad is real and correct
	W = rng.normal(size=(n, 4))
	q = np.asarray(C.quad(jnp.asarray(W)))
	expM = (U * np.exp(lam)) @ U.conj().T
	assert q.dtype == np.float64
	assert np.allclose(q, np.einsum("ij,ij->j", W, (expM @ W).real), atol=1e-8)
	# kpm_trace statistical agreement
	t = pt.kpm_trace(A, fun="exp", m=64, nv=64, seed=72)
	assert abs(t - np.exp(lam).sum()) / np.exp(lam).sum() < 0.05


def test_gkl_bidiag_complex():
	from primate_tpu.bidiag import bidiag_jacobi, lanczos_bidiag
	from primate_tpu.operators.sparse import GramOperator
	from primate_tpu.tridiag import eigvalsh_tridiag

	rng = np.random.default_rng(73)
	m, n = 30, 20
	X = jnp.asarray(rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n)))
	sv = np.linalg.svd(np.asarray(X), compute_uv=False)
	out = lanczos_bidiag(X, jnp.asarray(rng.normal(size=(n, 1)), np.complex128), deg=n, orth=n)
	assert out.alphas.dtype == jnp.float64  # GKL coefficients are real norms
	d, e = bidiag_jacobi(out.alphas, out.betas)
	ev = np.sort(np.asarray(eigvalsh_tridiag(d[:, 0], e[:, 0])))
	assert np.abs(np.sqrt(np.maximum(ev, 0)) - np.sort(sv)).max() < 1e-10
	# MatrixFunction(GramOperator).quad routes through GKL and is exact at full degree
	lam, U = np.linalg.eigh(np.asarray(X).conj().T @ np.asarray(X))
	logM = (U * np.log(lam)) @ U.conj().T
	W = rng.normal(size=(n, 3))
	q = np.asarray(pt.MatrixFunction(GramOperator(X), "log", deg=n, orth=n).quad(jnp.asarray(W)))
	assert q.dtype == np.float64
	assert np.allclose(q, np.einsum("ij,ij->j", W, (logM @ W).real), atol=1e-8)


def test_recipes_complex():
	rng = np.random.default_rng(80)
	n = 48
	ew = rng.uniform(0.2, 2.0, n)
	A = _herm(n, ew, seed=81)
	ld = pt.recipes.logdet(A, deg=32, seed=82, converge="count", count=1024)
	# |log det| is near zero for this spectrum — use an absolute MC-scale bound
	assert abs(ld - np.log(ew).sum()) < 1.0
	res = pt.recipes.trace_bounds(A, fun="log", deg=24, nv=16, seed=83, full=True)
	lo, hi = res["lower"], res["upper"]
	assert np.isreal(lo) and np.isreal(hi) and lo <= hi
	# The bracket bounds QUADRATURE bias only; the MC spread remains — the true
	# trace must lie within the bracket widened by a few probe-sample stderrs.
	slack = 4 * res["mc_stderr"]
	assert lo - slack <= np.log(ew).sum() <= hi + slack
	# a real matrix lifted to complex dtype brackets identically (same seed)
	Ar = np.asarray(pt.symmetric(n, ew=ew, pd=True, seed=84))
	br = pt.recipes.trace_bounds(jnp.asarray(Ar), fun="log", deg=24, nv=16, seed=85)
	bc = pt.recipes.trace_bounds(jnp.asarray(Ar.astype(np.complex128)), fun="log", deg=24, nv=16, seed=85)
	assert np.allclose(br, bc, rtol=1e-10)


def test_phase_probes():
	"""pdf='phase' (complex unit phases): the complex-rademacher analog."""
	from primate_tpu.random import sample_isotropic

	V = np.asarray(sample_isotropic(jax.random.PRNGKey(0), (64, 400), pdf="phase", dtype=jnp.complex128))
	assert np.allclose(np.abs(V), 1.0)  # unit modulus everywhere
	C = (V @ V.conj().T) / V.shape[1]
	assert np.abs(C - np.eye(64)).max() < 0.25  # E[vv†] = I

	rng = np.random.default_rng(90)
	n = 64
	ew = rng.uniform(0.2, 2.0, n)
	A = _herm(n, ew, seed=91)
	tr = pt.hutch(A, pdf="phase", converge="count", count=512, seed=92)
	assert np.isrealobj(np.asarray(tr)) and abs(float(tr) - ew.sum()) < 1.5
	# diag: unit-modulus probes make the ratio denominators exact
	d = np.asarray(pt.diag(A, pdf="phase", converge="count", count=2000, seed=93))
	assert d.dtype == np.float64 and np.abs(d - np.diag(np.asarray(A)).real).mean() < 0.03
	# kpm moments accept phase probes
	lam = np.linalg.eigvalsh(np.asarray(A))
	t = pt.kpm_trace(A, fun="exp", m=48, nv=64, pdf="phase", seed=94)
	assert abs(t - np.exp(lam).sum()) / np.exp(lam).sum() < 0.08
	# real operators reject phase probes with a clear message
	Ar = jnp.asarray(np.asarray(pt.symmetric(32, seed=95)))
	try:
		pt.hutch(Ar, pdf="phase", converge="count", count=8, seed=96)
		raise RuntimeError("phase pdf on a real operator should be rejected")
	except AssertionError as e:
		assert "complex" in str(e)


def test_sharded_complex_operator():
	"""A complex-Hermitian operator sharded over the 8-device mesh matches the
	unsharded same-seed estimates exactly (the multi-chip path is dtype-blind)."""
	from primate_tpu.parallel import ShardedDenseOperator, make_mesh

	mesh = make_mesh((8, 1), ("op", "probe"))
	n = 128
	ew = np.random.default_rng(100).uniform(0.2, 2.0, n)
	A = _herm(n, ew, seed=101)
	op = ShardedDenseOperator(A, mesh)
	v = np.random.default_rng(102).normal(size=n) + 1j * np.random.default_rng(103).normal(size=n)
	assert np.abs(np.asarray(op.matvec(jnp.asarray(v))) - np.asarray(A) @ v).max() < 1e-12
	tr_sh = pt.hutch(op, converge="count", count=128, seed=104)
	tr_un = pt.hutch(A, converge="count", count=128, seed=104)
	assert np.isclose(float(tr_sh), float(tr_un), rtol=1e-12)
	trp = pt.hutch(op, pdf="phase", converge="count", count=128, seed=105)
	assert abs(float(trp) - ew.sum()) < 3.0


def test_diag_complex_host_path_matches_fused():
	"""Regression: the host-stepped loop (taken for callbacks / record / size-
	pdfs) must apply the same conjugated real math as the fused path — it used
	to accumulate complex v∘Av and return a complex (and wrong) diagonal."""
	n = 40
	rng = np.random.default_rng(3)
	H = pt.hermitian(n, ew=rng.uniform(0.5, 2.0, n), seed=5)
	true = np.real(np.diagonal(np.asarray(H)))

	calls = []
	est_host = pt.diag(H, pdf="phase", converge="count", count=96, seed=7, callback=lambda r: calls.append(r.nit))
	assert len(calls) == 96
	assert not np.iscomplexobj(est_host)
	assert np.max(np.abs(np.asarray(est_host) - true)) < 0.35  # phase probes: exact denominators

	# and with a numpy-style size-pdf on a complex operator (real probes)
	g = np.random.default_rng(11)
	est_size = pt.diag(H, pdf=lambda size: g.normal(size=size), converge="count", count=256, seed=13)
	assert not np.iscomplexobj(est_size)
	assert np.max(np.abs(np.asarray(est_size) - true)) < 0.6


def test_sphere_probes_complex_unit_norm():
	"""Review r3b: complex sphere probes normalize by |W| (W.W is complex and
	would rescale AND phase-rotate) — norms are exactly sqrt(n)."""
	from primate_tpu.random import sample_isotropic, as_key

	W = sample_isotropic(as_key(0), (32, 5), pdf="sphere", dtype=jnp.complex64)
	norms = np.linalg.norm(np.asarray(W), axis=0)
	assert np.allclose(norms, np.sqrt(32), atol=1e-4)


def test_sketch_estimators_phase_probes():
	"""Review r3b: hutchpp/xtrace/xnystrace accept pdf='phase' on complex
	Hermitian operators (previously crashed on a self-inflicted dtype demotion).
	xtrace at m=n stays exact — the leave-one-out identity holds for any
	isotropic complex probes with E[vv*] = I."""
	n = 40
	ew = np.linspace(0.5, 3.0, n)
	H = pt.random.hermitian(n, ew=ew, seed=1)
	tr = float(ew.sum())
	e1 = float(pt.hutchpp(H, m=36, pdf="phase", seed=2))
	assert abs(e1 - tr) / tr < 0.2
	e2 = float(pt.xtrace(H, batch=8, pdf="phase", seed=3))
	assert abs(e2 - tr) / tr < 1e-3  # m = n exactness
	e3 = float(pt.xnystrace(H, m=36, pdf="phase", seed=4))
	assert abs(e3 - tr) / tr < 0.2


def test_sparse_adjoints_are_conjugate_transpose():
	"""Review r3d: COO/CSR/DIA/BSR rmatvec must be the ADJOINT A*v (the base
	contract DenseOperator honors), not the plain transpose."""
	from primate_tpu.operators.sparse import BSROperator, COOOperator, CSROperator, DIAOperator
	import scipy.sparse as sps

	rng = np.random.default_rng(0)
	n = 24
	off = rng.normal(size=n - 1) + 1j * rng.normal(size=n - 1)
	H = sps.diags([np.conj(off) * 0 + (rng.normal(size=n - 1) + 1j * rng.normal(size=n - 1)), rng.normal(size=n).astype(complex), off], [-1, 0, 1]).tocsr()
	Hd = H.toarray()
	v = rng.normal(size=n) + 1j * rng.normal(size=n)
	for op in (
		CSROperator.from_scipy(H),
		COOOperator.from_scipy(H.tocoo()),
		DIAOperator.from_scipy(H.todia()),
		BSROperator.from_scipy(H, blocksize=(2, 2)),
	):
		got = np.asarray(op.rmatvec(jnp.asarray(v)))
		want = Hd.conj().T @ v
		assert np.allclose(got, want, atol=1e-6), type(op).__name__
		# .H operator agrees with the dense adjoint
		got_H = np.asarray((op.H) @ jnp.asarray(v))
		assert np.allclose(got_H, want, atol=1e-6), type(op).__name__


def test_gram_operator_complex_is_hermitian_psd():
	"""GramOperator over a complex CSR data matrix applies A^H A (PSD), not A^T A."""
	from primate_tpu.operators.sparse import CSROperator, GramOperator
	import scipy.sparse as sps

	rng = np.random.default_rng(3)
	X = sps.random(20, 14, density=0.3, random_state=5).toarray()
	Xc = X + 1j * (X != 0) * rng.normal(size=X.shape)
	op = GramOperator(CSROperator.from_scipy(sps.csr_matrix(Xc)))
	V = rng.normal(size=(14, 3)) + 1j * rng.normal(size=(14, 3))
	got = np.asarray(op.matmat(jnp.asarray(V)))
	want = Xc.conj().T @ (Xc @ V)
	assert np.allclose(got, want, atol=1e-6)


def test_lanczos_complex_alpha_beta_real_dtype():
	"""Review r3d: alpha/beta come back REAL for complex Hermitian operators
	(the documented contract; tqli's hypot requires it)."""
	n = 32
	H = pt.random.hermitian(n, ew=np.linspace(0.5, 2.0, n), seed=1)
	a, b = pt.lanczos(H, deg=10, orth=-1, seed=2)
	assert np.asarray(a).dtype.kind == "f" and np.asarray(b).dtype.kind == "f"
	rw = pt.rayleigh_ritz(H, deg=n, orth=-1, seed=3, method="tqli")
	assert np.allclose(np.sort(np.asarray(rw)), np.linspace(0.5, 2.0, n), atol=1e-4)


def test_dia_complex_probe_major_matches_dense():
	"""matmat_t on a complex Hermitian DIA operator matches the dense product."""
	from primate_tpu.operators.sparse import DIAOperator
	import scipy.sparse as sps

	n = 64
	off = (0.2 + 0.3j) * np.ones(n - 1)
	H = sps.diags([np.conj(off), 2.0 * np.ones(n).astype(complex), off], [-1, 0, 1]).todia()
	op = DIAOperator.from_scipy(H)
	Vt = jnp.asarray(np.random.default_rng(0).normal(size=(4, n)) + 0j, jnp.complex64)
	got = np.asarray(op.matmat_t(Vt))
	want = (H.toarray() @ np.asarray(Vt).T).T
	assert np.allclose(got, want, atol=1e-5)
