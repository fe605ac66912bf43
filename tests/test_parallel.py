"""Sharded-operator tests on the virtual 8-device CPU mesh.

Mirrors SURVEY §4's plan: 1-chip vs N-chip sharded-SpMV tolerance equivalence
and determinism across shardings (same seed → same estimate), the JAX way of
testing "multi-node without a real cluster".
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.sparse as sps

import primate_tpu as pt
from primate_tpu.operators.sparse import BSROperator
from primate_tpu.parallel import make_mesh, shard_operator, ShardedBSROperator, ShardedDenseOperator


def _laplacian(n: int) -> sps.csr_matrix:
	"""1-D path-graph Laplacian + I: banded, SPD, the halo-friendly fixture."""
	main = 2.0 * np.ones(n) + 1.0
	off = -1.0 * np.ones(n - 1)
	return sps.diags([off, main, off], [-1, 0, 1]).tocsr()


def _random_sym_sparse(n: int, seed: int) -> sps.csr_matrix:
	rng = np.random.default_rng(seed)
	A = sps.random(n, n, density=0.06, random_state=rng, format="csr")
	return (A + A.T).tocsr()


@pytest.fixture(scope="module")
def mesh8():
	assert jax.device_count() >= 8, "conftest must force 8 virtual CPU devices"
	return make_mesh((8, 1), ("op", "probe"))


def test_mesh_shapes(mesh8):
	assert mesh8.shape["op"] == 8 and mesh8.shape["probe"] == 1


def test_sharded_dense_matmat(mesh8):
	A = np.asarray(pt.symmetric(96, seed=0))
	op = shard_operator(jnp.asarray(A), mesh8)
	assert isinstance(op, ShardedDenseOperator)
	V = np.random.default_rng(1).normal(size=(96, 5))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V)


@pytest.mark.parametrize("comm", ["allgather", "halo"])
def test_sharded_bsr_banded(mesh8, comm):
	n = 128
	A = _laplacian(n)
	op = shard_operator(A, mesh8, comm=comm, blocksize=(8, 8))
	assert isinstance(op, ShardedBSROperator)
	assert op.comm == comm
	V = np.random.default_rng(2).normal(size=(n, 7))
	got = np.asarray(op.matmat(jnp.asarray(V)))
	assert np.allclose(got, A @ V, atol=1e-10)
	assert np.allclose(op.todense(), A.toarray())


def test_sharded_bsr_general_pattern_falls_back(mesh8):
	# Random pattern is wider than ±1 neighbors → auto picks allgather.
	A = _random_sym_sparse(128, seed=3)
	op = shard_operator(A, mesh8, comm="auto", blocksize=(8, 8))
	assert op.comm == "allgather"
	V = np.random.default_rng(4).normal(size=(128, 4))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)


def test_halo_requested_but_invalid_raises(mesh8):
	A = _random_sym_sparse(128, seed=5)
	with pytest.raises(ValueError, match="halo"):
		shard_operator(A, mesh8, comm="halo", blocksize=(8, 8))


def test_uneven_rows_padding(mesh8):
	# 9 block-rows over 8 devices: padding rows must contribute nothing.
	n = 72  # 9 blocks of 8
	A = _laplacian(n)
	op = shard_operator(A, mesh8, comm="halo", blocksize=(8, 8))
	V = np.random.default_rng(6).normal(size=(n, 3))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)


def test_hutch_on_sharded_matches_unsharded(mesh8):
	"""Same seed ⇒ identical estimate whether the operator is sharded or not."""
	n = 96
	A = _laplacian(n)
	dense = jnp.asarray(A.toarray())
	sharded = shard_operator(A, mesh8, comm="halo", blocksize=(8, 8))
	est_ref = pt.hutch(dense, seed=11, converge="count", count=256)
	est_shd = pt.hutch(sharded, seed=11, converge="count", count=256)
	assert np.isclose(est_ref, est_shd, rtol=1e-8)
	assert abs(est_shd - A.diagonal().sum()) < 10 / np.sqrt(n) * 3


def test_lanczos_on_sharded(mesh8):
	n = 96
	A = _laplacian(n)
	sharded = shard_operator(A, mesh8, comm="halo", blocksize=(8, 8))
	ew_true = np.linalg.eigvalsh(A.toarray())
	rw = pt.rayleigh_ritz(sharded, deg=n, orth=n, seed=7)
	assert np.allclose(np.sort(np.asarray(rw)), ew_true, atol=1e-8)


def test_probe_axis_sharding():
	mesh = make_mesh((4, 2), ("op", "probe"))
	n = 64
	A = _laplacian(n)
	op = shard_operator(A, mesh, probe_axis="probe", comm="halo", blocksize=(8, 8))
	V = np.random.default_rng(8).normal(size=(n, 6))  # 6 probes over 2-way axis
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)


def test_sharded_dia_matmat(mesh8):
	from primate_tpu.operators.sparse import DIAOperator
	from primate_tpu.parallel import ShardedDIAOperator

	for n in (128, 121):  # divisible and padded row counts
		A = _laplacian(n)
		op = shard_operator(DIAOperator.from_scipy(A), mesh8)
		assert isinstance(op, ShardedDIAOperator)
		V = np.random.default_rng(3).normal(size=(n, 5))
		assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)
		# probe-major sharded stencil (the layout the Lanczos sweep uses)
		assert np.allclose(np.asarray(op.matmat_t(jnp.asarray(V.T))), (A @ V).T, atol=1e-10)
		assert np.allclose(op.todense(), A.toarray())


def test_sharded_dia_wide_band_and_probe_axis():
	import scipy.sparse as sps
	from primate_tpu.parallel import ShardedDIAOperator

	mesh = make_mesh((4, 2), ("op", "probe"))
	n = 96
	rng = np.random.default_rng(9)
	A = sps.diags(
		[rng.normal(size=n - 7), rng.normal(size=n - 2), rng.normal(size=n), rng.normal(size=n - 2), rng.normal(size=n - 7)],
		[-7, -2, 0, 2, 7],
	)
	op = ShardedDIAOperator.from_dia(A.todia(), mesh, probe_axis="probe")
	V = rng.normal(size=(n, 6))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)


def test_sharded_dia_halo_too_wide_raises(mesh8):
	import scipy.sparse as sps
	from primate_tpu.parallel import ShardedDIAOperator

	n = 64  # 8 rows/chip but offset 20 needs a 20-row halo
	A = sps.diags([np.ones(n - 20), np.ones(n)], [-20, 0])
	with pytest.raises(ValueError, match="halo"):
		ShardedDIAOperator.from_dia(A.todia(), mesh8)


def test_hutch_on_sharded_dia_matches_unsharded(mesh8):
	from primate_tpu.operators.sparse import DIAOperator

	n = 96
	A = _laplacian(n)
	sharded = shard_operator(DIAOperator.from_scipy(A), mesh8)
	est_ref = pt.hutch(jnp.asarray(A.toarray()), seed=11, converge="count", count=256)
	est_shd = pt.hutch(sharded, seed=11, converge="count", count=256)
	assert np.isclose(est_ref, est_shd, rtol=1e-8)


def test_matrix_function_on_sharded(mesh8):
	"""SLQ logdet on a sharded Laplacian — config-2 shape end to end."""
	n = 96
	A = _laplacian(n)
	sharded = shard_operator(A, mesh8, comm="halo", blocksize=(8, 8))
	M = pt.MatrixFunction(sharded, fun="log", deg=40, orth=40)
	est = pt.hutch(M, seed=13, converge="count", count=312, batch=8)
	true_logdet = np.linalg.slogdet(A.toarray())[1]
	assert abs(est - true_logdet) / abs(true_logdet) < 0.05


@pytest.mark.slow
def test_all_estimators_on_sharded(mesh8):
	"""hutchpp / xtrace / diag / xdiag / cg all run on a sharded operator."""
	from primate_tpu.operators.sparse import DIAOperator
	from primate_tpu.solvers import solve

	n = 96
	A = _laplacian(n)
	op = shard_operator(DIAOperator.from_scipy(A), mesh8)
	tr_true = float(A.diagonal().sum())

	est = pt.hutchpp(op, m=24, seed=1)
	assert abs(est - tr_true) / tr_true < 0.1
	est = pt.xtrace(op, batch=24, seed=2)
	assert abs(est - tr_true) / tr_true < 0.02
	d = np.asarray(pt.diag(op, seed=3, converge="count", count=512))
	assert np.abs(d - A.diagonal()).mean() < 0.6
	xd = np.asarray(pt.xdiag(op, m=64, seed=4))
	assert abs(xd.sum() - tr_true) / tr_true < 0.15
	b = np.random.default_rng(5).normal(size=n)
	x = np.asarray(solve(op, b, rtol=1e-10))
	assert np.allclose(A @ x, b, atol=1e-6)


def test_kpm_on_sharded_dia_matches_unsharded(mesh8):
	"""ChebyshevFunction over a sharded operator: the Clenshaw/moment scans run
	probe-major through the sharded matmat_t (ring-halo shard_map stencil)."""
	import primate_tpu as pt
	from primate_tpu.operators.sparse import DIAOperator

	n = 256
	A = _laplacian(n)
	op_local = DIAOperator.from_scipy(A)
	op_shard = shard_operator(op_local, mesh8)
	interval = (0.0, 6.5)
	M_l = pt.ChebyshevFunction(op_local, fun="exp", deg=48, interval=interval)
	M_s = pt.ChebyshevFunction(op_shard, fun="exp", deg=48, interval=interval)
	V = np.random.default_rng(9).normal(size=(n, 4))
	assert np.allclose(np.asarray(M_s.matmat(jnp.asarray(V))), np.asarray(M_l.matmat(jnp.asarray(V))), atol=1e-8)
	est_l = pt.hutch(M_l, batch=32, converge="count", count=64, seed=3)
	est_s = pt.hutch(M_s, batch=32, converge="count", count=64, seed=3)
	assert np.allclose(est_l, est_s, rtol=1e-6)


def test_eigsh_on_sharded_operator(mesh8):
	"""eigsh (blocked LOBPCG) drives a sharded operator matrix-free."""
	n = 256
	L = _laplacian(n)
	op = shard_operator(L.todia(), mesh8, probe_axis=None)
	kk = np.arange(1, n + 1)
	ew = np.sort(3.0 - 2.0 * np.cos(kk * np.pi / (n + 1)))
	w = pt.eigsh(op, k=3, which="LA", seed=0, return_eigenvectors=False)
	assert np.allclose(w, ew[-3:], atol=1e-5)


def test_xnystrace_on_sharded_operator(mesh8):
	"""xnystrace's fused program runs over a sharded operator unchanged."""
	n = 256
	L = _laplacian(n)
	op = shard_operator(L.todia(), mesh8, probe_axis=None)
	est = pt.xnystrace(op, m=128, seed=1)
	assert abs(est - 3.0 * n) < 0.02 * 3.0 * n


def test_deflated_trace_on_sharded_operator(mesh8):
	"""deflated_trace composes eigsh + DeflatedOperator + hutch over a mesh."""
	from primate_tpu.recipes import deflated_trace

	n = 256
	L = _laplacian(n)
	op = shard_operator(L.todia(), mesh8, probe_axis=None)
	est = deflated_trace(op, k=4, seed=2, converge="count", count=256)
	assert abs(est - 3.0 * n) < 10 / np.sqrt(n) * 3.0


def test_stacked_family_on_sharded(mesh8):
	"""A stacked heat-trace curve over a sharded operator: the fused multi-f
	program composes with distributed SpMM Lanczos unchanged."""
	from primate_tpu.operators.sparse import DIAOperator

	n = 96
	A = _laplacian(n)
	w = np.linalg.eigvalsh(A.toarray())
	ts = np.array([0.25, 1.0])
	sharded = shard_operator(DIAOperator.from_scipy(A), mesh8)
	M = pt.MatrixFunction(sharded, fun=pt.stacked("exp", -ts), deg=40, orth=40)
	est = pt.hutch(M, seed=17, converge="count", count=512, batch=16)
	gt = np.array([np.sum(np.exp(-t * w)) for t in ts])
	assert est.shape == (2,) and np.allclose(est, gt, rtol=0.1)
	# determinism across shardings: unsharded same-seed run agrees exactly
	M0 = pt.MatrixFunction(DIAOperator.from_scipy(A), fun=pt.stacked("exp", -ts), deg=40, orth=40)
	est0 = pt.hutch(M0, seed=17, converge="count", count=512, batch=16)
	assert np.allclose(est, est0, rtol=1e-6)


def test_auto_shard_shuffled_band_becomes_dia(mesh8):
	"""A shuffled banded matrix — unpartitionable with halo comm as-is — is
	RCM-reordered into a minimal-halo sharded DIA stencil."""
	from primate_tpu.parallel import auto_shard_operator
	from primate_tpu.parallel.sharded import ShardedDIAOperator

	n = 256
	A = _laplacian(n)
	p = np.random.default_rng(3).permutation(n)
	Ash = A[p][:, p].tocsr()
	op, info = auto_shard_operator(Ash, mesh8, probe_axis="probe", dense_n=64)
	assert info.format == "dia" and info.perm is not None
	assert isinstance(op, ShardedDIAOperator)
	V = np.random.default_rng(4).normal(size=(n, 6))
	got = info.unpermute(np.asarray(op.matmat(jnp.asarray(info.permute(V)))))
	assert np.allclose(got, Ash @ V, atol=1e-10)


def test_auto_shard_trace_matches_unsharded(mesh8):
	from primate_tpu.parallel import auto_shard_operator

	n = 512
	A = _laplacian(n)
	p = np.random.default_rng(5).permutation(n)
	Ash = A[p][:, p].tocsr()
	op, info = auto_shard_operator(Ash, mesh8, probe_axis="probe", dense_n=64)
	est = pt.hutch(op, converge="count", count=64, seed=7)
	ref = pt.hutch(pt.operators.auto_operator(Ash, dense_n=64)[0], converge="count", count=64, seed=7)
	# same probes, similarity-invariant target: estimates agree to fp tolerance
	assert np.isclose(est, ref, rtol=1e-10)


def test_auto_shard_scattered_keeps_general_sparsity(mesh8):
	"""Scattered patterns shard as CSR (nnz-proportional storage) — no silent
	dense-tile re-block (round-2 verdict weak-point 4)."""
	from primate_tpu.parallel import ShardedCSROperator, auto_shard_operator

	A = _random_sym_sparse(256, seed=9)
	op, info = auto_shard_operator(A, mesh8, dense_density=0.5, dense_n=64)
	assert info.format in ("csr", "bsr") and info.perm is None
	if info.format == "csr":
		assert isinstance(op, ShardedCSROperator)
	V = np.random.default_rng(10).normal(size=(256, 4))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-9)


def test_sharded_csr_scattered_allgather(mesh8):
	"""ShardedCSROperator on a scattered pattern: exact matmat, ELL local
	layout, storage within ~2x of the single-chip CSR nnz."""
	from primate_tpu.parallel import ShardedCSROperator

	A = _random_sym_sparse(300, seed=11)
	op = ShardedCSROperator.from_csr(A, mesh8, comm="auto")
	assert op.comm == "allgather"  # scattered: halo condition fails
	V = np.random.default_rng(12).normal(size=(300, 5))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-9)
	assert np.allclose(op.todense(), A.toarray(), atol=0)
	# storage: stored value slots (ELL planes or padded nnz) ≤ ~2x logical nnz
	stored = op.ell_data.size if op.ell_data is not None else op.data.size
	assert stored <= 4.0 * A.nnz + 8 * 8  # the single-chip ELL_MAX_FILL budget + row padding


def test_sharded_csr_banded_halo(mesh8):
	"""Banded CSR under comm='auto' takes the halo ppermute route and matches."""
	from primate_tpu.parallel import ShardedCSROperator

	n = 277  # uneven rows-per-device on purpose
	A = _laplacian(n)
	op = ShardedCSROperator.from_csr(A, mesh8, comm="auto")
	assert op.comm == "halo"
	V = np.random.default_rng(13).normal(size=(n, 6))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-9)
	assert np.allclose(np.asarray(op.matmat_t(jnp.asarray(V.T))), (A @ V).T, atol=1e-9)
	# requesting halo on a scattered pattern raises with guidance
	S = _random_sym_sparse(300, seed=14)
	with pytest.raises(ValueError):
		ShardedCSROperator.from_csr(S, mesh8, comm="halo")


def test_sharded_csr_skewed_rows_segment_path(mesh8):
	"""A power-law row distribution disables ELL; the sorted segment_sum path
	stays exact."""
	from primate_tpu.parallel import ShardedCSROperator

	n = 320
	S = sps.random(n, n, density=0.004, random_state=15).tolil()
	S[0, :250] = 1.0
	S = (S + S.T).tocsr()
	op = ShardedCSROperator.from_csr(S, mesh8, comm="allgather")
	assert op.ell_data is None
	V = np.random.default_rng(16).normal(size=(n, 3))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), S @ V, atol=1e-9)


def test_sharded_csr_estimators_match_unsharded(mesh8):
	"""hutch / SLQ logdet on a sharded CSR operator ≡ the single-chip operator
	(same seed, same fused program)."""
	from primate_tpu.operators.sparse import CSROperator
	from primate_tpu.parallel import ShardedCSROperator

	A = _random_sym_sparse(256, seed=17)
	A.setdiag(np.abs(A).sum(axis=1).A1 + 1.0)  # diagonally dominant => SPD
	single = CSROperator.from_scipy(A)
	sharded = ShardedCSROperator.from_csr(A, mesh8)
	e1 = pt.hutch(single, converge="count", count=128, seed=19)
	e2 = pt.hutch(sharded, converge="count", count=128, seed=19)
	assert np.allclose(float(e1), float(e2), rtol=1e-5)
	M = pt.MatrixFunction(sharded, fun="log", deg=16, orth=4)
	ld = pt.hutch(M, converge="count", count=64, seed=21)
	w = np.linalg.eigvalsh(A.toarray())
	assert abs(float(ld) - np.log(w).sum()) < 0.1 * abs(np.log(w).sum())


def test_shard_operator_blocksize_optin_warns(mesh8):
	"""Explicit blocksize= still re-blocks to BSR — with the fill-in warning."""
	from primate_tpu.operators.sparse import CSROperator
	from primate_tpu.parallel import ShardedBSROperator

	A = _random_sym_sparse(256, seed=23)
	op = CSROperator.from_scipy(A)
	with pytest.warns(UserWarning, match="not block-structured"):
		sharded = shard_operator(op, mesh8, blocksize=(8, 8))
	assert isinstance(sharded, ShardedBSROperator)


def test_eigensolvers_on_sharded_operator(mesh8):
	"""trlan eigsh and filtered_eigsh drive sharded matmats transparently."""
	from primate_tpu.parallel import auto_shard_operator

	n = 512
	A = _laplacian(n)
	op, _ = auto_shard_operator(A, mesh8)
	kk = np.arange(1, n + 1)
	lam = np.sort(3.0 - 2.0 * np.cos(kk * np.pi / (n + 1)))
	w = pt.eigsh(op, k=3, which="SA", seed=1, method="trlan", return_eigenvectors=False)
	assert np.abs(np.sort(w) - lam[:3]).max() < 1e-5
	sl = (lam >= 2.5) & (lam <= 2.7)
	wf, Vf = pt.filtered_eigsh(op, (2.5, 2.7), seed=2)
	assert len(wf) == int(np.count_nonzero(sl))
	assert np.abs(np.sort(wf) - lam[sl]).max() < 1e-8


@pytest.mark.slow
def test_scaling_harness_smoke():
	"""benchmarks/scaling.py's child program runs at a tiny shape (2 devices)
	and reports a sane wall + estimate — keeps the harness from rotting."""
	import json
	import subprocess
	import sys
	from pathlib import Path

	from benchmarks.scaling import _CHILD

	repo = str(Path(__file__).resolve().parent.parent)
	r = subprocess.run(
		[sys.executable, "-c", _CHILD, "2", "4096", "3"],
		capture_output=True,
		text=True,
		timeout=300,
		cwd=repo,
	)
	assert r.returncode == 0, r.stderr[-1500:]
	rec = json.loads(r.stdout.strip().splitlines()[-1])
	assert rec["ndev"] == 2 and rec["rows"] == 4096 and rec["reps"] == 3
	assert rec["wall_s"] > 0 and rec["rel_err"] < 1e-2
	# Paired-rep overhead efficiency (round-4 rework) reported per cell.
	assert 0 < rec["overhead_efficiency"] < 2 and len(rec["eff_iqr"]) == 2


def test_sharded_csr_kwarg_compat_and_rect_halo(mesh8):
	"""shard_operator(CSR) routes to the CSR partition, rejects a kernel
	option it does not have, and an explicit halo request on a rectangular
	matrix raises instead of silently downgrading."""
	from primate_tpu.operators.sparse import CSROperator
	from primate_tpu.parallel import ShardedCSROperator

	A = _random_sym_sparse(128, seed=31)
	with pytest.raises(TypeError):
		shard_operator(CSROperator.from_scipy(A), mesh8, use_pallas=True)
	op = shard_operator(CSROperator.from_scipy(A), mesh8)
	assert isinstance(op, ShardedCSROperator)
	V = np.random.default_rng(32).normal(size=(128, 3))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-9)
	rect = sps.random(64, 48, density=0.05, random_state=33, format="csr")
	with pytest.raises(ValueError, match="square"):
		ShardedCSROperator.from_csr(rect, mesh8, comm="halo")


def test_sharded_dense_uneven_rows_and_dtype(mesh8):
	"""Review r3f: ShardedDenseOperator pads row counts not divisible by the
	mesh (37 rows / 8 devices used to raise) and shard_operator forwards
	dtype= for dense inputs like the sparse branches."""
	rng = np.random.default_rng(41)
	A = rng.normal(size=(37, 37))
	A = (A + A.T) / 2
	op = shard_operator(jnp.asarray(A), mesh8, dtype=jnp.float32)
	assert op.dtype == jnp.float32 and op.shape == (37, 37)
	V = rng.normal(size=(37, 3))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-4)
	assert np.allclose(np.asarray(op.matmat_t(jnp.asarray(V.T))), (A @ V).T, atol=1e-4)
	assert np.allclose(np.asarray(op.rmatvec(jnp.asarray(V[:, 0]))), A.T @ V[:, 0], atol=1e-4)


def test_sharded_bsr_halo_survives_empty_block_rows(mesh8):
	"""Review r3f: BSR conversions insert explicit zero blocks for empty
	block-rows; those must not disqualify a banded matrix from comm='halo'."""
	n = 128
	L = _laplacian(n).tolil()
	L[40:48, :] = 0.0  # one empty 8-row block-row
	L[:, 40:48] = 0.0
	L = L.tocsr()
	op = shard_operator(L, mesh8, comm="auto", blocksize=(8, 8))
	assert op.comm == "halo", op.comm
	V = np.random.default_rng(43).normal(size=(n, 3))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), L @ V, atol=1e-9)


def test_sharded_csr_minimal_halo_width(mesh8):
	"""The halo scheme ships only bandwidth-many boundary rows per neighbor:
	a tridiagonal 1000-row partition exchanges 1 row, not the 125-row segment."""
	from primate_tpu.parallel import ShardedCSROperator

	n = 1000
	A = _laplacian(n)
	op = ShardedCSROperator.from_csr(A, mesh8, comm="auto")
	assert op.comm == "halo" and op.halo == 1, (op.comm, op.halo)
	V = np.random.default_rng(51).normal(size=(n, 4))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-9)
	# wider band -> wider (but still minimal) halo
	import scipy.sparse as _sps

	B = _sps.diags([np.ones(n - 7), 3.0 * np.ones(n), np.ones(n - 7)], [-7, 0, 7]).tocsr()
	opb = ShardedCSROperator.from_csr(B, mesh8, comm="auto")
	assert opb.comm == "halo" and opb.halo == 7
	assert np.allclose(np.asarray(opb.matmat(jnp.asarray(V))), B @ V, atol=1e-9)
	assert np.allclose(opb.todense(), B.toarray(), atol=0)


def test_sharded_bsr_minimal_halo_width(mesh8):
	"""BSR halo ships only block-bandwidth-many boundary block-rows: a
	block-tridiagonal partition exchanges 1 block-row per neighbor."""
	n = 512
	A = _laplacian(n)
	op = shard_operator(A, mesh8, comm="auto", blocksize=(8, 8))
	assert isinstance(op, ShardedBSROperator) and op.comm == "halo"
	assert op.halo == 1, op.halo
	V = np.random.default_rng(61).normal(size=(n, 4))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-9)
	assert np.allclose(op.todense(), A.toarray(), atol=0)


def test_sharded_probe_major_matmat_t(mesh8):
	"""Native probe-major matmat_t on sharded CSR and BSR (halo + allgather):
	no per-step transpose in Lanczos carries, values exact."""
	from primate_tpu.parallel import ShardedCSROperator

	rng = np.random.default_rng(71)
	n = 256
	Vt = rng.normal(size=(5, n))
	# banded (halo) + scattered (allgather) CSR
	for A, comm in ((_laplacian(n), "halo"), (_random_sym_sparse(n, seed=73), "allgather")):
		op = ShardedCSROperator.from_csr(A, mesh8, comm="auto")
		assert op.comm == comm
		got = np.asarray(op.matmat_t(jnp.asarray(Vt)))
		assert np.allclose(got, (A @ Vt.T).T, atol=1e-9), comm
	# BSR halo + allgather
	for A, comm, bs in ((_laplacian(n), "halo", (8, 8)), (_random_sym_sparse(n, seed=79), "allgather", (8, 8))):
		op = shard_operator(A, mesh8, comm="auto", blocksize=bs)
		assert isinstance(op, ShardedBSROperator) and op.comm == comm
		got = np.asarray(op.matmat_t(jnp.asarray(Vt)))
		assert np.allclose(got, (A @ Vt.T).T, atol=1e-9), comm
	# end-to-end: SLQ logdet through the probe-major sweep on sharded CSR
	L = _laplacian(n)
	opc = ShardedCSROperator.from_csr(L, mesh8)
	M = pt.MatrixFunction(opc, fun="log", deg=16, orth=4)
	est = pt.hutch(M, converge="count", count=64, seed=81)
	true = np.linalg.slogdet(L.toarray())[1]
	assert abs(float(est) - true) / abs(true) < 0.05


def test_halo_explicit_zero_block_out_of_band(mesh8):
	"""Explicit-zero stored blocks with out-of-band colids must be remapped into
	the halo gather window at partition time."""
	n = 512
	A = _laplacian(n).tocsr()
	# Store an explicit ZERO at (0, 480) — block (0, 60) of the (8,8) grid:
	# structurally present in CSR/BSR, numerically zero, far outside the band.
	Z = sps.csr_matrix((np.array([1.0]), (np.array([0]), np.array([480]))), shape=A.shape)
	A = (A + Z).tocsr()
	A.data[np.flatnonzero(A.indices[: A.indptr[1]] == 480)] = 0.0
	assert A.nnz == _laplacian(n).nnz + 1  # the zero is stored

	op = shard_operator(A, mesh8, comm="halo", blocksize=(8, 8))
	assert op.comm == "halo"
	colids = np.asarray(op.colids)
	window = op.bpd + 2 * op.halo
	assert colids.min() >= 0 and colids.max() < window, (colids.min(), colids.max(), window)
	V = np.random.default_rng(7).normal(size=(n, 3))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)
	assert np.allclose(np.asarray(op.matmat_t(jnp.asarray(V.T))), (A @ V).T, atol=1e-10)
