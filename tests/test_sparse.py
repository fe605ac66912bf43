"""Sparse operator tests: CSR/COO/BSR vs dense, estimator integration."""

import numpy as np
import scipy.sparse as sps
import jax.numpy as jnp
import pytest
import primate_tpu as pt
from primate_tpu.operators import BSROperator, COOOperator, CSROperator


def _random_sym_sparse(n=48, density=0.15, seed=0):
	rng = np.random.default_rng(seed)
	M = sps.random(n, n, density=density, random_state=rng)
	A = (M + M.T).tocsr()
	A.setdiag(np.abs(A).sum(axis=1).A1 + 1.0)  # diagonally dominant → SPD
	return A


@pytest.mark.parametrize("cls", [COOOperator, CSROperator])
def test_sparse_matvec_matches_dense(cls):
	A = _random_sym_sparse()
	op = cls.from_scipy(A)
	rng = np.random.default_rng(1)
	V = rng.normal(size=(A.shape[0], 5))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)
	v = rng.normal(size=A.shape[0])
	assert np.allclose(np.asarray(op.matvec(jnp.asarray(v))), A @ v, atol=1e-10)
	assert np.allclose(np.asarray(op.todense()), A.toarray(), atol=1e-12)


def test_bsr_matmat_matches_dense():
	A = _random_sym_sparse(n=64)
	op = BSROperator.from_scipy(A.tobsr(blocksize=(8, 8)), dtype=None)
	rng = np.random.default_rng(2)
	V = rng.normal(size=(64, 4))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-8)
	assert np.allclose(np.asarray(op.todense()), A.toarray(), atol=1e-12)


def test_csr_to_bsr_roundtrip():
	A = _random_sym_sparse(n=32)
	csr = CSROperator.from_scipy(A)
	bsr = csr.tobsr(blocksize=(4, 4))
	assert np.allclose(np.asarray(bsr.todense()), A.toarray(), atol=1e-12)


def test_sparse_in_lanczos_and_hutch():
	A = _random_sym_sparse(n=40)
	op = CSROperator.from_scipy(A)
	tr = A.diagonal().sum()
	est = pt.hutch(op, seed=3, converge="count", count=512, batch=64)
	assert abs(est - tr) / tr < 0.05
	# Lanczos on the sparse operator recovers extremal eigenvalues
	rw = np.asarray(pt.rayleigh_ritz(op, deg=40, orth=-1, seed=4))
	true = np.linalg.eigvalsh(A.toarray())
	assert np.isclose(rw.max(), true.max(), rtol=1e-6)


def test_sparse_logdet_slq():
	"""Config-2 analog: logdet of a sparse SPD matrix via Lanczos quadrature."""
	A = _random_sym_sparse(n=64, density=0.1, seed=7)
	op = CSROperator.from_scipy(A)
	true_logdet = float(np.sum(np.log(np.linalg.eigvalsh(A.toarray()))))
	M = pt.MatrixFunction(op, fun="log", deg=20, orth=-1)
	est = pt.hutch(M, seed=9, converge="count", count=512, batch=64)
	assert abs(est - true_logdet) / abs(true_logdet) < 0.05


def test_sparse_pytree_jit_caching():
	"""Operators pass through jit as pytrees: two different matrices with the
	same sparsity structure reuse the compiled program."""
	import jax

	A = _random_sym_sparse(n=16, seed=1)
	B = A.copy()
	B.data = B.data * 2.0
	opA, opB = CSROperator.from_scipy(A), CSROperator.from_scipy(B)

	calls = []

	@jax.jit
	def apply(op, v):
		calls.append(1)  # traced once per structure
		return op.matvec(v)

	v = jnp.ones(16)
	ya = apply(opA, v)
	yb = apply(opB, v)
	assert len(calls) == 1  # second call hit the jit cache
	assert np.allclose(np.asarray(yb), 2 * np.asarray(ya), atol=1e-12)


def test_csr_ell_fast_path_and_fallback():
	"""CSR lays out an ELL (n, L) plane when row lengths are tight (SpMM becomes
	gather + dense slot-sum — no scatter) and
	falls back to sorted segment_sum when padding would exceed ELL_MAX_FILL."""
	import scipy.sparse as sps

	rng = np.random.default_rng(3)
	# banded: tight row lengths -> ELL built
	n = 300
	A = sps.diags(
		[rng.normal(size=n - 1), rng.normal(size=n), rng.normal(size=n - 1)], [-1, 0, 1]
	).tocsr().astype(np.float64)
	op = CSROperator.from_scipy(A)
	assert op.ell_data is not None and op.ell_data.shape == (n, 3)
	V = rng.normal(size=(n, 5))
	assert np.allclose(np.asarray(op.matmat(V)), A @ V, atol=1e-12)
	assert np.allclose(np.asarray(op.matvec(V[:, 0])), A @ V[:, 0], atol=1e-12)
	# ELL survives a jit round-trip through the pytree
	import jax

	y = jax.jit(lambda o, V: o.matmat(V))(op, jnp.asarray(V))
	assert np.allclose(np.asarray(y), A @ V, atol=1e-12)
	# one dense hub row -> full-ELL padding would cost ~n/2x, so the sliced-ELL
	# layout engages: degree-sorted prefix slots + the hub overflow in a tiny
	# segment-sum tail (num_segments = #hub rows)
	B = sps.lil_matrix((n, n))
	B[0, :] = 1.0
	B.setdiag(2.0)
	B = B.tocsr()
	opB = CSROperator.from_scipy(B)
	assert opB.ell_data is None and opB.sell is not None
	rank, s_data, s_idx, s_tail, n_hub = opB.sell
	assert n_hub == 1 and s_tail is not None  # the single hub row overflows
	assert s_data[0].shape[0] == n  # slot 0 covers every nonempty row
	assert np.allclose(np.asarray(opB.matmat(V)), B @ V, atol=1e-12)
	assert np.allclose(np.asarray(opB.matvec(V[:, 0])), B @ V[:, 0], atol=1e-12)
	assert np.allclose(np.asarray(opB.rmatvec(V[:, 0])), B.T @ V[:, 0], atol=1e-12)
	# sliced-ELL survives a jit round-trip through the pytree
	yb = jax.jit(lambda o, V: o.matmat(V))(opB, jnp.asarray(V))
	assert np.allclose(np.asarray(yb), B @ V, atol=1e-12)
	# hub rows owning most of the nnz: sliced-ELL still applies scatter-free up
	# to the slot cap, with only the beyond-cap overflow in the tail
	C = sps.lil_matrix((n, n))
	for r in range(0, n, 10):
		C[r, :] = 1.0
	C.setdiag(2.0)
	opC = CSROperator.from_scipy(C.tocsr())
	assert opC.ell_data is None and opC.sell is not None
	assert np.allclose(np.asarray(opC.matmat(V)), C.tocsr() @ V, atol=1e-12)
	yc = jax.jit(lambda o, V: o.matmat(V))(opC, jnp.asarray(V))
	assert np.allclose(np.asarray(yc), C.tocsr() @ V, atol=1e-12)


def test_coo_rows_sorted_detection():
	"""COO records row-major ordering at construction (scipy .tocoo() emits it)
	so the segment reduction can skip its scatter sort; unsorted triplets are
	detected and still reduce correctly."""
	A = sps.random(100, 100, density=0.05, random_state=0).tocsr()
	op = COOOperator.from_scipy(A)
	assert op.rows_sorted is True
	V = np.random.default_rng(0).normal(size=(100, 3))
	assert np.allclose(np.asarray(op.matmat(V)), A @ V, atol=1e-10)
	r, c, d = np.array([5, 1, 3]), np.array([0, 1, 2]), np.array([1.0, 2.0, 3.0])
	op2 = COOOperator(d, r, c, (6, 3))
	assert op2.rows_sorted is False
	ref = np.zeros((6, 3))
	ref[r, c] = d
	assert np.allclose(np.asarray(op2.matmat(np.eye(3))), ref)


def test_bsr_fill_in_warning_fires_on_scipy_fallback():
	"""The scattered-pattern warning must use the LOGICAL nnz, not the already-
	inflated BSR storage count (scipy fallback path)."""
	import warnings

	rng = np.random.default_rng(0)
	A = sps.random(128, 128, density=0.01, random_state=rng, format="csr")
	A = A + A.T
	with warnings.catch_warnings(record=True) as ws:
		warnings.simplefilter("always")
		BSROperator.from_scipy(A, blocksize=(8, 8), engine="scipy")
	assert any("not block-structured" in str(w.message) for w in ws)


def test_csr_construction_under_jit():
	"""Review r3d: CSROperator builds inside jit (tracer-aware rowids, ELL
	analysis skipped) like COOOperator."""
	import scipy.sparse as sps

	n = 32
	A = sps.random(n, n, density=0.2, random_state=0, format="csr")
	A = A + A.T

	import jax

	@jax.jit
	def apply(data, v):
		from primate_tpu.operators.sparse import CSROperator

		op = CSROperator(data, jnp.asarray(A.indices), jnp.asarray(A.indptr), A.shape)
		return op.matvec(v)

	v = np.random.default_rng(1).normal(size=n)
	got = np.asarray(apply(jnp.asarray(A.data), jnp.asarray(v)))
	assert np.allclose(got, A @ v, atol=1e-8)


def test_bsr_rectangular_adjoint():
	"""BSR adjoint on a rectangular block grid (base fallback used to
	shape-error or silently return A v)."""
	import scipy.sparse as sps

	rng = np.random.default_rng(5)
	X = sps.random(24, 16, density=0.3, random_state=7, format="csr")
	from primate_tpu.operators.sparse import BSROperator

	op = BSROperator.from_scipy(X.tobsr(blocksize=(4, 4)))
	u = rng.normal(size=24)
	got = np.asarray(op.rmatvec(jnp.asarray(u)))
	assert np.allclose(got, X.T @ u, atol=1e-8)


def test_bsr_bell_gating():
	"""bell=False disables the block-ELL planes; tail without ELL raises even
	under tracing (round-5 review findings)."""
	import pytest
	import scipy.sparse as sps

	rng = np.random.default_rng(5)
	S = sps.kron(sps.random(16, 16, density=0.2, random_state=5, format="csr"), np.ones((8, 8))).tobsr(blocksize=(8, 8))
	op_on = BSROperator(S.data, S.indices, S.indptr, S.shape)
	op_off = BSROperator(S.data, S.indices, S.indptr, S.shape, bell=False)
	assert op_on.bell_blocks is not None and op_off.bell_blocks is None
	V = rng.normal(size=(S.shape[1], 9)).astype(np.float32)
	assert np.allclose(np.asarray(op_on.matmat(jnp.asarray(V))), np.asarray(op_off.matmat(jnp.asarray(V))), atol=1e-4)

	with pytest.raises(ValueError, match="tail"):
		CSROperator(
			np.ones(3, np.float32), np.arange(3, dtype=np.int32), np.array([0, 1, 2, 3], np.int32), (3, 3),
			tail=(np.ones(1, np.float32), np.zeros(1, np.int32), np.zeros(1, np.int32)),
		)
