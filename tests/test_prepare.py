"""auto_operator / reorder_rcm: format choice, reordering, basis bookkeeping.

The reference has no analog (formats are Eigen's concern,
``include/eigen_operators.h``); on an accelerator the storage format is the performance
model, so preparation is part of the library surface.
"""

import numpy as np
import scipy.sparse as sps

import pytest

import primate_tpu as pt
import jax.numpy as jnp
from primate_tpu import hutch
from primate_tpu.operators import (
	BSROperator,
	CSROperator,
	DenseOperator,
	DIAOperator,
	auto_operator,
	bandwidth,
	reorder_rcm,
)


def banded(n: int, seed: int = 0) -> sps.csr_matrix:
	rng = np.random.default_rng(seed)
	main = rng.uniform(2.0, 3.0, n)
	off = rng.uniform(-1.0, -0.5, n - 1)
	return sps.diags([off, main, off], [-1, 0, 1]).tocsr()


def shuffled(A: sps.csr_matrix, seed: int = 1):
	rng = np.random.default_rng(seed)
	p = rng.permutation(A.shape[0])
	return A[p][:, p].tocsr()


def test_bandwidth():
	A = banded(600)
	assert bandwidth(A) == 1
	assert bandwidth(sps.eye(10).tocsr()) == 0
	assert bandwidth(shuffled(A)) > 1


def test_rcm_recovers_band():
	A = shuffled(banded(800), seed=3)
	B, perm = reorder_rcm(A)
	assert bandwidth(B) <= 2  # RCM restores (near-)tridiagonal
	assert np.allclose(B.toarray(), A.toarray()[perm][:, perm])


def test_auto_natural_band_is_dia_without_perm():
	A = banded(900)
	op, info = auto_operator(A)
	assert info.format == "dia" and info.perm is None
	assert isinstance(op, DIAOperator)
	v = np.random.default_rng(0).normal(size=900)
	assert np.allclose(np.asarray(op.matvec(v)), A @ v)


def test_auto_shuffled_band_reorders_to_dia():
	A0 = banded(700, seed=5)
	A = shuffled(A0, seed=7)
	op, info = auto_operator(A)
	assert info.format == "dia" and info.perm is not None
	assert info.bandwidth <= 2
	# The operator is A[perm][:, perm]: matvec in the permuted basis.
	v = np.random.default_rng(1).normal(size=700)
	got = info.unpermute(np.asarray(op.matvec(info.permute(v))))
	assert np.allclose(got, A @ v, atol=1e-10)
	# Spectral sums are similarity-invariant: same trace estimate machinery.
	assert np.isclose(np.asarray(op.todense()).trace(), A.toarray().trace())
	ew_op = np.linalg.eigvalsh(np.asarray(op.todense()))
	ew_A = np.linalg.eigvalsh(A.toarray())
	assert np.allclose(ew_op, ew_A, atol=1e-10)


def test_auto_reorder_never_keeps_natural():
	A = shuffled(banded(700), seed=11)
	op, info = auto_operator(A, reorder="never")
	assert info.format == "csr" and info.perm is None
	assert isinstance(op, CSROperator)


def test_auto_block_pattern_is_bsr():
	rng = np.random.default_rng(2)
	nb, b = 40, 8
	mask = rng.random((nb, nb)) < 0.06
	mask |= mask.T
	np.fill_diagonal(mask, True)
	dense = np.kron(mask, np.ones((b, b))) * rng.normal(size=(nb * b, nb * b))
	A = sps.csr_matrix(dense)
	op, info = auto_operator(A, dense_density=0.5, dense_n=64)
	assert info.format == "bsr"
	assert isinstance(op, BSROperator)
	assert info.fill <= 1.5
	v = rng.normal(size=nb * b)
	assert np.allclose(np.asarray(op.matvec(v)), A @ v, atol=1e-8)


def test_auto_scattered_is_csr():
	A = sps.random(1500, 1500, density=0.002, random_state=4, format="csr")
	A = A + A.T
	op, info = auto_operator(A.tocsr())
	assert info.format == "csr" and info.perm is None
	assert isinstance(op, CSROperator)
	assert info.fill == 1.0


def test_auto_dense_paths():
	# ndarray input
	M = np.random.default_rng(5).normal(size=(60, 60))
	op, info = auto_operator(M)
	assert info.format == "dense" and isinstance(op, DenseOperator)
	# small sparse promotes to dense
	op2, info2 = auto_operator(banded(100))
	assert info2.format == "dense"
	# high density promotes to dense
	A = sps.random(700, 700, density=0.3, random_state=6, format="csr")
	op3, info3 = auto_operator(A)
	assert info3.format == "dense"


def test_auto_rectangular_csr():
	A = sps.random(900, 600, density=0.004, random_state=7, format="csr")
	op, info = auto_operator(A)
	assert info.format == "csr" and info.perm is None
	assert op.shape == (900, 600)


def test_permute_unpermute_roundtrip_axes():
	A = shuffled(banded(640), seed=13)
	_, info = auto_operator(A)
	assert info.perm is not None
	X = np.random.default_rng(3).normal(size=(640, 5))
	assert np.allclose(info.unpermute(info.permute(X)), X)
	Xt = X.T
	assert np.allclose(info.unpermute(info.permute(Xt, axis=1), axis=1), Xt)


def test_hutch_trace_invariant_under_preparation():
	A = shuffled(banded(1024, seed=8), seed=9)
	op, info = auto_operator(A, dtype=np.float64)
	assert info.format == "dia"
	true = A.toarray().trace()
	est = hutch(op, converge="count", count=256, seed=0)
	assert abs(est - true) <= 10 / np.sqrt(1024) * np.sqrt(true)


def test_reorder_always_carries_perm_into_csr():
	# A banded-after-RCM matrix whose band is too wide for DIA fill:
	# random symmetric banded with many distinct offsets but sparse rows.
	rng = np.random.default_rng(10)
	n, k = 2000, 30
	rows, cols = [], []
	for i in range(n):
		js = i + rng.choice(np.arange(1, k), size=3, replace=False)
		js = js[js < n]
		rows.extend([i] * len(js))
		cols.extend(js.tolist())
	A = sps.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
	A = (A + A.T + sps.eye(n) * 4).tocsr()
	Ash = shuffled(A, seed=11)
	op, info = auto_operator(Ash, reorder="always", dia_fill_limit=1.01)
	if info.perm is not None:  # RCM shrank the band → reordered CSR
		assert info.format in ("csr", "bsr")
		v = rng.normal(size=n)
		got = info.unpermute(np.asarray(op.matvec(info.permute(v))))
		assert np.allclose(got, Ash @ v, atol=1e-9)


def test_reorder_invalid_raises():
	with pytest.raises(ValueError):
		auto_operator(banded(700), reorder="sometimes")
	with pytest.raises(ValueError):
		reorder_rcm(sps.random(10, 5, density=0.5, format="csr"))


def test_gershgorin_interval_encloses_spectrum_all_formats():
	from primate_tpu.operators.base import DenseOperator
	from primate_tpu.operators.prepare import gershgorin_interval
	from primate_tpu.operators.sparse import BSROperator, COOOperator, CSROperator, DIAOperator

	n = 200
	L = sps.diags([-np.ones(n - 1), 2.5 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	kk = np.arange(1, n + 1)
	lam = 2.5 - 2 * np.cos(kk * np.pi / (n + 1))
	for op in (
		L,
		L.toarray(),
		DIAOperator.from_scipy(L),
		CSROperator.from_scipy(L),
		COOOperator.from_scipy(L),
		BSROperator.from_scipy(L, blocksize=(4, 4)),
		DenseOperator(jnp.asarray(L.toarray())),
	):
		lo, hi = gershgorin_interval(op)
		assert lo <= lam.min() and hi >= lam.max(), type(op).__name__
		assert (lo, hi) == (0.5, 4.5), type(op).__name__  # exact for this stencil


def test_gershgorin_interval_hermitian_and_rejects_implicit():
	import pytest

	from primate_tpu.operators import FunctionOperator
	from primate_tpu.operators.prepare import gershgorin_interval

	H = pt.random.hermitian(50, ew=np.linspace(-1, 1, 50), seed=0)
	lo, hi = gershgorin_interval(np.asarray(H))
	assert lo <= -1 and hi >= 1
	fop = FunctionOperator(lambda V: V, shape=(8, 8), dtype=jnp.float32)
	with pytest.raises(TypeError):
		gershgorin_interval(fop)


def test_gershgorin_interval_complex_hermitian_dia():
	# Complex Hermitian banded operator: the DIA branch must take the real part
	# of the diagonal band (it is real up to roundoff, but complex-typed).
	from primate_tpu.operators.prepare import gershgorin_interval
	from primate_tpu.operators.sparse import DIAOperator

	n = 64
	off = (0.3 + 0.4j) * np.ones(n - 1)
	H = sps.diags([np.conj(off), 2.0 * np.ones(n).astype(complex), off], [-1, 0, 1]).tocsr()
	op = DIAOperator.from_scipy(H)
	lo, hi = gershgorin_interval(op)  # raised TypeError before the fix
	ew = np.linalg.eigvalsh(H.toarray())
	assert lo <= ew.min() and hi >= ew.max()
	assert np.isclose(hi - 2.0, 2.0 - lo)  # symmetric enclosure around the diagonal


def test_kpm_accepts_gershgorin_interval():
	from primate_tpu.operators.sparse import DIAOperator

	n = 200
	L = sps.diags([-np.ones(n - 1), 2.5 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	kk = np.arange(1, n + 1)
	lam = 2.5 - 2 * np.cos(kk * np.pi / (n + 1))
	op = DIAOperator.from_scipy(L)
	est = float(np.asarray(pt.kpm_trace(op, fun="exp", t=-1.0, m=64, nv=64, interval="gershgorin", seed=1)))
	true = float(np.sum(np.exp(-lam)))
	assert abs(est - true) / true < 0.05
	cf = pt.ChebyshevFunction(op, "exp", t=-1.0, deg=64, interval="gershgorin")
	assert cf.interval == (0.5, 4.5)
