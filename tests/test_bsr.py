"""BSR SpMM through its XLA paths (block-ELL and segment_sum) against dense."""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sps

from primate_tpu.operators.sparse import BSROperator
from primate_tpu.random import symmetric


def _random_bsr(n: int, bm: int, bn: int, density: float, seed: int, bell=None) -> tuple:
	rng = np.random.default_rng(seed)
	A = sps.random(n, n, density=density, random_state=rng, format="csr")
	A = (A + A.T).tocsr()  # symmetric
	op = BSROperator.from_scipy(A, blocksize=(bm, bn))
	if bell is not None:
		op = BSROperator(op.blocks, op.indices, op.indptr, op.shape, bell=bell)
	return A, op


@pytest.mark.parametrize("bell", [True, False])
@pytest.mark.parametrize("bm,bn", [(4, 4), (8, 8), (8, 16)])
def test_bsr_matmat_matches_dense(bm, bn, bell):
	A, op = _random_bsr(64, bm, bn, density=0.05, seed=0, bell=bell)
	assert (op.bell_blocks is not None) == bell
	V = np.random.default_rng(1).normal(size=(64, 8))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)


def test_bsr_matmat_sparsified_symmetric():
	n = 32
	A = np.array(symmetric(n, seed=5))
	A[np.abs(A) < 0.02] = 0.0  # sparsify but keep symmetric support
	op = BSROperator.from_scipy(sps.csr_matrix(A), blocksize=(8, 8))
	V = np.random.default_rng(2).normal(size=(n, 3))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)


def test_bsr_empty_block_rows():
	# Rows 8..15 entirely zero: the empty block-row must still produce zeros.
	n = 32
	A = np.zeros((n, n))
	A[:8, :8] = np.arange(64).reshape(8, 8)
	A[16:, 16:] = 1.0
	op = BSROperator.from_scipy(sps.csr_matrix(A), blocksize=(8, 8))
	assert np.all(np.diff(np.asarray(op.indptr)) >= 1)  # every block row covered
	V = np.random.default_rng(3).normal(size=(n, 4))
	got = np.asarray(op.matmat(jnp.asarray(V)))
	assert np.allclose(got, A @ V, atol=1e-10)
	assert np.allclose(got[8:16], 0.0)


def test_bsr_single_vector():
	A, op = _random_bsr(48, 8, 8, density=0.1, seed=7)
	v = np.random.default_rng(4).normal(size=48)
	got = op.matvec(jnp.asarray(v))
	assert got.shape == (48,)
	assert np.allclose(np.asarray(got), A @ v, atol=1e-10)


def test_bsr_wide_probe_block():
	# k > 128: no probe-width assumption anywhere in the apply.
	A, op = _random_bsr(64, 8, 8, density=0.08, seed=9)
	V = np.random.default_rng(5).normal(size=(64, 130))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)


def test_bsr_flat_block_ell_matches_dense(monkeypatch):
	"""Rows with more stored blocks than the slot-unroll bound take the flat
	one-gather block-ELL form."""
	import primate_tpu.operators.sparse as sparse

	monkeypatch.setattr(sparse, "_ELL_UNROLL_MAX", 2)
	A, op = _random_bsr(64, 4, 4, density=0.2, seed=11)
	assert op.bell_idx.shape[1] > 2
	V = np.random.default_rng(6).normal(size=(64, 5))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)
