"""DIA (banded/stencil) operator tests: node-major and probe-major stencils."""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sps

import primate_tpu as pt
from primate_tpu.operators.sparse import DIAOperator


def _banded(n: int, offsets, seed: int) -> sps.dia_matrix:
	rng = np.random.default_rng(seed)
	diags = [rng.normal(size=n - abs(o)) for o in offsets]
	return sps.diags(diags, offsets)


@pytest.mark.parametrize("offsets", [[-1, 0, 1], [-5, -1, 0, 1, 5], [0, 3], [-2, 0]])
def test_dia_matmat_matches_scipy(offsets):
	n = 150
	A = _banded(n, offsets, seed=1)
	op = DIAOperator.from_scipy(A)
	V = np.random.default_rng(2).normal(size=(n, 6))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V)
	v = V[:, 0]
	assert np.allclose(np.asarray(op.rmatvec(jnp.asarray(v))), A.T @ v)
	assert np.allclose(np.asarray(op.todense()), A.toarray())


@pytest.mark.parametrize("k", [1, 5, 128, 130])
def test_dia_matmat_probe_counts_match_scipy(k):
	"""Node-major stencil at every probe-block width, incl. >128 columns."""
	n = 300
	A = _banded(n, [-7, -1, 0, 1, 7], seed=3)
	op = DIAOperator.from_scipy(A)
	V = np.random.default_rng(4).normal(size=(n, k))
	assert np.allclose(np.asarray(op.matmat(jnp.asarray(V))), A @ V, atol=1e-10)


def test_hutch_on_dia_laplacian():
	n = 256
	main = 3.0 * np.ones(n)
	off = -1.0 * np.ones(n - 1)
	A = sps.diags([off, main, off], [-1, 0, 1])
	op = DIAOperator.from_scipy(A)
	est = pt.hutch(op, seed=7, converge="count", count=512)
	assert abs(est - 3.0 * n) < 10 / np.sqrt(n) * 30  # tr = 3n


def test_slq_logdet_on_dia():
	n = 256
	main = 3.0 * np.ones(n)
	off = -1.0 * np.ones(n - 1)
	A = sps.diags([off, main, off], [-1, 0, 1])
	op = DIAOperator.from_scipy(A)
	M = pt.MatrixFunction(op, fun="log", deg=30, orth=30)
	est = pt.hutch(M, seed=8, converge="count", count=256, batch=32)
	k = np.arange(1, n + 1)
	exact = float(np.sum(np.log(3.0 - 2.0 * np.cos(k * np.pi / (n + 1)))))
	assert abs(est - exact) / abs(exact) < 0.05


@pytest.mark.parametrize("offsets", [[-7, -1, 0, 1, 7], [-200, 0, 200], [0], [3, 40]])
@pytest.mark.parametrize("k", [1, 13])
def test_dia_probe_major_matches_scipy(offsets, k):
	"""Probe-major stencil (the layout the Lanczos sweep carries) ≡ scipy,
	for narrow, wide and one-sided bands and an odd probe count."""
	n = 600
	A = _banded(n, offsets, seed=7)
	op = DIAOperator.from_scipy(A)
	Xt = np.random.default_rng(8).normal(size=(k, n))
	got = np.asarray(op.matmat_t(jnp.asarray(Xt)))
	assert got.shape == (k, n)
	assert np.allclose(got, (A @ Xt.T).T, atol=1e-10)
