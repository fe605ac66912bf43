"""Singular-spectrum summaries of an implicit RECTANGULAR data matrix.

A tall data matrix is observed only through products ``Xv`` / ``Xᵀu`` (here: a
low-rank-plus-noise stream that is never materialized beyond its factors).
Everything below runs matrix-free:

  * nuclear norm / Schatten curve — `hutch` over a Gram `MatrixFunction`,
    whose quadrature goes through Golub-Kahan bidiagonalization (conditions
    at κ(X), not κ(X)²; one X and one Xᵀ apply per Krylov step)
  * effective rank (‖X‖²_* / ‖X‖²_F-style participation via Schatten 1 and 2)
  * top singular triplets — `svds` (LOBPCG on the smaller Gram side)
  * the GKL factorization itself — `lanczos_bidiag`

Run: python examples/rectangular_spectra.py
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))  # repo-checkout runs

import numpy as np
import jax.numpy as jnp

import primate_tpu as pt


class StreamedData(pt.operators.LinearOperator):
	"""Implicit m×n data operator L Rᵀ + σ·G without forming the m×n array.

	(G itself is a fixed dense noise matrix here for verifiability; in a real
	pipeline this would be a generator or an out-of-core stream.)
	"""

	def __init__(self, L, R, G, sigma):
		self.L, self.R, self.G, self.sigma = map(jnp.asarray, (L, R, G, sigma))
		self.shape = (self.L.shape[0], self.R.shape[0])
		self.dtype = self.L.dtype

	def _matmat(self, V):
		return self.L @ (self.R.T @ V) + self.sigma * (self.G @ V)

	def rmatmat(self, U):
		return self.R @ (self.L.T @ U) + self.sigma * (self.G.T @ U)

	def rmatvec(self, u):
		return self.rmatmat(u[:, None])[:, 0]

	def tree_flatten(self):
		return (self.L, self.R, self.G, self.sigma), (self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.L, obj.R, obj.G, obj.sigma = children
		obj.shape, obj.dtype = aux
		return obj


import jax  # noqa: E402

jax.tree_util.register_pytree_node_class(StreamedData)


def main():
	rng = np.random.default_rng(0)
	m, n, r = 2000, 400, 12
	L = rng.standard_normal((m, r)) / np.sqrt(m)
	R = rng.standard_normal((n, r)) * np.geomspace(20.0, 2.0, r)
	G = rng.standard_normal((m, n)) / np.sqrt(m)
	X = StreamedData(L.astype(np.float32), R.astype(np.float32), G.astype(np.float32), 0.05)

	# Ground truth (dense, for the demo only).
	s_true = np.linalg.svd(L @ R.T + 0.05 * G, compute_uv=False)

	# Schatten curve from ONE set of GKL sweeps (stacked p-family).
	ps = np.array([1.0, 2.0, 4.0])
	sp = pt.recipes.schatten(X, p=ps, gram=True, deg=24, orth=8, converge="count", count=256, seed=1)
	for p, est in zip(ps, np.atleast_1d(sp)):
		print(f"Schatten-{p:g}: {est:10.3f}   (true {np.sum(s_true**p) ** (1 / p):10.3f})")

	erank = (sp[0] / sp[1]) ** 2
	print(f"effective rank (S1/S2)^2: {erank:6.2f}  (true {(s_true.sum() / np.linalg.norm(s_true)) ** 2:6.2f})")

	# Top singular triplets, matrix-free.
	U, s, Vh = pt.svds(X, k=4, seed=2)
	print("top-4 singular values:", np.round(s[::-1], 3), " (true", np.round(s_true[:4], 3), ")")

	# The GKL factorization itself: extremal singular values from one probe.
	out = pt.lanczos_bidiag(X, seed=3, deg=24, orth=-1)
	B = np.diag(np.asarray(out.alphas)[:, 0]) + np.diag(np.asarray(out.betas)[:, 0], 1)
	print("GKL deg-24 extremal sigma:", np.round(np.linalg.svd(B, compute_uv=False)[:2], 3))


if __name__ == "__main__":
	main()
