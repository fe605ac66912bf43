"""Spectral analysis of a graph with implicit operators.

Builds a random-geometric-ish sparse graph, then computes — without ever
densifying the Laplacian — the Estrada index, heat-kernel signature,
eigenvalue counts, and the density of states by both SLQ and KPM.

Run: python examples/graph_analysis.py
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))  # repo-checkout runs

import numpy as np
import scipy.sparse as sps

import primate_tpu as pt
from primate_tpu.operators.sparse import CSROperator


def build_graph_laplacian(n=2000, k=6, seed=0) -> sps.csr_matrix:
	"""k-nearest-neighbor graph on random 2-D points (symmetrized)."""
	rng = np.random.default_rng(seed)
	pts = rng.uniform(size=(n, 2))
	from scipy.spatial import cKDTree

	tree = cKDTree(pts)
	_, idx = tree.query(pts, k=k + 1)
	rows = np.repeat(np.arange(n), k)
	cols = idx[:, 1:].ravel()
	W = sps.csr_matrix((np.ones(n * k), (rows, cols)), shape=(n, n))
	W = W.maximum(W.T)
	L = sps.diags(np.asarray(W.sum(axis=1)).ravel()) - W
	return L.tocsr()


def main():
	L = build_graph_laplacian()
	op = CSROperator.from_scipy(L)
	n = op.shape[0]

	estrada = pt.recipes.estrada_index(op, t=-0.5, deg=24, converge="count", count=128, seed=1)
	print(f"Estrada-type index tr(exp(-L/2)) ≈ {estrada:.1f}")

	n_small = pt.recipes.eigencount(op, (-0.01, 1.0), deg=40, converge="count", count=256, seed=2)
	print(f"eigenvalues in (0, 1]: ≈ {n_small} of {n}")

	hks = pt.recipes.heat_kernel_signature(op, [0.1, 1.0, 10.0], deg=24, converge="count", count=64, seed=3)
	print(f"heat-kernel signature: shape {hks.shape}, t=0.1 mean {hks[0].mean():.4f}")

	# Communicability between two nodes: a single ENTRY of exp(-L/2), computed
	# deterministically from two quadratic forms (polarization identity).
	j = int(L[0].indices[L[0].indices != 0][0])  # a neighbor of node 0
	ei, ej = np.eye(n)[:, 0], np.eye(n)[:, j]
	comm = pt.recipes.bilinear_form(op, ei, ej, fun="exp", fun_kwargs={"t": -0.5}, deg=24)
	print(f"communicability exp(-L/2)[0, {j}] ≈ {float(comm):.6f}")

	ts, phi = pt.spectral_density(op, deg=64, nv=8, seed=4)
	ts2, phi2 = pt.kpm.kpm_density(op, m=128, nv=8, seed=5)
	print(f"DOS (SLQ):  peak at λ≈{ts[np.argmax(phi)]:.2f}")
	print(f"DOS (KPM):  peak at λ≈{ts2[np.argmax(phi2)]:.2f}")


if __name__ == "__main__":
	main()
