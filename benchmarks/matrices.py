"""Locally-built irregular benchmark matrices (BASELINE config 3 realism).

BASELINE config 3 names "SuiteSparse SPD matrices" — unreachable here (zero
egress), so these generators build the closest honest local analogs (
r3 #8), spanning the sparsity-structure axes that drive SpMM behavior:

  * ``powerlaw_laplacian`` — graph Laplacian of a preferential-attachment
    (Barabási–Albert) graph: power-law degree distribution, a few huge rows
    among many short ones, scattered pattern. The worst case for ELL padding
    and for halo partitioning — exercises the `segment_sum` CSR path and the
    allgather comm scheme.
  * ``fem_laplacian_3d`` — 7-point finite-difference Laplacian on an L³ grid
    (+I): banded with three far off-diagonals (±1, ±L, ±L²), the classic FEM
    stencil. DIA-native, halo-partitionable after the offsets are inside one
    chip's rows.
  * ``block_random_spd`` — the block-structured case (dense 8×8 tiles on a
    random symmetric block pattern), BSR-native — the genuinely
    block-structured regime the round-3 suite already used.

All three are SPD (diagonally dominant by construction), f32-friendly, and
deterministic per (n, seed).
"""

import numpy as np
import scipy.sparse as sps

__all__ = ["powerlaw_laplacian", "fem_laplacian_3d", "block_random_spd"]


def powerlaw_laplacian(n: int, m: int = 4, seed: int = 0, shift: float = 1.0) -> sps.csr_matrix:
	"""Graph Laplacian (+``shift``·I) of a Barabási–Albert graph on ``n`` nodes.

	Preferential attachment: each new node attaches ``m`` edges to existing
	nodes with probability ∝ current degree — the standard generator for
	power-law degree distributions (hub rows with thousands of nonzeros next
	to degree-``m`` leaves). Implemented with the repeated-targets trick
	(attach uniformly into the running edge-endpoint list), vectorized per
	node; O(n·m).
	"""
	rng = np.random.default_rng(seed)
	m = int(m)
	assert n > m >= 1
	# Running endpoint pool: each edge contributes both endpoints, so uniform
	# draws from the pool are degree-proportional draws over nodes.
	pool = np.empty(2 * m * n, np.int64)
	pool[: 2 * m] = np.arange(m).repeat(2)  # seed clique-ish start: m nodes, self-paired
	fill = 2 * m
	src, dst = [], []
	for v in range(m, n):
		targets = pool[rng.integers(0, fill, m)] if fill else np.arange(m)
		targets = np.unique(targets)  # collapse duplicate draws (keeps SPD simple)
		src.append(np.full(targets.size, v))
		dst.append(targets)
		new = np.empty(2 * targets.size, np.int64)
		new[0::2] = v
		new[1::2] = targets
		pool[fill : fill + new.size] = new
		fill += new.size
	src = np.concatenate(src)
	dst = np.concatenate(dst)
	W = sps.coo_matrix((np.ones(src.size, np.float32), (src, dst)), shape=(n, n))
	W = W + W.T
	W.data[:] = 1.0  # simple graph
	deg = np.asarray(W.sum(axis=1)).ravel()
	L = sps.diags(deg + np.float32(shift)) - W
	return L.tocsr().astype(np.float32)


def fem_laplacian_3d(side: int, shift: float = 1.0) -> sps.csr_matrix:
	"""7-point Laplacian (+``shift``·I) on a ``side³`` grid — offsets ±1, ±L, ±L²."""
	n = side**3
	main = (6.0 + shift) * np.ones(n, np.float32)
	ex = -np.ones(n - 1, np.float32)
	ex[side - 1 :: side] = 0  # no wrap across x-rows
	ey = -np.ones(n - side, np.float32)
	# no wrap across y-planes: zero the couplings that cross a z-slab boundary
	yidx = np.arange(n - side)
	ey[(yidx % side**2) >= side**2 - side] = 0
	ez = -np.ones(n - side**2, np.float32)
	return sps.diags(
		[ez, ey, ex, main, ex, ey, ez],
		[-(side**2), -side, -1, 0, 1, side, side**2],
	).tocsr().astype(np.float32)


def block_random_spd(n: int = 4096, bs: int = 8, density: float = 0.04, seed: int = 7) -> sps.csr_matrix:
	"""Random symmetric pattern of dense ``bs×bs`` tiles + diagonal dominance."""
	rng = np.random.default_rng(seed)
	nb = n // bs
	pattern = sps.random(nb, nb, density=density, random_state=rng, format="coo")
	rows = np.concatenate([pattern.row, pattern.col, np.arange(nb)])
	cols = np.concatenate([pattern.col, pattern.row, np.arange(nb)])
	uniq = np.unique(np.stack([rows, cols], 1), axis=0)
	blocks = rng.normal(size=(uniq.shape[0], bs, bs)).astype(np.float32)
	r = (uniq[:, 0, None] * bs + np.arange(bs))[:, :, None]
	c = (uniq[:, 1, None] * bs + np.arange(bs))[:, None, :]
	A = sps.coo_matrix(
		(blocks.ravel(), (np.broadcast_to(r, blocks.shape).ravel(), np.broadcast_to(c, blocks.shape).ravel())),
		shape=(n, n),
	).tocsr()
	A = (A + A.T) * 0.5
	rowsum = np.abs(A).sum(axis=1)
	return (A + sps.diags(np.asarray(rowsum).ravel() + 1.0)).tocsr().astype(np.float32)
