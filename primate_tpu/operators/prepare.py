"""Operator preparation: bandwidth-reducing reordering + storage-format choice.

The reference hands whatever scipy matrix the user built straight to Eigen
(``src/primate/include/eigen_operators.h:58-104``) — on CPU, CSR gather cost is
roughly format-independent. On an accelerator the format IS the performance
model:

  * DIA stencils stream with zero gathers (speed-of-light for banded),
  * BSR runs dense block products when the pattern is genuinely
    block-structured,
  * CSR/ELL pays a gather per nonzero — the slow path.

Many matrices are banded *in the right ordering* (mesh/graph Laplacians under
reverse-Cuthill-McKee), and the estimators this library exists for — trace,
logdet, spectral sums, densities — are **similarity-invariant**: for any
permutation P, ``tr f(P A Pᵀ) = tr f(A)``. So reordering is free accuracy-wise
and can be 10×+ in throughput. ``auto_operator`` packages the decision:
measure, reorder if it helps, pick the format, and report what it did.

Diagonal estimates are *not* invariant — they come back in the permuted basis.
``PrepInfo.perm`` is the row map (``B = A[perm][:, perm]``), so
``diag_A[perm] = diag_B`` recovers the original ordering (``PrepInfo.unpermute``
does this).
"""

from typing import NamedTuple, Optional, Tuple

import numpy as np

from .base import DenseOperator, LinearOperator
from .sparse import BSROperator, CSROperator, DIAOperator

__all__ = ["PrepInfo", "auto_operator", "bandwidth", "gershgorin_interval", "reorder_rcm"]


def gershgorin_interval(A) -> Tuple[float, float]:
	"""Deterministic spectral enclosure ``[min(aᵢᵢ−Rᵢ), max(aᵢᵢ+Rᵢ)]``.

	Gershgorin's theorem: every eigenvalue lies within ``Rᵢ = Σ_{j≠i}|aᵢⱼ|``
	of some diagonal entry. Unlike the Rayleigh-Ritz sweep the package uses by
	default (tight but a *lower* bound on the spectral range — its fixed 3%
	inflation can under-enclose adversarial spectra), this bound is GUARANTEED
	to contain the spectrum: the safe choice for Chebyshev/KPM intervals, where
	an eigenvalue outside the mapped [−1, 1] makes the recurrence diverge.
	Looser than Rayleigh-Ritz on diagonally-dominated but non-diagonal
	matrices — trade resolution for safety via ``interval="gershgorin"`` on the
	KPM entry points.

	One host-side pass over the structural data (dense arrays, scipy sparse,
	and the Dense/CSR/COO/DIA/BSR operator pytrees). Implicit operators
	(callables) have no accessible entries — raises ``TypeError``.
	"""
	import scipy.sparse as sps

	from .sparse import COOOperator, DIAOperator

	if isinstance(A, DIAOperator):
		bands = np.asarray(A.bands)
		offsets = list(A.offsets)
		n = A.shape[0]
		diag = bands[offsets.index(0)] if 0 in offsets else np.zeros(n, bands.dtype)
		diag = np.real(np.asarray(diag))  # Hermitian ⇒ real diagonal (match the dense/sparse paths below)
		radius = sum(np.abs(bands[k]) for k, off in enumerate(offsets) if off != 0)
		radius = np.zeros(n) if isinstance(radius, int) else radius
		return float(np.min(diag - radius)), float(np.max(diag + radius))
	if isinstance(A, COOOperator):
		S = sps.coo_matrix((np.asarray(A.data), (np.asarray(A.row), np.asarray(A.col))), shape=A.shape)
	elif isinstance(A, LinearOperator) and hasattr(A, "indptr") and hasattr(A, "rowids"):
		# CSR / BSR pytrees: expand to scipy CSR via their per-nnz coordinates.
		if A.__class__.__name__ == "BSROperator":
			bm, bn = A.blocksize
			blocks = np.asarray(A.blocks)
			brow = np.asarray(A.rowids)
			bcol = np.asarray(A.indices)
			nnzb = blocks.shape[0]
			r = (brow[:, None, None] * bm + np.arange(bm)[None, :, None]).repeat(bn, axis=2)
			c = (bcol[:, None, None] * bn + np.arange(bn)[None, None, :]).repeat(bm, axis=1)
			S = sps.coo_matrix((blocks.ravel(), (r.ravel(), c.ravel())), shape=(max(A.shape[0], (brow.max() + 1) * bm if nnzb else 0), max(A.shape[1], (bcol.max() + 1) * bn if nnzb else 0)))
			S = S.tocsr()[: A.shape[0], : A.shape[1]]
		else:
			S = sps.csr_matrix((np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr)), shape=A.shape)
	elif isinstance(A, DenseOperator):
		S = np.asarray(A.A)
	elif sps.issparse(A) or isinstance(A, np.ndarray) or hasattr(A, "__array__"):
		S = A if sps.issparse(A) else np.asarray(A)
	else:
		raise TypeError(f"gershgorin_interval needs access to the matrix entries; got {type(A).__name__}")

	if sps.issparse(S):
		S = S.tocsr()
		diag = S.diagonal()
		# .sum returns np.matrix for spmatrix, plain ndarray for sparse arrays
		radius = np.asarray(np.abs(S).sum(axis=1)).ravel() - np.abs(diag)
	else:
		diag = np.diag(S)
		radius = np.abs(S).sum(axis=1) - np.abs(diag)
	diag = np.real(diag)  # Hermitian operators have a real diagonal/spectrum
	return float(np.min(diag - radius)), float(np.max(diag + radius))


class PrepInfo(NamedTuple):
	"""What ``auto_operator`` decided and why.

	Attributes:
		format: chosen storage — "dense" | "dia" | "bsr" | "csr".
		perm: row/column permutation applied (``B = A[perm][:, perm]``), or
			None when the natural ordering was kept. Spectral sums are
			unaffected; per-coordinate outputs (diag, matvec) live in the
			permuted basis.
		bandwidth: max |i − j| over stored nonzeros, in the chosen ordering.
		fill: stored-values / logical-nnz ratio of the chosen format
			(1.0 = no padding; DIA/BSR trade fill for gather-free applies).
	"""

	format: str
	perm: Optional[np.ndarray]
	bandwidth: int
	fill: float

	def unpermute(self, x: np.ndarray, axis: int = 0) -> np.ndarray:
		"""Map a per-coordinate result (diag, matvec output) back to the
		original ordering: ``out[perm] = x`` along ``axis``."""
		x = np.asarray(x)
		if self.perm is None:
			return x
		out = np.empty_like(x)
		idx = [slice(None)] * x.ndim
		idx[axis] = self.perm
		out[tuple(idx)] = x
		return out

	def permute(self, x: np.ndarray, axis: int = 0) -> np.ndarray:
		"""Map original-basis coordinates into the operator's basis
		(``x[perm]`` along ``axis``) — e.g. an initial vector ``v0``."""
		x = np.asarray(x)
		if self.perm is None:
			return x
		idx = [slice(None)] * x.ndim
		idx[axis] = self.perm
		return x[tuple(idx)]


def _analyze(A, blocksize: Tuple[int, int] = (8, 8)) -> dict:
	"""One-pass structural stats of a CSR matrix for format selection.

	``{"n_diags", "bandwidth", "n_tiles", "max_row_nnz"}`` — computed by the
	native C++ analyzer (`native.csr_analyze`, no temporaries) when available,
	else with numpy (materializes the per-nnz offset array).
	"""
	from ..native import csr_analyze

	if A.nnz == 0:
		return {"n_diags": 0, "bandwidth": 0, "n_tiles": 0, "max_row_nnz": 0}
	stats = csr_analyze(A, *blocksize)
	if stats is not None:
		return stats
	n, m = A.shape
	bm, bn = blocksize
	rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
	cols = A.indices.astype(np.int64)
	offs = cols - rows
	uniq = np.unique(offs)
	tiles = np.unique(rows // bm * (1 + (m - 1) // bn) + cols // bn)
	return {
		"n_diags": len(uniq),
		"bandwidth": int(np.abs(uniq).max()),
		"n_tiles": len(tiles),
		"max_row_nnz": int(np.diff(A.indptr).max()),
	}


def bandwidth(A) -> int:
	"""Max ``|i − j|`` over nonzeros (0 for diagonal/empty matrices)."""
	import scipy.sparse as sps

	A = sps.csr_matrix(A) if not sps.issparse(A) else A.tocsr()
	return _analyze(A)["bandwidth"]


def reorder_rcm(A) -> Tuple["object", np.ndarray]:
	"""Reverse-Cuthill-McKee reordering of a square sparse matrix.

	Returns ``(A[perm][:, perm] as CSR, perm)``. The permutation is computed
	on the symmetrized structure, so unsymmetric inputs are handled (the
	reordered matrix keeps their values).
	"""
	import scipy.sparse as sps
	from scipy.sparse.csgraph import reverse_cuthill_mckee

	A = sps.csr_matrix(A) if not sps.issparse(A) else A.tocsr()
	if A.shape[0] != A.shape[1]:
		raise ValueError(f"RCM needs a square matrix, got {A.shape}")
	structure = (A + A.T).tocsr()
	perm = np.asarray(reverse_cuthill_mckee(structure, symmetric_mode=True))
	return A[perm][:, perm].tocsr(), perm




def auto_operator(
	A,
	dtype=None,
	reorder: str = "auto",
	dense_density: float = 0.125,
	dense_n: int = 512,
	dia_fill_limit: float = 4.0,
	bsr_fill_limit: float = 1.5,
	blocksize: Tuple[int, int] = (8, 8),
) -> Tuple[LinearOperator, PrepInfo]:
	"""Pick the fastest storage format for a matrix, reordering if it helps.

	Decision ladder (each step falls through when its fill bound fails):

	1. **dense** — density ≥ ``dense_density`` or ``n ≤ dense_n``: dense GEMMs
	   beat any sparse path at these sizes.
	2. **dia** — if the diagonal-band fill (``n_bands·n / nnz``) in the natural
	   ordering, or after RCM when ``reorder != "never"``, is ≤
	   ``dia_fill_limit``: gather-free stencil applies.
	3. **bsr** — if the pattern is genuinely block-structured at ``blocksize``
	   (tile fill ≤ ``bsr_fill_limit``), natural ordering.
	4. **csr** — the general path (builds its ELL fast path automatically when
	   row lengths are regular).

	``reorder``: "auto" applies RCM only when it unlocks the DIA format;
	"always" keeps the RCM ordering even for the CSR fallback (can shrink the
	sharded-SpMM halo, see ``parallel.shard_operator``); "never" skips it.

	Returns ``(operator, PrepInfo)``. With a non-None ``PrepInfo.perm`` the
	operator is ``A[perm][:, perm]`` — identical spectrum (trace / logdet /
	density / eigenvalue estimates unchanged); use ``info.unpermute`` on
	per-coordinate outputs and ``info.permute`` on per-coordinate inputs.
	"""
	import scipy.sparse as sps

	if reorder not in ("auto", "always", "never"):
		raise ValueError(f"reorder must be 'auto' | 'always' | 'never', got {reorder!r}")

	if not sps.issparse(A):
		Ad = np.asarray(A)
		op = DenseOperator(Ad if dtype is None else Ad.astype(dtype))
		return op, PrepInfo("dense", None, max(Ad.shape[0] - 1, 0), 1.0)

	A = A.tocsr()
	n, m = A.shape
	square = n == m
	density = A.nnz / max(n * m, 1)

	if density >= dense_density or max(n, m) <= dense_n:
		op = DenseOperator(np.asarray(A.todense(), dtype=dtype))
		return op, PrepInfo("dense", None, max(n - 1, 0), 1.0)

	# --- DIA: natural ordering first, RCM if that unlocks it -------------
	perm: Optional[np.ndarray] = None
	stats = _analyze(A, blocksize)
	if square and A.nnz:
		fill_nat = stats["n_diags"] * n / A.nnz
		if fill_nat <= dia_fill_limit:
			# Natural order wins when already band-viable: no basis bookkeeping.
			return DIAOperator.from_scipy(A, dtype=dtype), PrepInfo("dia", None, stats["bandwidth"], fill_nat)
		if reorder != "never":
			A_rcm, p = reorder_rcm(A)
			stats_rcm = _analyze(A_rcm, blocksize)
			fill_rcm = stats_rcm["n_diags"] * n / A.nnz
			if fill_rcm <= dia_fill_limit:
				return (
					DIAOperator.from_scipy(A_rcm, dtype=dtype),
					PrepInfo("dia", p, stats_rcm["bandwidth"], fill_rcm),
				)
			if reorder == "always" and stats_rcm["bandwidth"] < stats["bandwidth"]:
				A, perm, stats = A_rcm, p, stats_rcm  # tighter band for fallbacks

	# --- BSR: only when the pattern is genuinely block-structured --------
	if A.nnz and stats["n_tiles"] * blocksize[0] * blocksize[1] / A.nnz <= bsr_fill_limit:
		op = BSROperator.from_scipy(A, blocksize=blocksize, dtype=dtype)
		fill = op.blocks.shape[0] * blocksize[0] * blocksize[1] / A.nnz
		return op, PrepInfo("bsr", perm, stats["bandwidth"], fill)

	# --- CSR: the general path -------------------------------------------
	op = CSROperator.from_scipy(A, dtype=dtype)
	return op, PrepInfo("csr", perm, stats["bandwidth"] if square else max(n, m) - 1, 1.0)
