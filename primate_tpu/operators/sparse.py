"""Sparse operators: COO / CSR / BSR pytrees with batched SpMV/SpMM.

Parity: reference ``src/primate/include/eigen_operators.h:58-104``
(`SparseEigenLinearOperator`, CSC + optional Gram mode).

Sparse structure is stored as flat device arrays registered as pytrees, and
every apply is plain XLA: gather + multiply + `segment_sum` (or its
scatter-free ELL / block-ELL / stencil forms), which XLA fuses into the
surrounding Lanczos step. Row-partitioning these arrays across a device mesh
gives the distributed SpMM (see ``primate_tpu.parallel``).

Indices are padded to fixed lengths (static shapes) — padding rows point at
row 0 / column 0 with zero data, contributing nothing.
"""

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .base import LinearOperator

__all__ = ["COOOperator", "CSROperator", "BSROperator", "DIAOperator", "GramOperator"]

_ELL_UNROLL_MAX = 128  # slot-unroll bound; larger L chunks through a lax.scan
_ELL_SCAN_CHUNK = 8


def _pad_lanes(V: jnp.ndarray):
	"""Pad a (rows, k) probe block to 128 columns when 16 < k < 64.

	Kept from the first accelerator this library targeted, where narrow
	row-gathers lowered badly; whether it helps on the GPU is unmeasured.
	Returns the padded block and the original k (or the block unchanged and
	None).
	"""
	k = V.shape[-1]
	if 16 < k < 64:
		# The barrier materializes the padded block: without it XLA fuses the
		# pad into every slot gather, which undoes the padding.
		return jax.lax.optimization_barrier(jnp.pad(V, ((0, 0), (0, 128 - k)))), k
	return V, None


def ell_apply(ell_data: jnp.ndarray, ell_idx: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
	"""ELL-plane SpMM ``out[i, :] = Σ_l ell_data[i, l] · V[ell_idx[i, l], :]``.

	Lowered SLOT-BY-SLOT: one (rows, b) row-gather + fused multiply-add per
	slot, instead of materializing the (rows, L, b) gathered tensor, so each
	slot's product fuses into the accumulation with no big intermediate.
	Beyond ``_ELL_UNROLL_MAX`` slots the loop runs as a ``lax.scan`` over slot
	chunks (constant program size).

	Works on any leading index shape: ``ell_idx`` rows index rows of ``V``.
	"""
	rows, L = ell_data.shape
	b = V.shape[1]
	acc = jnp.promote_types(ell_data.dtype, V.dtype)
	if L == 0:
		return jnp.zeros((rows, b), acc)
	if L <= _ELL_UNROLL_MAX:
		out = ell_data[:, 0, None] * V[ell_idx[:, 0], :]
		for l in range(1, L):
			out = out + ell_data[:, l, None] * V[ell_idx[:, l], :]
		return out
	C = _ELL_SCAN_CHUNK
	Lp = -(-L // C) * C
	edc = jnp.pad(ell_data, ((0, 0), (0, Lp - L))).reshape(rows, Lp // C, C).transpose(1, 0, 2)
	eic = jnp.pad(ell_idx, ((0, 0), (0, Lp - L))).reshape(rows, Lp // C, C).transpose(1, 0, 2)

	def body(out, planes):
		e, i = planes
		for l in range(C):  # unrolled inside the chunk: no (rows, C, b) tensor
			out = out + e[:, l, None] * V[i[:, l], :]
		return out, None

	out, _ = jax.lax.scan(body, jnp.zeros((rows, b), acc), (edc, eic))
	return out


def ell_apply_vec(ell_data: jnp.ndarray, ell_idx: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
	"""Single-vector form of :func:`ell_apply` (no trailing probe axis) —
	delegates with a unit probe axis (identical lowering at one lane; one
	implementation keeps the slot/chunk logic in one place)."""
	return ell_apply(ell_data, ell_idx, v[:, None])[:, 0]


@jax.tree_util.register_pytree_node_class
class COOOperator(LinearOperator):
	"""Coordinate-format sparse operator: ``(data, row, col)`` triplets."""

	def __init__(self, data: jnp.ndarray, row: jnp.ndarray, col: jnp.ndarray, shape: Tuple[int, int], rows_sorted: Optional[bool] = None):
		self.data = jnp.asarray(data)
		self.row = jnp.asarray(row, jnp.int32)
		self.col = jnp.asarray(col, jnp.int32)
		self.shape = tuple(shape)
		self.dtype = self.data.dtype
		if rows_sorted is None:
			# Known at trace time (host check on concrete indices) — lets the
			# segment reduction skip its scatter sort. scipy .tocoo() emits
			# row-major order, so this is nearly always True in practice.
			r = np.asarray(row) if not isinstance(row, jax.core.Tracer) else None
			rows_sorted = bool(r is not None and (r.size == 0 or np.all(np.diff(r) >= 0)))
		self.rows_sorted = bool(rows_sorted)

	@classmethod
	def from_scipy(cls, A, dtype=None) -> "COOOperator":
		A = A.tocoo()
		return cls(jnp.asarray(A.data, dtype=dtype), A.row, A.col, A.shape)

	@classmethod
	def from_dense(cls, A, tol: float = 0.0) -> "COOOperator":
		A = np.asarray(A)
		r, c = np.nonzero(np.abs(A) > tol)
		return cls(jnp.asarray(A[r, c]), r, c, A.shape)

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		prod = self.data[:, None] * V[self.col, :]
		return jax.ops.segment_sum(prod, self.row, num_segments=self.shape[0], indices_are_sorted=self.rows_sorted)

	def rmatvec(self, v: jnp.ndarray) -> jnp.ndarray:
		# ADJOINT A†v (= Aᵀv for real data): the base-class contract — conj is
		# an identity on the real path, so the lowering is unchanged.
		prod = jnp.conj(self.data) * v[self.row]
		return jax.ops.segment_sum(prod, self.col, num_segments=self.shape[1])

	def todense(self) -> jnp.ndarray:
		return jnp.zeros(self.shape, self.dtype).at[self.row, self.col].add(self.data)

	def tree_flatten(self):
		return (self.data, self.row, self.col), (self.shape, self.dtype, self.rows_sorted)

	@classmethod
	def tree_unflatten(cls, aux, children):
		# No jnp ops on children: unflatten must accept abstract placeholders.
		obj = object.__new__(cls)
		obj.data, obj.row, obj.col = children
		obj.shape, obj.dtype, obj.rows_sorted = aux
		return obj


@jax.tree_util.register_pytree_node_class
class CSROperator(LinearOperator):
	"""Compressed-sparse-row operator.

	Stores ``indptr`` for structure plus an explicit per-nonzero row-id array so
	SpMM lowers to one gather + one `segment_sum` (no dynamic inner loops — XLA
	needs static shapes).

	When the row-length distribution is tight enough (padding to the max row
	length costs < ``ELL_MAX_FILL``× the nnz), construction additionally lays the
	nonzeros out ELL-style as dense ``(n, L)`` index/value planes. SpMM then
	becomes gather + a dense sum over the L slots — no scatter at all
	(scatter-adds serialize through device memory).

	Power-law row distributions (hub rows orders of magnitude above the
	median) defeat full-ELL padding, so construction then builds the SLICED
	ELL layout instead (see :meth:`_build_sliced`): rows sorted by descending
	length, slot ``l`` covering exactly the prefix of rows longer than ``l`` —
	scatter-free with zero fill waste for any distribution — plus a tiny
	`segment_sum` tail holding only the hub-row entries beyond the slot cap.
	The pure sorted-`segment_sum` path remains for operators constructed under
	tracing (where the host-side layout analysis cannot run).
	"""

	ELL_MAX_FILL = 4.0  # build the ELL planes when n·L ≤ this × nnz

	def __init__(
		self,
		data: jnp.ndarray,
		indices: jnp.ndarray,
		indptr: jnp.ndarray,
		shape: Tuple[int, int],
		rowids: Optional[jnp.ndarray] = None,
		ell_data: Optional[jnp.ndarray] = None,
		ell_idx: Optional[jnp.ndarray] = None,
		tail: Optional[tuple] = None,  # (data, cols, rowids) hub-row overflow
	):
		self.data = jnp.asarray(data)
		self.indices = jnp.asarray(indices, jnp.int32)
		self.indptr = jnp.asarray(indptr, jnp.int32)
		self.shape = tuple(shape)
		self.dtype = self.data.dtype
		traced = any(isinstance(x, jax.core.Tracer) for x in (self.data, self.indices, self.indptr))
		if rowids is None:
			if traced:
				# Construction inside jit: derive rowids with jnp (nnz is
				# static) and skip the host-side ELL analysis, matching
				# COOOperator's tracer guard.
				counts = jnp.diff(self.indptr)
				rowids = jnp.repeat(jnp.arange(self.shape[0]), counts, total_repeat_length=self.data.shape[0])
			else:
				counts = np.diff(np.asarray(self.indptr))
				rowids = np.repeat(np.arange(shape[0]), counts)
		self.rowids = jnp.asarray(rowids, jnp.int32)
		self.sell = None  # sliced-ELL layout for heavy-tailed rows (see _build_sliced)
		if tail is not None and ell_data is None and ell_idx is None:
			# Structural invariant, enforced on the traced path too: the tail
			# holds ELL overflow and is only applied alongside ELL planes — a
			# tail without them would be silently dropped from the product.
			raise ValueError("tail= requires explicit ell_data/ell_idx (it holds the ELL overflow)")
		if ell_data is None and ell_idx is None and not traced:
			ell_data, ell_idx = self._build_ell(
				np.asarray(self.data), np.asarray(self.indices), np.asarray(self.indptr), self.shape[0]
			)
			if ell_data is None:
				built = self._build_sliced(
					np.asarray(self.data), np.asarray(self.indices), np.asarray(self.indptr), self.shape[0]
				)
				if built is not None:
					rank, _nl, s_data, s_idx, s_tail = built
					self.sell = (
						jnp.asarray(rank, jnp.int32),
						tuple(jnp.asarray(d, self.dtype) for d in s_data),
						tuple(jnp.asarray(i, jnp.int32) for i in s_idx),
						None
						if s_tail is None
						else (jnp.asarray(s_tail[0], self.dtype), jnp.asarray(s_tail[1], jnp.int32), jnp.asarray(s_tail[2], jnp.int32)),
						0 if s_tail is None else int(s_tail[3]),
					)
		self.ell_data = None if ell_data is None else jnp.asarray(ell_data, self.dtype)
		self.ell_idx = None if ell_idx is None else jnp.asarray(ell_idx, jnp.int32)
		self.tail = (
			None
			if tail is None
			else (jnp.asarray(tail[0], self.dtype), jnp.asarray(tail[1], jnp.int32), jnp.asarray(tail[2], jnp.int32))
		)

	@classmethod
	def _build_ell(cls, data: np.ndarray, indices: np.ndarray, indptr: np.ndarray, n: int):
		"""Dense (n, L) ELL planes of the nonzeros, or (None, None) when padding
		to the longest row would blow the nnz up by more than ELL_MAX_FILL."""
		counts = np.diff(indptr)
		nnz = int(data.shape[0])
		L = int(counts.max()) if counts.size else 0
		if L == 0 or n * L > cls.ELL_MAX_FILL * max(nnz, 1):
			return None, None
		slot = np.arange(L)[None, :]
		pos = indptr[:-1, None] + slot
		mask = slot < counts[:, None]
		pos = np.minimum(pos, max(nnz - 1, 0))
		ell_idx = np.where(mask, indices[pos], 0).astype(np.int32)
		ell_data = np.where(mask, data[pos], 0)
		return ell_data, ell_idx

	SELL_MAX_SLOTS = 64  # slot cap; row entries beyond it join the hub tail
	SELL_MIN_ROWS = 256  # drop trailing slots covering fewer rows than this

	@classmethod
	def _build_sliced(cls, data: np.ndarray, indices: np.ndarray, indptr: np.ndarray, n: int):
		"""Sliced-ELL layout for row-length distributions full-ELL padding can't
		afford (power-law graphs: hub rows ~1000× the median defeat dense
		(n, L) planes, and the sorted-`segment_sum` fallback is scatter-bound).

		Rows are sorted by DESCENDING length (a row permutation only — column
		ids are untouched, so no matching permutation of the operand is needed);
		slot ``l`` then covers exactly the prefix of rows longer than ``l``, so
		every slot is a dense scatter-free gather with ZERO fill waste for ANY
		distribution. The apply accumulates slots smallest-first into a growing
		prefix buffer (total traffic = covered nnz, not n·L), adds a tiny
		`segment_sum` tail holding only the entries beyond ``SELL_MAX_SLOTS``
		(hub-row overflow, num_segments = #hub rows), and un-permutes with one
		(n, b) row gather.

		Returns ``(rank, nl, slot_data, slot_idx, tail)`` — ``rank[i]`` = sorted
		position of row ``i``, ``nl[l]`` = rows covered by slot ``l``, ``tail``
		``(t_data, t_cols, t_rows, n_hub)`` or None — or None for empty inputs.
		"""
		counts = np.diff(indptr)
		nnz = int(data.shape[0])
		if nnz == 0 or counts.size == 0:
			return None
		order = np.argsort(-counts, kind="stable")
		rank = np.empty(n, np.int32)
		rank[order] = np.arange(n, dtype=np.int32)
		sorted_counts = counts[order]
		Lmax = int(sorted_counts[0])
		S = min(Lmax, cls.SELL_MAX_SLOTS)
		# rows covered by slot l = rows with count > l (prefix of the sort)
		nl = np.array([int(np.searchsorted(-sorted_counts, -(l + 0.5))) for l in range(S)], np.int64)
		while S > 1 and nl[S - 1] < cls.SELL_MIN_ROWS:
			S -= 1
		nl = nl[:S]
		slot_data, slot_idx = [], []
		for l in range(S):
			rows_l = order[: nl[l]]
			pos = indptr[rows_l] + l
			slot_data.append(data[pos])
			slot_idx.append(indices[pos].astype(np.int32))
		tail = None
		n_hub = int(np.searchsorted(-sorted_counts, -(S + 0.5)))  # rows with count > S
		if n_hub > 0:
			hub_rows = order[:n_hub]
			t_data = np.concatenate([data[indptr[r] + S : indptr[r + 1]] for r in hub_rows])
			t_cols = np.concatenate([indices[indptr[r] + S : indptr[r + 1]] for r in hub_rows]).astype(np.int32)
			t_rows = np.repeat(np.arange(n_hub, dtype=np.int32), counts[hub_rows] - S)
			tail = (t_data, t_cols, t_rows, n_hub)
		return (rank, nl, slot_data, slot_idx, tail)

	@property
	def nnz(self) -> int:
		return self.data.shape[0]

	@classmethod
	def from_scipy(cls, A, dtype=None) -> "CSROperator":
		A = A.tocsr()
		return cls(jnp.asarray(A.data, dtype=dtype), A.indices, A.indptr, A.shape)

	@classmethod
	def from_dense(cls, A, tol: float = 0.0) -> "CSROperator":
		import scipy.sparse as sps

		return cls.from_scipy(sps.csr_matrix(np.asarray(A)))

	def _sell_apply(self, V: jnp.ndarray) -> jnp.ndarray:
		"""Sliced-ELL SpMM (see _build_sliced): smallest slot first, each step
		pads the running prefix buffer up to the next slot's row count — total
		accumulate traffic equals the covered nnz, with no scatter anywhere but
		the tiny hub tail."""
		rank, s_data, s_idx, s_tail, n_hub = self.sell
		single = V.ndim == 1
		if single:
			V = V[:, None]
		V, k_orig = _pad_lanes(V)
		n, b = self.shape[0], V.shape[1]
		out = None
		for l in reversed(range(len(s_data))):
			contrib = s_data[l][:, None] * V[s_idx[l], :]
			if out is None:
				out = contrib
			elif contrib.shape[0] == out.shape[0]:
				out = out + contrib
			else:
				out = contrib + jnp.pad(out, ((0, contrib.shape[0] - out.shape[0]), (0, 0)))
		if out is None:
			out = jnp.zeros((0, b), self.dtype)
		if s_tail is not None:
			t_data, t_cols, t_rows = s_tail
			ts = jax.ops.segment_sum(t_data[:, None] * V[t_cols, :], t_rows, num_segments=n_hub, indices_are_sorted=True)
			out = out.at[:n_hub].add(ts)
		if out.shape[0] < n:
			out = jnp.pad(out, ((0, n - out.shape[0]), (0, 0)))
		out = out[rank]  # un-permute: sorted position -> original row
		if k_orig is not None:
			out = out[:, :k_orig]
		return out[:, 0] if single else out

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		if self.ell_data is not None:
			out = ell_apply(self.ell_data, self.ell_idx, V)
			if self.tail is not None:
				t_data, t_cols, t_rows = self.tail
				out = out + jax.ops.segment_sum(
					t_data[:, None] * V[t_cols, :], t_rows, num_segments=self.shape[0], indices_are_sorted=True
				)
			return out
		if self.sell is not None:
			return self._sell_apply(V)
		prod = self.data[:, None] * V[self.indices, :]
		return jax.ops.segment_sum(prod, self.rowids, num_segments=self.shape[0], indices_are_sorted=True)

	def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
		if self.ell_data is not None:
			out = ell_apply_vec(self.ell_data, self.ell_idx, v)
			if self.tail is not None:
				t_data, t_cols, t_rows = self.tail
				out = out + jax.ops.segment_sum(
					t_data * v[t_cols], t_rows, num_segments=self.shape[0], indices_are_sorted=True
				)
			return out
		if self.sell is not None:
			return self._sell_apply(v)
		prod = self.data * v[self.indices]
		return jax.ops.segment_sum(prod, self.rowids, num_segments=self.shape[0], indices_are_sorted=True)

	def rmatvec(self, v: jnp.ndarray) -> jnp.ndarray:
		# ADJOINT A†v (conj is a no-op for real data). Column ids are NOT sorted
		# within CSR, so the product keeps the scatter path (symmetric operators
		# should just call matvec).
		prod = jnp.conj(self.data) * v[self.rowids]
		return jax.ops.segment_sum(prod, self.indices, num_segments=self.shape[1])

	def todense(self) -> jnp.ndarray:
		return jnp.zeros(self.shape, self.dtype).at[self.rowids, self.indices].add(self.data)

	def tobsr(self, blocksize: Tuple[int, int] = (8, 128)) -> "BSROperator":
		import scipy.sparse as sps

		A = sps.csr_matrix(
			(np.asarray(self.data), np.asarray(self.indices), np.asarray(self.indptr)), shape=self.shape
		)
		return BSROperator.from_scipy(A, blocksize=blocksize)

	def tree_flatten(self):
		children = (self.data, self.indices, self.indptr, self.rowids)
		if self.ell_data is not None:
			children += (self.ell_data, self.ell_idx)
		if self.tail is not None:
			children += self.tail
		if self.sell is not None:
			rank, s_data, s_idx, s_tail, n_hub = self.sell
			children += (rank,) + tuple(s_data) + tuple(s_idx)
			if s_tail is not None:
				children += s_tail
			sell_aux = (len(s_data), s_tail is not None, n_hub)
		else:
			sell_aux = None
		return children, (self.shape, self.dtype, self.ell_data is not None, self.tail is not None, sell_aux)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		shape, dtype, has_ell, has_tail, sell_aux = aux
		obj.data, obj.indices, obj.indptr, obj.rowids = children[:4]
		at = 4
		obj.ell_data, obj.ell_idx = (children[4], children[5]) if has_ell else (None, None)
		at += 2 if has_ell else 0
		obj.tail = tuple(children[at : at + 3]) if has_tail else None
		at += 3 if has_tail else 0
		if sell_aux is not None:
			n_slots, sell_has_tail, n_hub = sell_aux
			rank = children[at]
			at += 1
			s_data = tuple(children[at : at + n_slots])
			at += n_slots
			s_idx = tuple(children[at : at + n_slots])
			at += n_slots
			s_tail = tuple(children[at : at + 3]) if sell_has_tail else None
			obj.sell = (rank, s_data, s_idx, s_tail, n_hub)
		else:
			obj.sell = None
		obj.shape, obj.dtype = shape, dtype
		return obj


@jax.tree_util.register_pytree_node_class
class BSROperator(LinearOperator):
	"""Block-sparse-row operator: nonzeros stored as dense (bm × bn) tiles.

	Each stored block contracts against the probe block as a small batched
	matmul. ``matmat`` is scatter-free block-ELL (gather + per-slot block
	einsum) when the block rows are even enough, gather + einsum +
	``segment_sum`` otherwise.
	"""

	BELL_MAX_BYTES = 256 * 1024 * 1024  # auto block-ELL build cap (duplicated tile storage)
	BELL_FLAT_MAX_BYTES = 2 * 1024 * 1024 * 1024  # flat-apply intermediate cap (transient)

	def __init__(
		self,
		blocks: jnp.ndarray,  # (nnzb, bm, bn)
		indices: jnp.ndarray,  # (nnzb,) block-column ids
		indptr: jnp.ndarray,  # (n_brow + 1,)
		shape: Tuple[int, int],
		rowids: Optional[jnp.ndarray] = None,
		bell: Optional[bool] = None,
	):
		self.blocks = jnp.asarray(blocks)
		self.indices = jnp.asarray(indices, jnp.int32)
		self.indptr = jnp.asarray(indptr, jnp.int32)
		self.shape = tuple(shape)  # LOGICAL shape; the block grid may overhang
		self.dtype = self.blocks.dtype
		traced = any(isinstance(x, jax.core.Tracer) for x in (self.blocks, self.indices, self.indptr))
		if rowids is None:
			counts = np.diff(np.asarray(self.indptr))
			rowids = np.repeat(np.arange(len(counts)), counts)
		self.rowids = jnp.asarray(rowids, jnp.int32)
		# Block-ELL planes (the tile-granularity analog of the CSR ELL path):
		# when padding block rows to the max block count Lb stays under
		# ELL_MAX_FILL× the stored tiles, SpMM drops the segment_sum scatter for
		# a slot-unrolled gather + per-slot block einsum. The planes DUPLICATE
		# the tile storage (`blocks` stays — rmatmat/todense need it), so the
		# auto build additionally caps the extra bytes; ``bell=True`` forces
		# the build past the caps, ``bell=False`` disables it.
		self.bell_blocks = self.bell_idx = None
		if not traced and bell is not False:
			counts = np.diff(np.asarray(self.indptr))
			nnzb = int(self.blocks.shape[0])
			Lb = int(counts.max()) if counts.size else 0
			fits = counts.size * Lb <= CSROperator.ELL_MAX_FILL * max(nnzb, 1)
			if bell is None:
				bell_bytes = int(counts.size) * Lb * int(np.prod(self.blocks.shape[1:])) * self.blocks.dtype.itemsize
				fits = fits and bell_bytes <= self.BELL_MAX_BYTES
			# No Lb cap: past the slot-unroll bound the apply switches to the
			# flat one-gather form (see _matmat_jnp), which handles any Lb.
			if 0 < Lb and (fits or bell is True):
				slot = np.arange(Lb)[None, :]
				pos = np.asarray(self.indptr)[:-1, None] + slot
				mask = slot < counts[:, None]
				pos = np.minimum(pos, max(nnzb - 1, 0))
				self.bell_idx = jnp.asarray(np.where(mask, np.asarray(self.indices)[pos], 0), jnp.int32)
				bb = np.asarray(self.blocks)[pos]  # (n_brow, Lb, bm, bn)
				bb[~mask] = 0.0
				self.bell_blocks = jnp.asarray(bb, self.dtype)

	@property
	def pshape(self) -> Tuple[int, int]:
		"""Padded shape: the block grid rounded up to whole (bm × bn) tiles.

		Blocksizes rarely divide the logical n; padding rows/cols are zero so matvecs are unaffected — ``matmat`` pads
		the probe block in and slices the product back out.
		"""
		bm, bn = self.blocks.shape[1:]
		return (-(-self.shape[0] // bm) * bm, -(-self.shape[1] // bn) * bn)

	@property
	def blocksize(self) -> Tuple[int, int]:
		return tuple(self.blocks.shape[1:])

	@property
	def nnz(self) -> int:
		return int(np.prod(self.blocks.shape))

	@classmethod
	def from_scipy(cls, A, blocksize: Optional[Tuple[int, int]] = None, dtype=None, engine: str = "auto") -> "BSROperator":
		import scipy.sparse as sps

		if not sps.issparse(A):
			A = sps.csr_matrix(np.asarray(A))
		shape = A.shape
		if blocksize is not None and engine in ("auto", "native"):
			# Native single-pass CSR→BSR (padded grid + coverage, no scipy
			# resize/tobsr copies); silently falls back when not compiled.
			from ..native import csr_to_bsr_arrays

			parts = csr_to_bsr_arrays(A, *blocksize)
			if parts is not None:
				blocks, colids, indptr_b = parts
				op = cls(jnp.asarray(blocks, dtype=dtype), colids, indptr_b, shape)
				op._warn_fill_in(int(A.nnz))
				return op
			if engine == "native":
				raise RuntimeError("native sparse-prep library unavailable (no C++ toolchain?)")
		nnz_logical = int(A.nnz)  # BEFORE tobsr: BSR .nnz counts stored block entries
		if blocksize is not None:
			# Zero-pad the matrix to whole tiles so any blocksize works for
			# any n; the logical shape is kept.
			bm, bn = blocksize
			padded = (-(-shape[0] // bm) * bm, -(-shape[1] // bn) * bn)
			if padded != shape:
				A = sps.csr_matrix(A)
				A.resize(padded)
		A = A.tobsr(blocksize=blocksize) if blocksize is not None else A.tobsr()
		data, indices, indptr = _pad_empty_block_rows(np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr))
		op = cls(jnp.asarray(data, dtype=dtype), indices, indptr, shape)
		op._warn_fill_in(nnz_logical)
		return op

	def _warn_fill_in(self, nnz_logical: int) -> None:
		"""Warn when the tile grid stores mostly zeros — a scattered sparsity
		pattern lights up nearly every (bm × bn) tile, inflating storage and
		matmat traffic by up to bm·bn× vs CSR. BSR is for genuinely
		block-structured operators; use CSR/COO (or DIA for banded) otherwise."""
		stored = self.nnz
		if nnz_logical > 0 and stored > 8 * nnz_logical:
			import warnings

			warnings.warn(
				f"BSROperator tiles are {stored / nnz_logical:.0f}x the logical nnz "
				f"({stored} stored vs {nnz_logical}); the sparsity pattern is not "
				f"block-structured at blocksize {self.blocksize} — CSR/COO (or DIA "
				"for banded matrices) will be faster.",
				stacklevel=3,
			)

	@classmethod
	def from_dense(cls, A, blocksize: Tuple[int, int] = (8, 128)) -> "BSROperator":
		return cls.from_scipy(np.asarray(A), blocksize=blocksize)

	def _matmat_jnp(self, V: jnp.ndarray) -> jnp.ndarray:
		bm, bn = self.blocksize
		k = V.shape[1]
		np_r, np_c = self.pshape
		if V.shape[0] != np_c:
			V = jnp.pad(V, ((0, np_c - V.shape[0]), (0, 0)))
		Vb = V.reshape(-1, bn, k)  # (n_bcol, bn, k)
		acc = jnp.promote_types(self.dtype, jnp.float32)
		# precision=HIGHEST: an f32 contraction at the default precision may
		# run in a reduced-precision format (TF32 on the GPU); these tiny block
		# contractions are gather-bound, so exact f32 passes cost little.
		if self.bell_blocks is not None:
			n_brow, Lb = self.bell_idx.shape
			if Lb <= _ELL_UNROLL_MAX:
				# Slot-unrolled block-ELL: per slot one block-row gather + one
				# batched (bm × bn)·(bn × k) einsum, accumulated — no segment_sum
				# scatter, no big intermediate (see ell_apply for the measured why).
				Y = None
				for l in range(Lb):
					t = jnp.einsum(
						"rij,rjk->rik", self.bell_blocks[:, l], Vb[self.bell_idx[:, l]],
						preferred_element_type=acc, precision=jax.lax.Precision.HIGHEST,
					)
					Y = t if Y is None else Y + t
				return Y.reshape(np_r, k)[: self.shape[0]].astype(self.dtype)
			if n_brow * Lb * bm * k * 4 <= self.BELL_FLAT_MAX_BYTES:
				# FLAT block-ELL for many-block rows: one gather over all padded
				# slots + reshape-sum over the slot axis — scatter-free. Slot-by-
				# slot gathers are the wrong shape here: Lb tiny (n_brow,)-sized
				# gathers pay per-op overhead the single flat gather amortizes.
				idx = self.bell_idx.reshape(-1)
				blocks = self.bell_blocks.reshape(-1, bm, bn)
				prod = jnp.einsum(
					"zij,zjk->zik", blocks, Vb[idx], preferred_element_type=acc, precision=jax.lax.Precision.HIGHEST
				)
				Y = prod.reshape(n_brow, Lb, bm, k).sum(1)
				return Y.reshape(np_r, k)[: self.shape[0]].astype(self.dtype)
		gathered = Vb[self.indices]  # (nnzb, bn, k)
		prod = jnp.einsum("zij,zjk->zik", self.blocks, gathered, preferred_element_type=acc, precision=jax.lax.Precision.HIGHEST)
		n_brow = self.indptr.shape[0] - 1
		Y = jax.ops.segment_sum(prod, self.rowids, num_segments=n_brow)
		return Y.reshape(np_r, k)[: self.shape[0]].astype(self.dtype)

	def rmatmat(self, V: jnp.ndarray) -> jnp.ndarray:
		"""Adjoint block apply ``A† V`` — every other sparse format overrides
		this; the symmetric base fallback would silently return ``A V`` (and
		shape-error on rectangular block grids)."""
		bm, bn = self.blocksize
		V = jnp.asarray(V)
		single = V.ndim == 1
		if single:
			V = V[:, None]
		k = V.shape[1]
		np_r, np_c = self.pshape
		if V.shape[0] != np_r:
			V = jnp.pad(V, ((0, np_r - V.shape[0]), (0, 0)))
		Vb = V.reshape(-1, bm, k)  # (n_brow, bm, k)
		gathered = Vb[self.rowids]  # (nnzb, bm, k)
		acc = jnp.promote_types(self.dtype, jnp.float32)
		prod = jnp.einsum("zij,zik->zjk", jnp.conj(self.blocks), gathered, preferred_element_type=acc, precision=jax.lax.Precision.HIGHEST)
		n_bcol = np_c // bn
		Y = jax.ops.segment_sum(prod, self.indices, num_segments=n_bcol)
		out = Y.reshape(np_c, k)[: self.shape[1]].astype(self.dtype)
		return out[:, 0] if single else out

	def rmatvec(self, v: jnp.ndarray) -> jnp.ndarray:
		return self.rmatmat(v)

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		return self._matmat_jnp(V)

	def todense(self) -> jnp.ndarray:
		bm, bn = self.blocksize
		np_r, np_c = self.pshape
		out = jnp.zeros((np_r // bm, np_c // bn, bm, bn), self.dtype)
		out = out.at[self.rowids, self.indices].add(self.blocks)
		return out.transpose(0, 2, 1, 3).reshape(np_r, np_c)[: self.shape[0], : self.shape[1]]

	def tree_flatten(self):
		children = (self.blocks, self.indices, self.indptr, self.rowids)
		if self.bell_blocks is not None:
			children += (self.bell_blocks, self.bell_idx)
		return children, (self.shape, self.dtype, self.bell_blocks is not None)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.blocks, obj.indices, obj.indptr, obj.rowids = children[:4]
		obj.shape, obj.dtype, has_bell = aux
		obj.bell_blocks, obj.bell_idx = (children[4], children[5]) if has_bell else (None, None)
		return obj


@jax.tree_util.register_pytree_node_class
class DIAOperator(LinearOperator):
	"""Diagonal/banded (DIA) operator: the speed-of-light format for stencils.

	Graph/mesh Laplacians (the reference's flagship sparse workloads) are
	banded after natural or RCM ordering; storing them as dense BSR tiles
	inflates memory ~bm·bn/band-fold. DIA stores one length-n vector per
	nonzero diagonal and the matvec is a pure elementwise shift-multiply-add
	with **zero gathers**, bounded only by streaming V through device memory.

	Convention (row-aligned): ``band[k][i] = A[i, i + offsets[k]]``, so
	``out[i] += band[k][i] · v[i + offsets[k]]``. Offsets are static aux data,
	making every slice static under jit.
	"""

	def __init__(self, bands: jnp.ndarray, offsets: Tuple[int, ...], shape: Tuple[int, int]):
		self.bands = jnp.asarray(bands)  # (n_diags, n)
		self.offsets = tuple(int(o) for o in offsets)
		self.shape = tuple(shape)
		self.dtype = self.bands.dtype

	@classmethod
	def from_scipy(cls, A, dtype=None, engine: str = "auto") -> "DIAOperator":
		if engine in ("auto", "native"):
			from ..native import csr_to_dia_arrays

			parts = csr_to_dia_arrays(A)
			if parts is not None:
				offsets, bands = parts
				return cls(jnp.asarray(bands, dtype=dtype), offsets, A.shape)
			if engine == "native":
				raise RuntimeError("native sparse-prep library unavailable (no C++ toolchain?)")
		A = A.todia()
		n = A.shape[0]
		offsets = tuple(int(o) for o in A.offsets)
		# scipy stores column-aligned (data[k][j] = A[j-off, j]); shift to
		# row-aligned and zero the out-of-range tail of each band.
		bands = np.zeros((len(offsets), n), A.data.dtype)
		for k, off in enumerate(offsets):
			src = A.data[k]
			if off >= 0:
				m = n - off
				bands[k, :m] = src[off : off + m]
			else:
				m = n + off
				bands[k, -off : -off + m] = src[:m]
		return cls(jnp.asarray(bands, dtype=dtype), offsets, A.shape)

	@classmethod
	def from_dense(cls, A, tol: float = 0.0) -> "DIAOperator":
		import scipy.sparse as sps

		return cls.from_scipy(sps.dia_matrix(np.asarray(A)))

	@property
	def nnz(self) -> int:
		return int(np.prod(self.bands.shape))

	def _matmat_jnp(self, V: jnp.ndarray) -> jnp.ndarray:
		n = self.shape[0]
		moff = max((abs(o) for o in self.offsets), default=0)
		Vp = jnp.pad(V, ((moff, moff), (0, 0))) if moff else V
		acc = jnp.promote_types(self.dtype, jnp.float32)
		out = jnp.zeros((n, V.shape[1]), acc)
		for k, off in enumerate(self.offsets):
			out = out + self.bands[k, :, None].astype(acc) * Vp[moff + off : moff + off + n]
		return out.astype(self.dtype)

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		return self._matmat_jnp(V)

	def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
		# True 1-D stencil: no (n, 1) probe block, which matters inside serial
		# single-probe loops (`diag`).
		v = jnp.asarray(v)
		if v.ndim != 1:
			return self._matmat(v)
		n = self.shape[0]
		moff = max((abs(o) for o in self.offsets), default=0)
		vp = jnp.pad(v, (moff, moff)) if moff else v
		acc = jnp.promote_types(self.dtype, jnp.float32)
		out = jnp.zeros(n, acc)
		for k, off in enumerate(self.offsets):
			out = out + self.bands[k].astype(acc) * vp[moff + off : moff + off + n]
		return out.astype(self.dtype)

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		# Probe-major stencil: out[b, i] = Σ_k band_k[i] · Vt[b, i + off_k].
		# Shifts run along the contiguous row axis; bands broadcast over the
		# probe axis — zero gathers. XLA emits the padded shift-multiply-add
		# as one loop fusion, which joins the Lanczos step's axpy and
		# reductions.
		n = self.shape[0]
		moff = max((abs(o) for o in self.offsets), default=0)
		Vp = jnp.pad(Vt, ((0, 0), (moff, moff))) if moff else Vt
		acc = jnp.promote_types(self.dtype, jnp.float32)
		out = jnp.zeros((Vt.shape[0], n), acc)
		for k, off in enumerate(self.offsets):
			out = out + self.bands[k, None, :].astype(acc) * Vp[:, moff + off : moff + off + n]
		return out.astype(self.dtype)

	def rmatvec(self, v: jnp.ndarray) -> jnp.ndarray:
		# ADJOINT A†v: A† has band'_{-d}[i] = conj(band_d[i - d]) (conj a no-op
		# for real data); estimation targets are symmetric so the default is
		# rarely exercised — keep it exact anyway.
		n = self.shape[0]
		moff = max((abs(o) for o in self.offsets), default=0)
		acc = jnp.promote_types(self.dtype, jnp.float32)
		out = jnp.zeros(n + 2 * moff, acc)
		for k, off in enumerate(self.offsets):
			out = out.at[moff + off : moff + off + n].add(jnp.conj(self.bands[k]).astype(acc) * v.astype(acc))
		return out[moff : moff + n].astype(self.dtype)

	def todense(self) -> jnp.ndarray:
		n = self.shape[0]
		out = jnp.zeros(self.shape, self.dtype)
		idx = jnp.arange(n)
		for k, off in enumerate(self.offsets):
			valid = (idx + off >= 0) & (idx + off < n)
			rows = jnp.where(valid, idx, 0)
			cols = jnp.where(valid, idx + off, 0)
			vals = jnp.where(valid, self.bands[k], 0)
			out = out.at[rows, cols].add(vals)
		return out

	def tree_flatten(self):
		return (self.bands,), (self.offsets, self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.bands = children[0]
		obj.offsets, obj.shape, obj.dtype = aux
		return obj


@jax.tree_util.register_pytree_node_class
class GramOperator(LinearOperator):
	"""Gram-mode operator ``AᵀA`` (or ``AAᵀ``) without forming the product.

	Parity: the ``gram`` template flag of the reference's sparse operator
	(`eigen_operators.h:58,69-75`) — spectral sums of rectangular data matrices
	(Schatten norms, effective rank) via two matvecs per application.
	"""

	def __init__(self, A, transpose_first: bool = True):
		from .base import aslinop

		self.A = aslinop(A)
		self.transpose_first = transpose_first
		n = self.A.shape[1] if transpose_first else self.A.shape[0]
		self.shape = (n, n)
		self.dtype = self.A.dtype

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		if self.transpose_first:  # AᵀA v
			return _rmatmat(self.A, self.A.matmat(V))
		return self.A.matmat(_rmatmat(self.A, V))

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		# Probe-major Gram apply through the data operator's native (k, ·)
		# primitives: (AᵀA Vtᵀ)ᵀ = rmatmat_t(matmat_t(Vt)) — zero transposes
		# for dense/DIA/sharded data operators.
		if self.transpose_first:
			return self.A.rmatmat_t(self.A.matmat_t(Vt))
		return self.A.matmat_t(self.A.rmatmat_t(Vt))

	def tree_flatten(self):
		return (self.A,), self.transpose_first

	@classmethod
	def tree_unflatten(cls, aux, children):
		return cls(children[0], transpose_first=aux)


def _pad_empty_block_rows(data: np.ndarray, indices: np.ndarray, indptr: np.ndarray):
	"""Insert one explicit zero block into each empty block-row (host-side).

	Every block-row then owns at least one stored block, so block-ELL planes
	and the sharded partitioner see full row coverage at negligible cost.
	"""
	counts = np.diff(indptr)
	empty = np.flatnonzero(counts == 0)
	if empty.size == 0:
		return data, indices, indptr
	n_brow = len(counts)
	bm, bn = data.shape[1:]
	new_counts = np.where(counts == 0, 1, counts)
	new_indptr = np.zeros(n_brow + 1, indptr.dtype)
	np.cumsum(new_counts, out=new_indptr[1:])
	new_data = np.zeros((new_indptr[-1], bm, bn), data.dtype)
	new_indices = np.zeros(new_indptr[-1], indices.dtype)
	# Scatter existing blocks into their (shifted) positions.
	old_pos = np.arange(data.shape[0])
	rowids = np.repeat(np.arange(n_brow), counts)
	dest = new_indptr[rowids] + (old_pos - indptr[rowids])
	new_data[dest] = data
	new_indices[dest] = indices
	return new_data, new_indices, new_indptr


def _rmatmat(op: LinearOperator, V: jnp.ndarray) -> jnp.ndarray:
	"""Apply the adjoint to a block — delegates to the operator's ``rmatmat``
	(native GEMM for dense, vmapped-rmatvec fallback on the base class)."""
	return op.rmatmat(V)


# Plain (N,)-valued applies: declare the empty stack statically so estimator
# wrappers (hutch/diag) skip their per-call `jax.eval_shape` probe — re-tracing
# the slot-unrolled ELL apply costs ~100 ms of host time per call.
for _cls in (COOOperator, CSROperator, BSROperator, DIAOperator, GramOperator):
	_cls.stack_shape = ()
del _cls
