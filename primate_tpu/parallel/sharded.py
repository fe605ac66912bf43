"""Row/block-partitioned operators over a device mesh.

The distributed analog of the reference's single-address-space Eigen matvec
(``src/primate/include/eigen_operators.h:17-137``) — here each matvec is a
local SpMM on every device plus a collective for the vector segments
(SURVEY §5.7-5.8, BASELINE.json north star).

Two communication schemes for sparse operators:

  * ``comm="allgather"`` — probes stay replicated; each chip multiplies its
    row block against the full probe block. General (any sparsity pattern);
    one all-gather of the output rows per matvec, inserted by the out-spec.
  * ``comm="halo"`` — probes are row-sharded like the operator; each chip
    exchanges only its neighbor segments via two ring `ppermute`s (the
    ring-attention analog) and contracts against the 3-segment extended
    block. Valid when every stored block's column falls within the owning
    chip's ±1 neighbor range — the usual case for banded/mesh Laplacians
    after bandwidth-reducing (RCM) ordering. Falls back to all-gather when
    the pattern is wider (``comm="auto"``).

Dense operators need no explicit collectives at all: the array is laid out
with a `NamedSharding` and XLA's SPMD partitioner inserts the optimal
collective schedule for ``A @ V`` (the idiomatic JAX path).

All sharded operators are pytrees, so the fused estimator programs (`hutch`,
`diag`, `MatrixFunction.quad`, ...) run on them unchanged — the adaptive
`lax.while_loop` stays on-device and its convergence reductions become
cross-chip `psum`s automatically.
"""

from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..operators.base import LinearOperator, aslinop
from ..operators.sparse import BSROperator, CSROperator, DIAOperator

__all__ = ["ShardedCSROperator", "ShardedDenseOperator", "ShardedBSROperator", "ShardedDIAOperator", "shard_operator"]


@jax.tree_util.register_pytree_node_class
class ShardedDenseOperator(LinearOperator):
	"""Dense operator laid out row-sharded on a mesh; GSPMD handles the rest.

	The matvec is a plain ``A @ V`` — with ``A`` sharded ``P(op, None)`` and
	``V`` replicated, XLA partitions the GEMM so each chip computes its row
	block locally and the row-sharded product flows downstream
	without any host involvement.
	"""

	def __init__(self, A: jnp.ndarray, mesh: Mesh, op_axis: str = "op", _pre_sharded: bool = False, dtype=None, _logical_shape=None):
		self.mesh = mesh
		self.op_axis = op_axis
		if not _pre_sharded:
			A = jnp.asarray(A, dtype=dtype)
			self._logical = tuple(A.shape)
			ndev = mesh.shape[op_axis]
			pad = (-A.shape[0]) % ndev
			if pad:  # the GSPMD layout needs a device-divisible row count
				A = jnp.pad(A, ((0, pad), (0, 0)))
			A = jax.device_put(A, NamedSharding(mesh, P(op_axis, None)))
		else:
			self._logical = tuple(_logical_shape if _logical_shape is not None else A.shape)
		self.A = A
		self.shape = self._logical
		self.dtype = A.dtype

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		if self.A.shape[1] != V.shape[0]:  # padded rows: pad inputs, slice outputs
			V = jnp.pad(V, ((0, self.A.shape[1] - V.shape[0]), (0, 0)))
		return (self.A @ V)[: self.shape[0]]

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		if self.A.shape[1] != Vt.shape[1]:
			Vt = jnp.pad(Vt, ((0, 0), (0, self.A.shape[1] - Vt.shape[1])))
		return (Vt @ self.A.T)[:, : self.shape[0]]  # GSPMD partitions the same GEMM

	def rmatvec(self, v: jnp.ndarray) -> jnp.ndarray:
		if self.A.shape[0] != v.shape[0]:
			v = jnp.pad(v, (0, self.A.shape[0] - v.shape[0]))
		return (jnp.conj(self.A).T @ v)[: self.shape[1]]  # adjoint A† (conj no-op for real A)

	def todense(self) -> jnp.ndarray:
		return self.A[: self.shape[0], : self.shape[1]]

	def tree_flatten(self):
		return (self.A,), (self.mesh, self.op_axis, self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.A = children[0]
		obj.mesh, obj.op_axis, obj.shape, obj.dtype = aux
		obj._logical = obj.shape
		return obj


def _partition_bsr_host(
	blocks: np.ndarray,
	indices: np.ndarray,
	indptr: np.ndarray,
	ndev: int,
	halo_col: bool,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, bool]:
	"""Split BSR block-rows into ``ndev`` equal contiguous chunks (host-side).

	Returns stacked per-device arrays ``(ndev, nnzb_max, ...)`` with every
	local block-row covered by at least one (possibly zero) block, rows padded
	to ``bpd = ceil(n_brow / ndev)`` per device, and a flag telling whether the
	pattern satisfies the ±1-neighbor halo condition.
	"""
	n_brow = len(indptr) - 1
	counts = np.diff(indptr)
	rowids = np.repeat(np.arange(n_brow), counts)
	bpd = -(-n_brow // ndev)
	bm, bn = blocks.shape[1:]
	n_brow_pad = bpd * ndev

	halo_ok = True
	bwb = 0  # block bandwidth max|bcol − brow| over structural blocks
	dev_blocks, dev_rowids, dev_colids = [], [], []
	for d in range(ndev):
		lo, hi = d * bpd, (d + 1) * bpd
		sel = (rowids >= lo) & (rowids < hi)
		rb, cb, bl = rowids[sel] - lo, indices[sel], blocks[sel]
		if halo_col and cb.size:
			# Only STRUCTURAL blocks count: BSR conversions insert explicit
			# zero blocks (e.g. at block-col 0 for empty block-rows), which
			# would otherwise falsely disqualify a banded matrix from halo.
			nz = np.abs(bl).reshape(bl.shape[0], -1).max(axis=1) > 0
			cnz = cb[nz]
			halo_ok &= bool(np.all((cnz >= (d - 1) * bpd) & (cnz < (d + 2) * bpd))) if cnz.size else True
			if cnz.size:
				bwb = max(bwb, int(np.abs(cnz - (rb[nz] + lo)).max()))
			# Structurally-zero stored blocks may carry arbitrary (out-of-band)
			# colids; the halo window remap in `from_bsr` could push those
			# outside [0, bpd + 2·halo), where the gather would clamp. Point
			# them at the in-window pad column instead — the block value is
			# zero, so the product is too.
			pad_col = min(lo, n_brow_pad - 1)
			cb = np.where(nz, cb, pad_col).astype(cb.dtype)
		# Cover every local row (incl. rows past n_brow on the last device).
		missing = np.setdiff1d(np.arange(bpd), rb)
		if missing.size:
			pad_col = min(d * bpd, n_brow_pad - 1) if halo_col else 0
			rb = np.concatenate([rb, missing])
			cb = np.concatenate([cb, np.full(missing.size, pad_col, cb.dtype if cb.size else np.int32)])
			bl = np.concatenate([bl, np.zeros((missing.size, bm, bn), blocks.dtype)])
			order = np.argsort(rb, kind="stable")
			rb, cb, bl = rb[order], cb[order], bl[order]
		dev_blocks.append(bl)
		dev_rowids.append(rb)
		dev_colids.append(cb)

	nnzb_max = max(b.shape[0] for b in dev_blocks)
	for d in range(ndev):
		pad = nnzb_max - dev_blocks[d].shape[0]
		if pad:
			pad_col = min(d * bpd, n_brow_pad - 1) if halo_col else 0
			dev_blocks[d] = np.concatenate([dev_blocks[d], np.zeros((pad, bm, bn), blocks.dtype)])
			dev_rowids[d] = np.concatenate([dev_rowids[d], np.full(pad, bpd - 1, np.int32)])
			dev_colids[d] = np.concatenate([dev_colids[d], np.full(pad, pad_col, np.int32)])

	return (
		np.stack(dev_blocks).astype(blocks.dtype),
		np.stack(dev_rowids).astype(np.int32),
		np.stack(dev_colids).astype(np.int32),
		bpd,
		halo_ok,
		bwb,
	)


def _probe_axis_or_none(mesh, pr_ax, k: int):
	"""Probe-axis name if usable for this column count, else None.

	Estimators issue applies with arbitrary column counts (a single matvec,
	an eigsh residual block, a ragged final batch); a count not divisible by
	the probe-axis size cannot be probe-sharded — run those replicated
	instead of erroring inside shard_map.
	"""
	if pr_ax is None:
		return None
	npr = mesh.shape.get(pr_ax, 1)
	return pr_ax if npr > 1 and k % npr == 0 else None


def _local_bsr_mm(blocks, rowids, colids, V, *, n_brow_loc: int):
	"""Per-device SpMM of the local row block against a gatherable V segment."""
	bm, bn = blocks.shape[1:]
	k = V.shape[1]
	acc = jnp.promote_types(blocks.dtype, jnp.float32)
	Vb = V.reshape(-1, bn, k)
	# precision=HIGHEST: the default f32 precision may be TF32 on the GPU (see
	# operators/sparse.py) — gather-bound block contractions stay exact f32.
	prod = jnp.einsum("zij,zjk->zik", blocks, Vb[colids], preferred_element_type=acc, precision=jax.lax.Precision.HIGHEST)
	Y = jax.ops.segment_sum(prod, rowids, num_segments=n_brow_loc)
	return Y.reshape(n_brow_loc * bm, k).astype(blocks.dtype)


@jax.tree_util.register_pytree_node_class
class ShardedBSROperator(LinearOperator):
	"""Block-sparse operator row-partitioned across the ``op`` mesh axis.

	Storage: per-device block lists stacked along a leading device axis and
	laid out with ``P(op)``, so each device holds exactly its contiguous band of
	block-rows. ``matmat`` is a `shard_map`: local SpMM + the
	communication scheme chosen at partition time (see module docstring).
	"""

	def __init__(
		self,
		blocks: jnp.ndarray,  # (ndev, nnzb_max, bm, bn)
		rowids: jnp.ndarray,  # (ndev, nnzb_max) local block-row ids
		colids: jnp.ndarray,  # (ndev, nnzb_max) global (allgather) / halo-window cols
		shape: Tuple[int, int],
		mesh: Mesh,
		op_axis: str = "op",
		probe_axis: Optional[str] = None,
		comm: str = "allgather",
		bpd: int = 0,
		halo: int = 0,
	):
		self.blocks, self.rowids, self.colids = blocks, rowids, colids
		self.shape = tuple(shape)
		self.dtype = blocks.dtype
		self.mesh = mesh
		self.op_axis = op_axis
		self.probe_axis = probe_axis
		self.comm = comm
		self.bpd = int(bpd)
		self.halo = int(halo)  # BLOCK-rows exchanged per ring neighbor (halo mode)

	# -- construction -----------------------------------------------------
	@classmethod
	def from_bsr(
		cls,
		A,
		mesh: Mesh,
		op_axis: str = "op",
		probe_axis: Optional[str] = None,
		comm: str = "auto",
		blocksize: Optional[Tuple[int, int]] = None,
		dtype=None,
	) -> "ShardedBSROperator":
		"""Partition a BSR operator / scipy sparse matrix across ``mesh[op_axis]``."""
		if not isinstance(A, BSROperator):
			A = BSROperator.from_scipy(A, blocksize=blocksize, dtype=dtype)
		blocks = np.asarray(A.blocks)
		indices = np.asarray(A.indices)
		indptr = np.asarray(A.indptr)
		bm, bn = blocks.shape[1:]
		ndev = mesh.shape[op_axis]

		if comm == "halo" and (bm != bn or A.shape[0] != A.shape[1]):
			raise ValueError("comm='halo' requires a square operator with square (bm == bn) blocks.")
		want_halo = comm in ("auto", "halo") and bm == bn and A.shape[0] == A.shape[1]
		st_blocks, st_rowids, st_colids, bpd, halo_ok, bwb = _partition_bsr_host(
			blocks, indices, indptr, ndev, halo_col=want_halo
		)
		halo = 0
		if want_halo and halo_ok:
			mode = "halo"
			# MINIMAL halo: ship only block-bandwidth-many boundary block-rows
			# per ring neighbor (the DIA/CSR scheme) — O(bw·bm·k) traffic
			# independent of n; falls back to full segments when the band is
			# wider than one chip's block-rows. Remap global block-cols into
			# the [lo − h, hi + h) window: local col = global − (d·bpd − h).
			halo = int(min(max(bwb, 1), bpd))
			shift = (np.arange(ndev)[:, None]) * bpd - halo
			st_colids = (st_colids - shift).astype(np.int32)
			# Backstop: every remapped colid must land inside the
			# [0, bpd + 2·halo) gather window (structural
			# blocks by the halo_ok/bandwidth proof, zero blocks by the pad-col
			# rewrite in `_partition_bsr_host`).
			if st_colids.size and (st_colids.min() < 0 or st_colids.max() >= bpd + 2 * halo):
				raise AssertionError(
					f"internal: halo colid outside window [0, {bpd + 2 * halo}) after remap "
					f"(range [{st_colids.min()}, {st_colids.max()}])"
				)
		else:
			if comm == "halo" and not halo_ok:
				raise ValueError(
					"comm='halo' requires every stored block within ±1 neighbor's rows; "
					"reorder the matrix (e.g. RCM) or use comm='allgather'."
				)
			if want_halo:  # auto fell through: re-partition with global cols
				st_blocks, st_rowids, st_colids, bpd, _, _ = _partition_bsr_host(
					blocks, indices, indptr, ndev, halo_col=False
				)
			mode = "allgather"

		spec = NamedSharding(mesh, P(op_axis))
		return cls(
			jax.device_put(jnp.asarray(st_blocks, dtype=dtype), spec),
			jax.device_put(jnp.asarray(st_rowids), spec),
			jax.device_put(jnp.asarray(st_colids), spec),
			A.shape,
			mesh,
			op_axis,
			probe_axis,
			comm=mode,
			bpd=bpd,
			halo=halo,
		)

	# -- apply --------------------------------------------------------------
	@property
	def blocksize(self) -> Tuple[int, int]:
		return tuple(self.blocks.shape[2:])

	@property
	def _n_row_pad(self) -> int:
		return self.bpd * self.mesh.shape[self.op_axis] * self.blocksize[0]

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		n, k = self.shape[0], V.shape[1]
		bm, bn = self.blocksize
		np_c = -(-self.shape[1] // bn) * bn  # column grid padded to whole tiles
		op_ax, pr_ax = self.op_axis, self.probe_axis
		pr = _probe_axis_or_none(self.mesh, pr_ax, V.shape[1])
		local = partial(_local_bsr_mm, n_brow_loc=self.bpd)

		if self.comm == "halo":
			n_pad = self._n_row_pad
			Vp = jnp.pad(V, ((0, n_pad - V.shape[0]), (0, 0))) if V.shape[0] != n_pad else V
			ndev = self.mesh.shape[op_ax]
			fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
			bwd = [(i, (i - 1) % ndev) for i in range(ndev)]

			bm = self.blocksize[0]
			h_rows = (self.halo if self.halo > 0 else self.bpd) * bm  # 0: legacy full-segment pytrees

			def shard_fn(blocks, rowids, colids, Vl):
				blocks, rowids, colids = blocks[0], rowids[0], colids[0]
				# Ring exchange of ONLY the halo block-rows each way — traffic
				# O(halo·bm·k) per neighbor, independent of n; the local
				# contraction overlaps with the transfers in XLA's schedule.
				tail_from_left = lax.ppermute(Vl[-h_rows:], op_ax, fwd)
				head_from_right = lax.ppermute(Vl[:h_rows], op_ax, bwd)
				V_ext = jnp.concatenate([tail_from_left, Vl, head_from_right], axis=0)
				return local(blocks, rowids, colids, V_ext)

			out = jax.shard_map(
				shard_fn,
				mesh=self.mesh,
				in_specs=(P(op_ax), P(op_ax), P(op_ax), P(op_ax, pr)),
				out_specs=P(op_ax, pr),
			)(self.blocks, self.rowids, self.colids, Vp)
			return out[:n]

		def shard_fn(blocks, rowids, colids, Vfull):
			blocks, rowids, colids = blocks[0], rowids[0], colids[0]
			return local(blocks, rowids, colids, Vfull)

		Vp = jnp.pad(V, ((0, np_c - V.shape[0]), (0, 0))) if V.shape[0] != np_c else V
		out = jax.shard_map(
			shard_fn,
			mesh=self.mesh,
			in_specs=(P(op_ax), P(op_ax), P(op_ax), P(None, pr)),
			out_specs=P(op_ax, pr),
		)(self.blocks, self.rowids, self.colids, Vp)
		return out[:n]

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		"""Probe-major apply ``(A Vtᵀ)ᵀ`` on a ``(k, n)`` block — native sharded
		kernels (no per-step transpose/resharding in Lanczos carries)."""
		n = self.shape[0]
		bm, bn = self.blocksize
		op_ax, pr_ax = self.op_axis, self.probe_axis
		pr = _probe_axis_or_none(self.mesh, pr_ax, Vt.shape[0])
		bpd = self.bpd

		def local_t(blocks, rowids, colids, Vt_seg):
			acc = jnp.promote_types(self.dtype, jnp.float32)
			kk = Vt_seg.shape[0]
			Vtb = Vt_seg.reshape(kk, -1, bn)  # (k, n_bcol_seg, bn)
			gathered = Vtb[:, colids]  # (k, nnzb, bn)
			prod = jnp.einsum("zij,kzj->zki", blocks, gathered, preferred_element_type=acc, precision=jax.lax.Precision.HIGHEST)
			Y = jax.ops.segment_sum(prod, rowids, num_segments=bpd)  # (bpd, k, bm)
			return jnp.moveaxis(Y, 1, 0).reshape(kk, bpd * bm).astype(self.dtype)

		if self.comm == "halo":
			n_pad = self._n_row_pad
			Vp = jnp.pad(Vt, ((0, 0), (0, n_pad - Vt.shape[1]))) if Vt.shape[1] != n_pad else Vt
			ndev = self.mesh.shape[op_ax]
			fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
			bwd = [(i, (i - 1) % ndev) for i in range(ndev)]
			h_rows = (self.halo if self.halo > 0 else self.bpd) * bm

			def shard_fn(blocks, rowids, colids, Vl):
				blocks, rowids, colids = blocks[0], rowids[0], colids[0]
				tail_from_left = lax.ppermute(Vl[:, -h_rows:], op_ax, fwd)
				head_from_right = lax.ppermute(Vl[:, :h_rows], op_ax, bwd)
				V_ext = jnp.concatenate([tail_from_left, Vl, head_from_right], axis=1)
				return local_t(blocks, rowids, colids, V_ext)

			out = jax.shard_map(
				shard_fn,
				mesh=self.mesh,
				in_specs=(P(op_ax), P(op_ax), P(op_ax), P(pr, op_ax)),
				out_specs=P(pr, op_ax),
			)(self.blocks, self.rowids, self.colids, Vp)
			return out[:, :n]

		np_c = -(-self.shape[1] // bn) * bn
		Vp = jnp.pad(Vt, ((0, 0), (0, np_c - Vt.shape[1]))) if Vt.shape[1] != np_c else Vt

		def shard_fn(blocks, rowids, colids, Vfull):
			blocks, rowids, colids = blocks[0], rowids[0], colids[0]
			return local_t(blocks, rowids, colids, Vfull)

		out = jax.shard_map(
			shard_fn,
			mesh=self.mesh,
			in_specs=(P(op_ax), P(op_ax), P(op_ax), P(pr, None)),
			out_specs=P(pr, op_ax),
		)(self.blocks, self.rowids, self.colids, Vp)
		return out[:, :n]

	def todense(self) -> np.ndarray:
		"""Host-side reconstruction (tests / small operators only)."""
		blocks = np.asarray(self.blocks)
		rowids = np.asarray(self.rowids)
		colids = np.asarray(self.colids)
		ndev, _, bm, bn = blocks.shape
		n_pad = self._n_row_pad
		out = np.zeros((n_pad, n_pad + (2 * self.bpd * bm if self.comm == "halo" else 0)))
		for d in range(ndev):
			for b in range(blocks.shape[1]):
				r = d * self.bpd + rowids[d, b]
				h = self.halo if self.halo > 0 else self.bpd
				c = colids[d, b] + ((d * self.bpd - h) if self.comm == "halo" else 0)
				if 0 <= c * bn and (c + 1) * bn <= out.shape[1]:
					out[r * bm : (r + 1) * bm, c * bn : (c + 1) * bn] += blocks[d, b]
		return out[: self.shape[0], : self.shape[1]]

	def tree_flatten(self):
		children = (self.blocks, self.rowids, self.colids)
		aux = (self.shape, self.dtype, self.mesh, self.op_axis, self.probe_axis, self.comm, self.bpd, self.halo)
		return children, aux

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.blocks, obj.rowids, obj.colids = children
		obj.shape, obj.dtype, obj.mesh, obj.op_axis, obj.probe_axis, obj.comm, obj.bpd, obj.halo = aux
		return obj


@jax.tree_util.register_pytree_node_class
class ShardedDIAOperator(LinearOperator):
	"""Banded (DIA) operator row-partitioned with minimal halo exchange.

	The cleanest distributed SpMV: bands are row-sharded, probes are
	row-sharded, and each matvec exchanges only ``moff = max|offset|`` boundary
	rows with each ring neighbor via `ppermute` — traffic O(moff·k) per device
	regardless of n, overlapped with the local stencil by XLA's scheduler.
	Requires ``moff ≤ rows-per-chip`` (±1-neighbor halo).
	"""

	def __init__(
		self,
		bands: jnp.ndarray,  # (n_d, n_pad) row-aligned, row axis sharded P(op)
		offsets: Tuple[int, ...],
		shape: Tuple[int, int],
		mesh: Mesh,
		op_axis: str = "op",
		probe_axis: Optional[str] = None,
	):
		self.bands = bands
		self.offsets = tuple(int(o) for o in offsets)
		self.shape = tuple(shape)
		self.dtype = bands.dtype
		self.mesh = mesh
		self.op_axis = op_axis
		self.probe_axis = probe_axis

	@classmethod
	def from_dia(
		cls,
		A,
		mesh: Mesh,
		op_axis: str = "op",
		probe_axis: Optional[str] = None,
		dtype=None,
	) -> "ShardedDIAOperator":
		if not isinstance(A, DIAOperator):
			A = DIAOperator.from_scipy(A, dtype=dtype)
		n = A.shape[0]
		ndev = mesh.shape[op_axis]
		n_loc = -(-n // ndev)
		n_pad = n_loc * ndev
		moff = max((abs(o) for o in A.offsets), default=0)
		if moff > n_loc:
			raise ValueError(
				f"halo width {moff} exceeds rows-per-chip {n_loc}; use fewer chips or reorder (RCM) to shrink the band."
			)
		bands = jnp.pad(A.bands, ((0, 0), (0, n_pad - n))) if n_pad != n else A.bands
		bands = jax.device_put(jnp.asarray(bands, dtype=dtype), NamedSharding(mesh, P(None, op_axis)))
		return cls(bands, A.offsets, A.shape, mesh, op_axis, probe_axis)

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		n = self.shape[0]
		ndev = self.mesh.shape[self.op_axis]
		n_pad = self.bands.shape[1]
		n_loc = n_pad // ndev
		moff = max((abs(o) for o in self.offsets), default=0)
		op_ax, pr_ax = self.op_axis, self.probe_axis
		pr = _probe_axis_or_none(self.mesh, pr_ax, V.shape[1])
		offsets = self.offsets
		fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
		bwd = [(i, (i - 1) % ndev) for i in range(ndev)]

		def shard_fn(bands_loc, Vl):
			acc = jnp.promote_types(bands_loc.dtype, jnp.float32)
			if moff:
				# Exchange only the boundary rows: tail→right, head→left.
				tail_from_left = lax.ppermute(Vl[-moff:], op_ax, fwd)
				head_from_right = lax.ppermute(Vl[:moff], op_ax, bwd)
				V_ext = jnp.concatenate([tail_from_left, Vl, head_from_right], axis=0)
			else:
				V_ext = Vl
			out = jnp.zeros((n_loc, Vl.shape[1]), acc)
			for d, off in enumerate(offsets):
				out = out + bands_loc[d, :, None].astype(acc) * V_ext[moff + off : moff + off + n_loc]
			return out.astype(bands_loc.dtype)

		Vp = jnp.pad(V, ((0, n_pad - V.shape[0]), (0, 0))) if V.shape[0] != n_pad else V
		out = jax.shard_map(
			shard_fn,
			mesh=self.mesh,
			in_specs=(P(None, op_ax), P(op_ax, pr)),
			out_specs=P(op_ax, pr),
		)(self.bands, Vp)
		return out[:n]

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		# Probe-major sharded stencil: Vt (k, n) with the row axis sharded on
		# axis 1. Same minimal halo (O(moff·k) per ring neighbor), shifts along
		# the contiguous row axis — the layout the Lanczos sweep carries, so
		# no per-step transposes on the distributed path either.
		n = self.shape[0]
		ndev = self.mesh.shape[self.op_axis]
		n_pad = self.bands.shape[1]
		n_loc = n_pad // ndev
		moff = max((abs(o) for o in self.offsets), default=0)
		op_ax, pr_ax = self.op_axis, self.probe_axis
		pr = _probe_axis_or_none(self.mesh, pr_ax, Vt.shape[0])
		offsets = self.offsets
		fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
		bwd = [(i, (i - 1) % ndev) for i in range(ndev)]

		def shard_fn(bands_loc, Vl):
			acc = jnp.promote_types(bands_loc.dtype, jnp.float32)
			if moff:
				tail_from_left = lax.ppermute(Vl[:, -moff:], op_ax, fwd)
				head_from_right = lax.ppermute(Vl[:, :moff], op_ax, bwd)
				V_ext = jnp.concatenate([tail_from_left, Vl, head_from_right], axis=1)
			else:
				V_ext = Vl
			out = jnp.zeros((Vl.shape[0], n_loc), acc)
			for d, off in enumerate(offsets):
				out = out + bands_loc[d, None, :].astype(acc) * V_ext[:, moff + off : moff + off + n_loc]
			return out.astype(bands_loc.dtype)

		Vp = jnp.pad(Vt, ((0, 0), (0, n_pad - Vt.shape[1]))) if Vt.shape[1] != n_pad else Vt
		out = jax.shard_map(
			shard_fn,
			mesh=self.mesh,
			in_specs=(P(None, op_ax), P(pr, op_ax)),
			out_specs=P(pr, op_ax),
		)(self.bands, Vp)
		return out[:, :n]

	def todense(self) -> np.ndarray:
		op = DIAOperator(np.asarray(self.bands)[:, : self.shape[0]], self.offsets, self.shape)
		return np.asarray(op.todense())

	def tree_flatten(self):
		return (self.bands,), (self.offsets, self.shape, self.dtype, self.mesh, self.op_axis, self.probe_axis)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.bands = children[0]
		obj.offsets, obj.shape, obj.dtype, obj.mesh, obj.op_axis, obj.probe_axis = aux
		return obj


def _partition_csr_host(
	data: np.ndarray,
	indices: np.ndarray,
	indptr: np.ndarray,
	n_cols: int,
	ndev: int,
	halo_col: bool,
) -> tuple:
	"""Split CSR rows into ``ndev`` equal contiguous chunks (host-side).

	Returns stacked per-device nonzero arrays ``(ndev, nnz_max)`` (padding
	entries carry zero data and scatter to the last local row), stacked ELL
	planes ``(ndev, rpd, L)`` when padding to the longest LOCAL row stays under
	``CSROperator.ELL_MAX_FILL``× nnz (the same gather-no-scatter fast path the
	single-chip operator uses), the rows-per-device, and whether the pattern
	satisfies the ±1-neighbor halo condition.
	"""
	n = len(indptr) - 1
	counts = np.diff(indptr)
	rpd = -(-n // ndev)
	nnz = int(data.shape[0])
	if nnz and int(indices.max()) >= n_cols:
		raise ValueError(f"CSR column index {int(indices.max())} out of range for {n_cols} columns")

	halo_ok = True
	bw = 0  # bandwidth max|col − row| over stored nonzeros (minimal halo width)
	dev = []
	for d in range(ndev):
		lo, hi = d * rpd, min((d + 1) * rpd, n)
		# Rows are split into CONTIGUOUS chunks, so each device's nonzeros are
		# one indptr slice — no O(nnz) masks or a global rowids array.
		a, b = (int(indptr[lo]), int(indptr[hi])) if lo < n else (nnz, nnz)
		rb = np.repeat(np.arange(lo, hi) - lo, counts[lo:hi]) if lo < n else np.zeros(0, np.int64)
		cb, vb = indices[a:b], data[a:b]
		if halo_col and cb.size:
			halo_ok &= bool(np.all((cb >= (d - 1) * rpd) & (cb < (d + 2) * rpd)))
			bw = max(bw, int(np.abs(cb - (rb + lo)).max()))
		dev.append((rb, cb, vb))

	nnz_max = max(max(r[0].size for r in dev), 1)
	st_rows = np.full((ndev, nnz_max), rpd - 1, np.int32)
	st_cols = np.zeros((ndev, nnz_max), np.int32)
	st_data = np.zeros((ndev, nnz_max), data.dtype)
	for d, (rb, cb, vb) in enumerate(dev):
		st_rows[d, : rb.size] = rb
		st_cols[d, : cb.size] = cb
		st_data[d, : vb.size] = vb
		# Padding scatters zeros onto the last local row — keep the row stream
		# non-decreasing so `indices_are_sorted=True` stays valid.

	# Shared ELL decision: one layout for all chips (stacked arrays must agree).
	L = max((int(np.bincount(r[0], minlength=rpd).max()) if r[0].size else 0) for r in dev)
	ell_data = ell_idx = None
	if L > 0 and ndev * rpd * L <= CSROperator.ELL_MAX_FILL * max(nnz, 1):
		ell_data = np.zeros((ndev, rpd, L), data.dtype)
		ell_idx = np.zeros((ndev, rpd, L), np.int32)
		for d, (rb, cb, vb) in enumerate(dev):
			if not rb.size:
				continue
			# Vectorized slot assignment: rows arrive sorted (CSR order), so
			# the within-row slot is the global index minus the row's first
			# occurrence — no Python per-nonzero loop.
			first = np.searchsorted(rb, np.arange(rpd))
			slots = np.arange(rb.size) - first[rb]
			ell_data[d, rb, slots] = vb
			ell_idx[d, rb, slots] = cb
	return st_data, st_cols, st_rows, ell_data, ell_idx, rpd, halo_ok, bw


def _local_csr_mm(data, cols, rows, ell_data, ell_idx, V, *, rpd: int):
	"""Per-chip CSR SpMM against a gatherable V segment (ELL or sorted-scatter)."""
	acc = jnp.promote_types(data.dtype, jnp.float32)
	if ell_data is not None:
		from ..operators.sparse import ell_apply

		out = ell_apply(ell_data.astype(acc), ell_idx, V.astype(acc))
		return out.astype(data.dtype)
	prod = data[:, None].astype(acc) * V[cols, :].astype(acc)
	out = jax.ops.segment_sum(prod, rows, num_segments=rpd, indices_are_sorted=True)
	return out.astype(data.dtype)


@jax.tree_util.register_pytree_node_class
class ShardedCSROperator(LinearOperator):
	"""General-sparsity CSR operator row-partitioned across the ``op`` axis.

	The sharded path for SCATTERED patterns — no dense-tile re-blocking, so a
	random 0.1%-density graph keeps its nnz-proportional storage instead of the
	up-to-64× inflation a forced (8, 8) BSR re-block pays (round-2 verdict
	weak-point 4). Each chip stores its contiguous row band in the same layout
	the single-chip :class:`~primate_tpu.operators.sparse.CSROperator` picks:
	ELL planes (gather + dense slot-sum, no scatter) when
	padding to the longest local row is cheap, sorted `segment_sum` otherwise.

	Communication follows the module convention: ``comm="allgather"`` keeps
	probes replicated (one output all-gather by spec); ``comm="halo"`` row-
	shards the probes and ring-``ppermute``s the two neighbor segments when
	every nonzero's column lies within ±1 neighbor's rows (``"auto"`` probes
	the pattern and falls back).
	"""

	def __init__(
		self,
		data: jnp.ndarray,  # (ndev, nnz_max)
		cols: jnp.ndarray,  # (ndev, nnz_max) global (allgather) / halo-window cols
		rows: jnp.ndarray,  # (ndev, nnz_max) local row ids
		ell_data: Optional[jnp.ndarray],  # (ndev, rpd, L) or None
		ell_idx: Optional[jnp.ndarray],
		shape: Tuple[int, int],
		mesh: Mesh,
		op_axis: str = "op",
		probe_axis: Optional[str] = None,
		comm: str = "allgather",
		rpd: int = 0,
		halo: int = 0,
	):
		self.data, self.cols, self.rows = data, cols, rows
		self.ell_data, self.ell_idx = ell_data, ell_idx
		self.shape = tuple(shape)
		self.dtype = data.dtype
		self.mesh = mesh
		self.op_axis = op_axis
		self.probe_axis = probe_axis
		self.comm = comm
		self.rpd = int(rpd)
		self.halo = int(halo)  # boundary rows exchanged per ring neighbor (halo mode)

	@classmethod
	def from_csr(
		cls,
		A,
		mesh: Mesh,
		op_axis: str = "op",
		probe_axis: Optional[str] = None,
		comm: str = "auto",
		dtype=None,
	) -> "ShardedCSROperator":
		"""Partition a CSR operator / scipy sparse matrix across ``mesh[op_axis]``."""
		if isinstance(A, CSROperator):
			data, indices, indptr, shape = np.asarray(A.data), np.asarray(A.indices), np.asarray(A.indptr), A.shape
		else:
			import scipy.sparse as sps

			A = sps.csr_matrix(A) if not (sps.issparse(A) and A.format == "csr") else A
			data, indices, indptr, shape = A.data, A.indices, A.indptr, A.shape
		if dtype is not None:
			data = np.asarray(data, dtype)
		ndev = mesh.shape[op_axis]

		if comm == "halo" and shape[0] != shape[1]:
			# Match ShardedBSROperator: an explicit halo request on an
			# ineligible operator is an error, never a silent downgrade.
			raise ValueError("comm='halo' requires a square operator; use comm='allgather'.")
		want_halo = comm in ("auto", "halo") and shape[0] == shape[1]
		st_data, st_cols, st_rows, ell_d, ell_i, rpd, halo_ok, bw = _partition_csr_host(
			data, indices, indptr, shape[1], ndev, halo_col=want_halo
		)
		halo = 0
		if want_halo and halo_ok:
			mode = "halo"
			# MINIMAL halo: only the matrix BANDWIDTH's worth of boundary rows
			# crosses the ring per neighbor (like ShardedDIAOperator) — a
			# tridiagonal 1M-row partition ships 1 row per neighbor instead of
			# the whole n/ndev segment. Falls back to full segments (h = rpd)
			# when the band is wider than one chip's rows.
			halo = int(min(max(bw, 1), rpd))
			# Remap global cols into the halo window [lo − h, hi + h):
			# local col = global col − (d·rpd − h).
			shift = ((np.arange(ndev)) * rpd - halo).astype(np.int32)
			st_cols = st_cols - shift[:, None]
			if ell_i is not None:
				ell_i = ell_i - shift[:, None, None]
		else:
			if comm == "halo" and not halo_ok:
				raise ValueError(
					"comm='halo' requires every nonzero within ±1 neighbor's rows; "
					"reorder the matrix (e.g. RCM) or use comm='allgather'."
				)
			mode = "allgather"

		spec = NamedSharding(mesh, P(op_axis))
		put = lambda x: None if x is None else jax.device_put(jnp.asarray(x), spec)  # noqa: E731
		return cls(
			put(st_data), put(st_cols), put(st_rows), put(ell_d), put(ell_i),
			shape, mesh, op_axis, probe_axis, comm=mode, rpd=rpd, halo=halo,
		)

	@property
	def nnz(self) -> int:
		return int(self.data.shape[0] * self.data.shape[1])  # incl. per-device padding

	@property
	def _n_row_pad(self) -> int:
		return self.rpd * self.mesh.shape[self.op_axis]

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		n = self.shape[0]
		op_ax, pr_ax = self.op_axis, self.probe_axis
		pr = _probe_axis_or_none(self.mesh, pr_ax, V.shape[1])
		local = partial(_local_csr_mm, rpd=self.rpd)
		has_ell = self.ell_data is not None

		if has_ell:
			args = (self.data, self.cols, self.rows, self.ell_data, self.ell_idx)
			nz_specs = (P(op_ax),) * 5
		else:
			args = (self.data, self.cols, self.rows)
			nz_specs = (P(op_ax),) * 3

		def unpack(nz):
			if has_ell:
				data, cols, rows, ell_d, ell_i = nz
				return data[0], cols[0], rows[0], ell_d[0], ell_i[0]
			data, cols, rows = nz
			return data[0], cols[0], rows[0], None, None

		if self.comm == "halo":
			n_pad = self._n_row_pad
			Vp = jnp.pad(V, ((0, n_pad - V.shape[0]), (0, 0))) if V.shape[0] != n_pad else V
			ndev = self.mesh.shape[op_ax]
			fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
			bwd = [(i, (i - 1) % ndev) for i in range(ndev)]
			h = self.halo if self.halo > 0 else self.rpd  # 0: legacy full-segment pytrees

			def shard_fn(*a):
				*nz, Vl = a
				# Ring-exchange ONLY the h boundary rows each way — O(h·k)
				# traffic per neighbor, independent of n (the DIA scheme).
				tail_from_left = lax.ppermute(Vl[-h:], op_ax, fwd)
				head_from_right = lax.ppermute(Vl[:h], op_ax, bwd)
				V_ext = jnp.concatenate([tail_from_left, Vl, head_from_right], axis=0)
				return local(*unpack(nz), V_ext)

			out = jax.shard_map(
				shard_fn, mesh=self.mesh, in_specs=nz_specs + (P(op_ax, pr),), out_specs=P(op_ax, pr)
			)(*args, Vp)
			return out[:n]

		def shard_fn(*a):
			*nz, Vfull = a
			return local(*unpack(nz), Vfull)

		out = jax.shard_map(
			shard_fn, mesh=self.mesh, in_specs=nz_specs + (P(None, pr),), out_specs=P(op_ax, pr)
		)(*args, V)
		return out[:n]

	def matmat_t(self, Vt: jnp.ndarray) -> jnp.ndarray:
		"""Probe-major apply ``(A Vtᵀ)ᵀ`` on a ``(k, n)`` block — native sharded
		kernels, so the Lanczos carry never transposes (a transpose of a
		row-sharded array is a resharding collective on a real mesh)."""
		n = self.shape[0]
		op_ax, pr_ax = self.op_axis, self.probe_axis
		pr = _probe_axis_or_none(self.mesh, pr_ax, Vt.shape[0])
		rpd = self.rpd
		has_ell = self.ell_data is not None

		if has_ell:
			args = (self.data, self.cols, self.rows, self.ell_data, self.ell_idx)
			nz_specs = (P(op_ax),) * 5
		else:
			args = (self.data, self.cols, self.rows)
			nz_specs = (P(op_ax),) * 3

		def local_t(nz, Vt_seg):
			acc = jnp.promote_types(self.dtype, jnp.float32)
			if has_ell:
				data, cols, rows, ell_d, ell_i = (x[0] for x in nz)
				out = jnp.einsum("bil,il->bi", Vt_seg[:, ell_i].astype(acc), ell_d.astype(acc))
				return out.astype(self.dtype)
			data, cols, rows = (x[0] for x in nz)
			prod = data[None, :].astype(acc) * Vt_seg[:, cols].astype(acc)
			out = jax.ops.segment_sum(prod.T, rows, num_segments=rpd, indices_are_sorted=True)
			return out.T.astype(self.dtype)

		if self.comm == "halo":
			n_pad = self._n_row_pad
			Vp = jnp.pad(Vt, ((0, 0), (0, n_pad - Vt.shape[1]))) if Vt.shape[1] != n_pad else Vt
			ndev = self.mesh.shape[op_ax]
			fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
			bwd = [(i, (i - 1) % ndev) for i in range(ndev)]
			h = self.halo if self.halo > 0 else self.rpd

			def shard_fn(*a):
				*nz, Vl = a
				tail_from_left = lax.ppermute(Vl[:, -h:], op_ax, fwd)
				head_from_right = lax.ppermute(Vl[:, :h], op_ax, bwd)
				V_ext = jnp.concatenate([tail_from_left, Vl, head_from_right], axis=1)
				return local_t(nz, V_ext)

			out = jax.shard_map(
				shard_fn, mesh=self.mesh, in_specs=nz_specs + (P(pr, op_ax),), out_specs=P(pr, op_ax)
			)(*args, Vp)
			return out[:, :n]

		def shard_fn(*a):
			*nz, Vfull = a
			return local_t(nz, Vfull)

		out = jax.shard_map(
			shard_fn, mesh=self.mesh, in_specs=nz_specs + (P(pr, None),), out_specs=P(pr, op_ax)
		)(*args, Vt)
		return out[:, :n]

	def todense(self) -> np.ndarray:
		"""Host-side reconstruction (tests / small operators only)."""
		data = np.asarray(self.data)
		cols = np.asarray(self.cols)
		rows = np.asarray(self.rows)
		ndev = data.shape[0]
		out = np.zeros(self.shape)
		for d in range(ndev):
			c = cols[d] + ((d * self.rpd - (self.halo if self.halo > 0 else self.rpd)) if self.comm == "halo" else 0)
			r = d * self.rpd + rows[d]
			ok = (r < self.shape[0]) & (c >= 0) & (c < self.shape[1]) & (data[d] != 0)
			np.add.at(out, (r[ok], c[ok]), data[d][ok])
		return out

	def tree_flatten(self):
		children = (self.data, self.cols, self.rows)
		if self.ell_data is not None:
			children += (self.ell_data, self.ell_idx)
		aux = (self.shape, self.dtype, self.mesh, self.op_axis, self.probe_axis, self.comm, self.rpd, self.halo, self.ell_data is not None)
		return children, aux

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.data, obj.cols, obj.rows = children[:3]
		has_ell = aux[-1]
		obj.ell_data, obj.ell_idx = (children[3], children[4]) if has_ell else (None, None)
		obj.shape, obj.dtype, obj.mesh, obj.op_axis, obj.probe_axis, obj.comm, obj.rpd, obj.halo, _ = aux
		return obj


def shard_operator(
	A,
	mesh: Mesh,
	op_axis: str = "op",
	probe_axis: Optional[str] = None,
	comm: str = "auto",
	**kwargs,
) -> LinearOperator:
	"""Partition any supported operator across a mesh axis.

	Dense arrays → :class:`ShardedDenseOperator`; DIA → :class:`ShardedDIAOperator`;
	BSR (or an explicit ``blocksize=``) → :class:`ShardedBSROperator`; CSR and
	general scipy sparse → :class:`ShardedCSROperator` — scattered patterns keep
	nnz-proportional storage instead of being silently re-blocked into dense
	tiles (pass ``blocksize=`` to opt into BSR; its fill-in warning then applies).
	"""
	import scipy.sparse as sps

	if isinstance(A, (jnp.ndarray, np.ndarray)) and getattr(A, "ndim", 0) == 2:
		return ShardedDenseOperator(jnp.asarray(A), mesh, op_axis, dtype=kwargs.pop("dtype", None))
	if isinstance(A, DIAOperator):
		return ShardedDIAOperator.from_dia(A, mesh, op_axis, probe_axis, **kwargs)
	if isinstance(A, BSROperator):
		return ShardedBSROperator.from_bsr(A, mesh, op_axis, probe_axis, comm, **kwargs)
	if isinstance(A, CSROperator):
		if "blocksize" in kwargs:
			return ShardedBSROperator.from_bsr(A.tobsr(kwargs.pop("blocksize")), mesh, op_axis, probe_axis, comm, **kwargs)
		return ShardedCSROperator.from_csr(A, mesh, op_axis, probe_axis, comm, **kwargs)
	if sps.issparse(A):
		if getattr(A, "format", None) == "dia":
			return ShardedDIAOperator.from_dia(A, mesh, op_axis, probe_axis, **kwargs)
		if getattr(A, "format", None) == "bsr" or "blocksize" in kwargs:
			return ShardedBSROperator.from_bsr(A, mesh, op_axis, probe_axis, comm, **kwargs)
		return ShardedCSROperator.from_csr(A, mesh, op_axis, probe_axis, comm, **kwargs)
	op = aslinop(A)
	if hasattr(op, "A") and isinstance(op.A, jnp.ndarray):
		return ShardedDenseOperator(op.A, mesh, op_axis, dtype=kwargs.pop("dtype", None))
	raise TypeError(f"Cannot shard operator of type {type(A)}")


def auto_shard_operator(
	A,
	mesh: Mesh,
	op_axis: str = "op",
	probe_axis: Optional[str] = None,
	comm: str = "auto",
	reorder: str = "auto",
	dtype=None,
	**kwargs,
):
	"""Prepare (format + ordering) and partition a matrix in one step.

	Composes :func:`~primate_tpu.operators.auto_operator` with
	:func:`shard_operator`. The RCM reordering that unlocks the DIA format is
	doubly valuable sharded: the halo width of the ring-``ppermute`` exchange
	is the matrix *bandwidth*, so a bandwidth-reducing ordering turns an
	impossible partition (halo wider than a chip's row block — a hard error)
	into a minimal-halo stencil. Spectral sums are similarity-invariant, so
	the reordering is free for trace/logdet/density estimation.

	Returns ``(sharded_op, PrepInfo)``; use ``PrepInfo.permute/unpermute`` for
	per-coordinate inputs/outputs (see ``operators.prepare``). Extra kwargs are
	routed by signature to the preparation (``dia_fill_limit``, ``blocksize``,
	...) and the sharding constructors (``halo``, ...).
	"""
	from ..operators.prepare import auto_operator
	from ..utils.kwargs import restrict_kwargs, setdiff_kwargs

	prep_kwargs = restrict_kwargs(auto_operator, kwargs)
	shard_kwargs = setdiff_kwargs(auto_operator, kwargs)
	op, info = auto_operator(A, dtype=dtype, reorder=reorder, **prep_kwargs)
	sharded = shard_operator(op, mesh, op_axis=op_axis, probe_axis=probe_axis, comm=comm, **shard_kwargs)
	return sharded, info
