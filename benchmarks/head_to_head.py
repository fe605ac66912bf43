"""Head-to-head: every shared estimator, REAL reference package vs primate_tpu.

`bench.py` gives the driver one honest number (config-2 SLQ logdet vs the
compiled reference). This module widens that to the full shared estimator
surface — hutch / hutchpp / xtrace / xdiag / diag — with IDENTICAL matrices,
sample budgets, degrees, and probe distributions on both sides:

  * reference: the genuine scikit-primate build (`real_reference.build()`),
    its compiled `_lanczos` + Eigen + numpy/scipy estimator drivers, on host;
  * ours: the fused device programs (walls include the host<->device
    transfers of each call).

Run: ``python -m benchmarks.head_to_head``. Prints one JSON line per
estimator: {"estimator", "ref_s", "ours_s", "speedup", "ref_est", "our_est",
"true"}. Walls are min-of-reps (same statistic both sides).
"""

import json
import time

import numpy as np
import scipy.sparse as sps

def _spd_sparse(n: int = 4096, block: int = 8, seed: int = 0) -> sps.csr_matrix:
	"""Block-structured sparse SPD (config-3 style): random 8x8-tile pattern."""
	rng = np.random.default_rng(seed)
	nb = n // block
	density = 0.02
	rows, cols = np.nonzero(rng.random((nb, nb)) < density / 2)
	keep = rows <= cols
	rows, cols = rows[keep], cols[keep]
	blocks = rng.normal(size=(len(rows), block, block)).astype(np.float32)
	indptr = np.zeros(nb + 1, np.int64)
	order = np.argsort(rows, kind="stable")
	rows, cols, blocks = rows[order], cols[order], blocks[order]
	np.add.at(indptr, rows + 1, 1)
	indptr = np.cumsum(indptr)
	B = sps.bsr_matrix((blocks, cols, indptr), shape=(n, n)).tocsr()
	A = B + B.T
	# Diagonal dominance => SPD, well-conditioned.
	A = A + sps.diags(np.abs(A).sum(axis=1).A1.astype(np.float32) + 1.0)
	return A.tocsr().astype(np.float32)


def _spd_dense(n: int = 2048, seed: int = 1) -> np.ndarray:
	rng = np.random.default_rng(seed)
	Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
	ew = rng.uniform(0.1, 2.0, n)
	return (Q * ew) @ Q.T.astype(np.float32)


def _best(fn, reps: int) -> tuple:
	est = fn()
	ts = []
	for _ in range(reps):
		t0 = time.perf_counter()
		fn()
		ts.append(time.perf_counter() - t0)
	return est, float(np.min(ts))


def main() -> None:
	from benchmarks.real_reference import build

	assert build(), "real reference unavailable"
	import primate.diagonal as ref_diagonal
	import primate.trace as ref_trace

	import jax.numpy as jnp

	import primate_tpu as pt
	from primate_tpu.operators import CSROperator

	As = _spd_sparse()
	Ad = _spd_dense()
	As_op = CSROperator.from_scipy(As, dtype=jnp.float32)
	Ad_j = jnp.asarray(Ad)
	tr_s = float(As.diagonal().sum())
	tr_d = float(np.trace(Ad))
	d_s = As.diagonal()

	REPS_REF, REPS_OURS = 3, 5
	rows = []

	# --- hutch: dense 2048, 64 rademacher probes -------------------------
	r_est, r_t = _best(
		lambda: float(ref_trace.hutch(Ad, batch=64, converge="count", count=64, seed=np.random.default_rng(7))),
		REPS_REF,
	)
	o_est, o_t = _best(lambda: float(pt.hutch(Ad_j, batch=64, converge="count", count=64, seed=7)), REPS_OURS)
	rows.append(("hutch_dense_2048_64probes", r_t, o_t, r_est, o_est, tr_d))

	# --- hutchpp: sparse 4096, m=768 matvecs ------------------------------
	r_est, r_t = _best(lambda: float(ref_trace.hutchpp(As, m=768, seed=np.random.default_rng(8))), REPS_REF)
	o_est, o_t = _best(lambda: float(pt.hutchpp(As_op, m=768, seed=8)), REPS_OURS)
	rows.append(("hutchpp_sparse_4096_m768", r_t, o_t, r_est, o_est, tr_s))

	# --- xtrace: sparse 1024, default stop (m = n, exact) -----------------
	# The reference's xtrace cannot run a partial budget: any non-default
	# `converge` collapses to CountCriterion(n) (the `converge` name is
	# reassigned before the user's criterion is parsed, `trace.py:273-275` —
	# the self-OR quirk SURVEY.md documents), so the only semantics BOTH
	# implementations share is the default run-to-m=n exactness sweep. A
	# 1024-row principal submatrix keeps the reference's O(n m^2) host QR
	# affordable.
	As1k = As[:1024, :1024].tocsr()
	As1k_op = CSROperator.from_scipy(As1k, dtype=jnp.float32)
	tr_1k = float(As1k.diagonal().sum())
	r_est, r_t = _best(lambda: float(ref_trace.xtrace(As1k, batch=32, seed=np.random.default_rng(9))), REPS_REF)
	o_est, o_t = _best(lambda: float(pt.xtrace(As1k_op, batch=32, seed=9)), REPS_OURS)
	rows.append(("xtrace_sparse_1024_to_m_eq_n", r_t, o_t, r_est, o_est, tr_1k))

	# --- xdiag: sparse 4096, m=512 matvecs (report sum(diag) for a scalar) -
	r_est, r_t = _best(lambda: float(np.sum(ref_diagonal.xdiag(As.toarray(), m=512, seed=np.random.default_rng(10)))), REPS_REF)
	o_est, o_t = _best(lambda: float(np.sum(pt.xdiag(As_op, m=512, seed=10))), REPS_OURS)
	rows.append(("xdiag_sparse_4096_m512", r_t, o_t, r_est, o_est, float(d_s.sum())))

	# --- diag: sparse 4096, 512 rademacher probes ------------------------
	r_est, r_t = _best(
		lambda: float(
			np.sum(ref_diagonal.diag(As, converge="count", count=512, seed=np.random.default_rng(11)))
		),
		REPS_REF,
	)
	# NOTE: diag's criterion counts ITERATIONS (probe budget = batch × count,
	# see its docstring) — count=8 × batch=64 = the reference's 512 probes.
	o_est, o_t = _best(
		lambda: float(np.sum(np.asarray(pt.diag(As_op, converge="count", count=8, seed=11, batch=64)))),
		REPS_OURS,
	)
	rows.append(("diag_sparse_4096_512probes", r_t, o_t, r_est, o_est, float(d_s.sum())))

	import jax

	platform = jax.devices()[0].platform
	for name, r_t, o_t, r_est, o_est, true in rows:
		print(
			json.dumps(
				{
					"estimator": name,
					"ref_s": round(r_t, 4),
					"ours_s": round(o_t, 4),
					"speedup": round(r_t / o_t, 2),
					"ref_est": round(r_est, 2),
					"our_est": round(o_est, 2),
					"true": round(true, 2),
					"platform": platform,
				}
			)
		)


if __name__ == "__main__":
	from benchmarks.cache import enable_compile_cache

	enable_compile_cache()
	main()
