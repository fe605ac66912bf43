"""Irregular-matrix benchmark sweep (BASELINE config 3 realism).

For each locally-built matrix class (`benchmarks.matrices`):

  * SpMM throughput (nnz/s, GB/s) through the operator format the library
    auto-selects for it (CSR segment-sum vs ELL planes; BSR for the block
    case; DIA for the FEM stencil) — the BASELINE north-star metric;
  * estimator walls at fixed budgets: SLQ logdet `hutch(MatrixFunction)`,
    `hutchpp`, `xtrace`, and `diag`, with accuracy vs a trustworthy proxy
    (exact trace; high-budget reference for logdet).

Run: ``python -m benchmarks.realism [--small]`` — one JSON line per
(matrix, measurement). ``--small`` shrinks sizes for a CPU smoke pass.
"""

import argparse
import json
import time

import numpy as np

import jax
import jax.numpy as jnp


def _timed(fn, reps=5):
	fn()  # warmup/compile
	best = np.inf
	out = None
	for _ in range(reps):
		t0 = time.perf_counter()
		out = fn()
		best = min(best, time.perf_counter() - t0)
	return best, out


def _operators(A, kind: str):
	"""The operator formats worth measuring for this matrix class."""
	import primate_tpu as pt
	from primate_tpu.operators.sparse import CSROperator, DIAOperator

	ops = {}
	csr = CSROperator.from_scipy(A, dtype=jnp.float32)
	label = "+ell" if csr.ell_data is not None else ("+sell" if csr.sell is not None else "")
	ops["csr" + label] = csr
	if kind == "fem":
		ops["dia"] = DIAOperator.from_scipy(A, dtype=jnp.float32)
	if kind == "block":
		from primate_tpu.operators.sparse import BSROperator

		ops["bsr"] = BSROperator.from_scipy(A, blocksize=(8, 8), dtype=jnp.float32)
	return ops


def run_matrix(name: str, A, deg: int, probes: int, seed: int = 0) -> list:
	import primate_tpu as pt
	from primate_tpu.utils.profiling import benchmark_matvec

	rows = []
	n = A.shape[0]
	ops = _operators(A, name.split("_")[0])

	for fmt, op in ops.items():
		stats = benchmark_matvec(op, k=32, iters=20, seed=seed)
		rows.append({
			"matrix": name, "n": n, "nnz": int(A.nnz), "measure": "spmm", "format": fmt,
			"per_apply_s": round(stats["sec_per_matmat"], 6),
			"nnz_per_s": round(stats.get("nnz_per_s", 0.0), 1),
			"gb_per_s": round(float(stats.get("effective_GBps", 0.0)), 2),
		})

	# Estimators run on the structure-native format (DIA for stencils, BSR for
	# block patterns, CSR otherwise) — the choice a user following the operator
	# docs would make, and what the SpMM rows above justify.
	op = ops.get("bsr") or ops.get("dia") or next(iter(ops.values()))
	tr_exact = float(A.diagonal().sum())

	M = pt.MatrixFunction(op, fun="log", deg=deg, orth=0, dtype=jnp.float32)
	dt, est = _timed(lambda: pt.hutch(M, batch=probes, converge="count", count=probes, seed=seed))
	rows.append({"matrix": name, "n": n, "measure": "slq_logdet_hutch", "wall_s": round(dt, 4),
		"deg": deg, "probes": probes, "estimate": float(est)})

	dt, est = _timed(lambda: pt.hutchpp(op, m=3 * probes, seed=seed))
	rows.append({"matrix": name, "n": n, "measure": "hutchpp", "wall_s": round(dt, 4),
		"estimate": float(est), "rel_err_vs_exact": round(abs(float(est) - tr_exact) / abs(tr_exact), 5)})

	xb = min(probes, 32)
	dt, est = _timed(lambda: pt.xtrace(op, batch=xb, converge="count", count=4 * xb, seed=seed))
	rows.append({"matrix": name, "n": n, "measure": "xtrace", "wall_s": round(dt, 4),
		"estimate": float(est), "rel_err_vs_exact": round(abs(float(est) - tr_exact) / abs(tr_exact), 5)})

	# diag's criterion counts ITERATIONS (budget = batch × count): 4 × 16 = 64 probes.
	dt, d = _timed(lambda: pt.diag(op, converge="count", count=4, batch=16, seed=seed))
	derr = float(np.linalg.norm(np.asarray(d) - A.diagonal()) / np.linalg.norm(A.diagonal()))
	rows.append({"matrix": name, "n": n, "measure": "diag64", "wall_s": round(dt, 4),
		"rel_err_vs_exact": round(derr, 5)})
	return rows


def main() -> None:
	p = argparse.ArgumentParser()
	p.add_argument("--small", action="store_true", help="CPU smoke sizes")
	args = p.parse_args()

	from benchmarks.matrices import block_random_spd, fem_laplacian_3d, powerlaw_laplacian

	if args.small:
		cases = [
			("powerlaw_ba", powerlaw_laplacian(20_000, m=4, seed=0)),
			("fem_7pt", fem_laplacian_3d(24)),
			("block_8x8", block_random_spd(4096)),
		]
		deg, probes = 12, 32
	else:
		cases = [
			("powerlaw_ba", powerlaw_laplacian(500_000, m=4, seed=0)),
			("fem_7pt", fem_laplacian_3d(64)),  # 262k rows, 1.8M nnz
			("block_8x8", block_random_spd(16_384)),
		]
		deg, probes = 20, 64

	print(json.dumps({"platform": jax.devices()[0].platform, "small": args.small}))
	for name, A in cases:
		for row in run_matrix(name, A, deg, probes):
			print(json.dumps(row), flush=True)


if __name__ == "__main__":
	from benchmarks.cache import enable_compile_cache

	enable_compile_cache()
	main()
