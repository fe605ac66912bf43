"""The five BASELINE.json benchmark configurations as runnable functions.

`bench.py` at the repo root runs the headline config (2) and prints the driver
JSON line; this module makes every config reproducible:

  1. Girard-Hutchinson trace, 1k×1k dense SPD, 64 Rademacher probes
  2. logdet via Lanczos quadrature, banded graph Laplacian, deg-20 Krylov
  3. Hutch++ / XTrace trace + diagonal on block-sparse SPD operators
  4. heat-kernel / Estrada: exp(A) quadrature on a 2-D mesh Laplacian (DIA)
  5. sharded GP log-likelihood style run: distributed SpMM Lanczos on a mesh

Run: ``python -m benchmarks.configs [1-5] [--size S]``.
Each function returns {"metric", "value", "unit", plus context fields}.
"""

import time

import numpy as np
import scipy.sparse as sps

import jax
import jax.numpy as jnp


def _laplacian_1d(n, dtype=np.float32):
	return sps.diags(
		[-np.ones(n - 1, dtype), 3.0 * np.ones(n, dtype), -np.ones(n - 1, dtype)], [-1, 0, 1]
	).tocsr()


def _laplacian_2d(side, dtype=np.float32):
	"""5-point stencil on a side×side grid (+I): 5 diagonals — DIA-native."""
	n = side * side
	main = 5.0 * np.ones(n, dtype)
	ew = -np.ones(n - 1, dtype)
	ew[side - 1 :: side] = 0  # no wrap across grid rows
	ns = -np.ones(n - side, dtype)
	return sps.diags([ns, ew, main, ew, ns], [-side, -1, 0, 1, side]).tocsr()


def _timed(fn, reps=3):
	fn()  # warmup/compile
	best = np.inf
	for _ in range(reps):
		t0 = time.perf_counter()
		out = fn()
		best = min(best, time.perf_counter() - t0)
	return best, out


def config1_dense_hutch(n=1000, probes=64, seed=0):
	import primate_tpu as pt

	A = pt.symmetric(n, pd=True, seed=seed)
	tr = float(jnp.trace(jnp.asarray(A)))
	dt, est = _timed(lambda: pt.hutch(A, batch=probes, converge="count", count=probes, seed=seed))
	return {"metric": "hutch_dense_1k", "value": dt, "unit": "s", "estimate": float(est), "true": tr}


def config2_logdet_laplacian(n=50_000, deg=20, probes=64, seed=42):
	import primate_tpu as pt
	from primate_tpu.operators.sparse import DIAOperator

	A = _laplacian_1d(n)
	op = DIAOperator.from_scipy(A, dtype=jnp.float32)
	M = pt.MatrixFunction(op, fun="log", deg=deg, orth=5, dtype=jnp.float32)
	dt, est = _timed(lambda: pt.hutch(M, batch=probes, converge="count", count=probes, seed=seed))
	k = np.arange(1, n + 1)
	exact = float(np.sum(np.log(3.0 - 2.0 * np.cos(k * np.pi / (n + 1)))))
	return {"metric": "slq_logdet_50k", "value": dt, "unit": "s", "estimate": float(est), "true": exact}


def config3_hutchpp_xtrace_bsr(n=4096, seed=7):
	import primate_tpu as pt
	from primate_tpu.operators.sparse import BSROperator

	rng = np.random.default_rng(seed)
	# Genuinely block-structured SPD: a random symmetric pattern of dense
	# 8x8 tiles (~4% of the block grid) + a diagonally-dominant shift. (A
	# scattered elementwise pattern lights up ~every tile and BSR degenerates
	# to dense storage — BSROperator warns in that case.)
	nb = n // 8
	mask = sps.random(nb, nb, density=0.02, random_state=rng, format="csr")
	mask.data[:] = 1.0
	S = sps.kron(mask, np.ones((8, 8), np.float32)).tocsr()
	S.data = rng.normal(size=S.data.shape).astype(np.float32)
	S = ((S + S.T) / 2).tocsr()
	shift = float(np.abs(S).sum(axis=1).max()) + 1.0  # Gershgorin: SPD
	S = (S + shift * sps.identity(n, np.float32)).tocsr()
	op = BSROperator.from_scipy(S, blocksize=(8, 8), dtype=jnp.float32)
	tr = float(S.diagonal().sum())
	dt_pp, est_pp = _timed(lambda: pt.hutchpp(op, m=240, seed=seed))
	dt_xt, est_xt = _timed(lambda: pt.xtrace(op, batch=64, converge="count", count=256, seed=seed))
	dt_xn, est_xn = _timed(lambda: pt.xnystrace(op, m=720, seed=seed))  # = hutchpp's true 3·nb matvec budget
	dt_xd, est_xd = _timed(lambda: pt.xdiag(op, m=256, seed=seed))
	return {
		"metric": "hutchpp_xtrace_bsr_4k",
		"value": dt_pp + dt_xt + dt_xd,
		"unit": "s",
		"true": tr,
		"hutchpp": {"t": dt_pp, "est": float(est_pp)},
		"xtrace": {"t": dt_xt, "est": float(est_xt)},
		"xnystrace": {"t": dt_xn, "est": float(est_xn)},
		"xdiag_sum": {"t": dt_xd, "est": float(np.sum(est_xd))},
	}


def config4_heat_kernel_mesh(side=1000, deg=20, probes=32, t=-1.0, seed=3, nt=8):
	"""Heat-kernel traces on a side²-node mesh Laplacian (1M at side=1000).

	BASELINE asks for "batched f's": the single-t estimate plus an ``nt``-point
	heat-trace curve tr(exp(-t·A)) from ONE set of Lanczos sweeps
	(`special.stacked` — the quadrature rules are f-independent)."""
	import primate_tpu as pt
	from primate_tpu.operators.sparse import DIAOperator

	A = _laplacian_2d(side)
	op = DIAOperator.from_scipy(A, dtype=jnp.float32)
	M = pt.MatrixFunction(op, fun="exp", t=t, deg=deg, orth=0, dtype=jnp.float32)
	dt, est = _timed(lambda: pt.hutch(M, batch=probes, converge="count", count=probes, seed=seed))
	ts = np.geomspace(0.05, 4.0, nt) * (-t)
	Mc = pt.MatrixFunction(op, fun=pt.stacked("exp", -ts), deg=deg, orth=0, dtype=jnp.float32)
	dt_curve, curve = _timed(lambda: pt.hutch(Mc, batch=probes, converge="count", count=probes, seed=seed))
	return {
		"metric": f"heat_kernel_mesh_{side * side}",
		"value": dt,
		"unit": "s",
		"estimate": float(est),
		"curve": {
			"nt": int(nt),
			"timepoints": ts.tolist(),
			"elapsed_s": dt_curve,
			"per_timepoint_s": dt_curve / nt,
			"estimates": np.asarray(curve).tolist(),
		},
	}


def config5_sharded_gp(n=262_144, deg=16, probes=32, seed=5):
	"""Distributed SpMM Lanczos over the available mesh (GP-loglik shape).

	Spans every local device (one process); on one device it runs the
	identical sharded program on a 1-device mesh.
	"""
	import primate_tpu as pt
	from primate_tpu.operators.sparse import DIAOperator
	from primate_tpu.parallel import make_mesh, shard_operator

	ndev = len(jax.devices())
	mesh = make_mesh((ndev, 1), ("op", "probe"))
	A = _laplacian_1d(n)
	op = shard_operator(DIAOperator.from_scipy(A, dtype=jnp.float32), mesh)
	M = pt.MatrixFunction(op, fun="log", deg=deg, orth=0, dtype=jnp.float32)
	dt, est = _timed(lambda: pt.hutch(M, batch=probes, converge="count", count=probes, seed=seed))
	return {"metric": f"sharded_logdet_{n}_x{ndev}dev", "value": dt, "unit": "s", "estimate": float(est)}


CONFIGS = {
	1: config1_dense_hutch,
	2: config2_logdet_laplacian,
	3: config3_hutchpp_xtrace_bsr,
	4: config4_heat_kernel_mesh,
	5: config5_sharded_gp,
}


if __name__ == "__main__":
	import json
	import sys

	from benchmarks.cache import enable_compile_cache

	enable_compile_cache()

	which = [int(a) for a in sys.argv[1:] if a.isdigit()] or sorted(CONFIGS)
	for i in which:
		print(json.dumps(CONFIGS[i]()))
