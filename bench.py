"""Headline benchmark: SLQ logdet on a sparse graph Laplacian (BASELINE config 2).

Estimates ``logdet(L)`` for a 500k-node path-graph Laplacian (+I, SPD, ~1.5M
nnz) by stochastic Lanczos quadrature: 64 Rademacher probes, degree-20 Krylov,
Gauss-Welsch quadrature — the flagship fused program
``hutch(MatrixFunction(L, "log"))``.

Baseline: the same estimator implemented the reference's way — a host loop of
serial per-probe Lanczos recurrences over CSR matvecs (the architecture of
``src/primate/trace.py`` + ``include/lanczos.h``). Preferred implementation:
the REAL scikit-primate package compiled from source where its headers are
installed (`benchmarks/real_reference.py`); fallbacks: a compiled C++ sweep
(`benchmarks/ref_native.cpp`), then the numpy stand-in. Identical probe-count/
degree/quadrature, so vs_baseline is an apples-to-apples wall-time ratio on
this machine.

Measures in this process and refuses to run without a GPU: there is no CPU
fallback, so a number it prints is always a device number. Every line names
the device (platform, kind, count) and the card's power limit.

The last JSON line is the headline: {"metric", "value" (wall seconds), "unit",
"vs_baseline" (baseline_time / our_time; >1 means faster than the reference
architecture), "device"}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sps

N = 500_000
DEG = 20
# No re-orthogonalization, on BOTH sides — the reference's own `lanczos()`
# default (`src/primate/lanczos.py:30`, documented as a first-class mode at
# `lanczos.py:52-53`). The north-star metric is accuracy-targeted ("logdet
# wall to rtol=1e-2", BASELINE.md): at deg 20 on this operator re-orth
# changes NOTHING — measured estimates are identical at orth∈{0,3,5} on both
# implementations (rel err ~1.7e-4 reference / ~1.2e-4 ours, 50x inside the
# target), so the window would be pure, symmetric overhead. The accuracy
# assert below guards this for both sides on every run.
ORTH = 0
PROBES = 64
REPS = 7
# Median-of-5 for the reference denominator: the host
# loop's wall drifts 7-9.5 s with machine load, so a 2-rep min inherited
# single-session variance into the committed vs_baseline. The 1-min loadavg is
# recorded alongside so the denominator's conditions are stated.
BASE_REPS = 5

def build_laplacian(n: int) -> sps.csr_matrix:
	main = 3.0 * np.ones(n, np.float32)
	off = -1.0 * np.ones(n - 1, np.float32)
	return sps.diags([off, main, off], [-1, 0, 1]).tocsr().astype(np.float32)


def baseline_slq_logdet(A: sps.csr_matrix, deg: int, orth: int, probes: int, seed: int = 0) -> tuple:
	"""Reference-architecture SLQ: serial per-probe Lanczos on host CSR matvecs."""
	n = A.shape[0]
	rng = np.random.default_rng(seed)
	t0 = time.perf_counter()
	total = 0.0
	for _ in range(probes):
		v = rng.integers(0, 2, n).astype(np.float32) * 2.0 - 1.0
		nrm = np.linalg.norm(v)
		q = v / nrm
		Q = np.zeros((orth, n), np.float32)  # ring of the last `orth` basis vectors
		Q[0] = q
		alphas = np.zeros(deg, np.float64)
		betas = np.zeros(deg, np.float64)
		beta = 0.0
		q_prev = np.zeros(n, np.float32)
		for j in range(deg):
			w = A @ q - beta * q_prev
			alpha = float(w @ q)
			w -= alpha * q
			for u in Q:  # windowed MGS re-orth (zero slots contribute nothing)
				w -= (w @ u) * u
			beta = float(np.linalg.norm(w))
			alphas[j], betas[j] = alpha, beta
			if beta < 1e-10:
				break
			q_prev, q = q, w / beta
			Q[(j + 1) % orth] = q
		T = np.diag(alphas) + np.diag(betas[: deg - 1], 1) + np.diag(betas[: deg - 1], -1)
		theta, Y = np.linalg.eigh(T)
		tau = Y[0, :] ** 2
		total += float(np.sum(np.log(np.maximum(theta, 1e-30)) * tau) * nrm**2)
	est = total / probes
	return est, time.perf_counter() - t0


def main() -> int:
	import jax

	dev = jax.devices()[0]
	if dev.platform != "gpu":
		print(f"bench: needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
		return 2
	from benchmarks.cache import enable_compile_cache

	enable_compile_cache()
	smi = subprocess.run(
		["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
	).stdout.strip()
	device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()), "nvidia_smi": smi}

	import jax.numpy as jnp

	import primate_tpu as pt
	from primate_tpu.operators.sparse import DIAOperator

	A = build_laplacian(N)

	# --- ours: one fused device program ----------------------------------
	# DIA: the stencil format for banded Laplacians.
	op = DIAOperator.from_scipy(A, dtype=jnp.float32)
	# With ORTH=0 no window is carried; reorth_passes/basis_dtype are inert but
	# kept so flipping ORTH back on reproduces the round-2 configuration
	# (bf16 window + single CGS pass, matching the baseline's one MGS sweep).
	M = pt.MatrixFunction(
		op, fun="log", deg=DEG, orth=ORTH, reorth_passes=1, dtype=jnp.float32, basis_dtype=jnp.bfloat16
	)

	def run():
		est = pt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=42)
		return est

	est = run()  # warmup/compile
	times = []
	for _ in range(REPS):
		t0 = time.perf_counter()
		run()
		times.append(time.perf_counter() - t0)
	ours = float(np.median(times))

	# --- baseline: the reference itself -----------------------------------
	# Preference order (see benchmarks/REFERENCE_BUILD.md):
	#   1. the REAL scikit-primate package, `_lanczos.cpp` compiled against the
	#      Eigen/pybind11 headers of an installed tensorflow/torch wheel, where
	#      one is installed (the genuinely honest number);
	#   2. a fresh compiled-C++ implementation of the same architecture;
	#   3. the numpy host-loop stand-in of rounds 1-2.
	base_impl, base_runs = "numpy-host", None
	try:
		from benchmarks.real_reference import build as _real_build, real_slq_logdet

		if _real_build():
			base_impl = "real-reference"
			base_runs = [real_slq_logdet(A, DEG, ORTH, PROBES) for _ in range(BASE_REPS)]
	except Exception:
		base_runs = None
	if base_runs is None:
		try:
			from benchmarks.ref_baseline import available as _native_ok, native_slq_logdet

			if _native_ok():
				base_impl = "compiled-cpp"
				base_runs = [native_slq_logdet(A, DEG, ORTH, PROBES) for _ in range(BASE_REPS)]
		except Exception:
			base_runs = None
	if base_runs is None:
		base_impl = "numpy-host"
		base_runs = [baseline_slq_logdet(A, DEG, ORTH, PROBES) for _ in range(BASE_REPS)]
	base_est = base_runs[0][0]
	# Median of BASE_REPS with the host load stated beside it.
	base_time = float(np.median([t for _, t in base_runs]))
	base_load = round(os.getloadavg()[0], 2)

	# Sanity: both estimators near the exact logdet (eigenvalues are known).
	k = np.arange(1, N + 1)
	exact = float(np.sum(np.log(3.0 - 2.0 * np.cos(k * np.pi / (N + 1)))))
	for name, val in (("ours", est), ("baseline", base_est)):
		rel = abs(val - exact) / abs(exact)
		assert rel < 0.05, f"{name} logdet rel err {rel:.3f} (est {val:.1f} vs exact {exact:.1f})"

	# --- supplementary lines before the headline (the LAST line) ----------
	from primate_tpu.utils.profiling import benchmark_matvec

	spmm = benchmark_matvec(op, k=PROBES, iters=20, seed=0)
	print(json.dumps({
		"metric": f"spmm_dia_n{N}_k{PROBES}_nnz_per_s",
		"value": float(spmm.get("nnz_per_s", 0.0)),
		"unit": "nnz/s",
		"vs_baseline": None,
		"sec_per_matmat": float(spmm["sec_per_matmat"]),
		"device": device,
	}))
	print(json.dumps({
		"metric": f"lanczos_matvecs_per_s_n{N}_deg{DEG}",
		"value": DEG * PROBES / ours,
		"unit": "matvec/s",
		"vs_baseline": (DEG * PROBES / ours) / (DEG * PROBES / base_time),
		"note": "single-column-equivalent matvecs of the fused SLQ estimate (deg x probes / wall)",
		"device": device,
	}))
	print(
		json.dumps(
			{
				"metric": f"slq_logdet_n{N}_deg{DEG}_probes{PROBES}_walltime",
				"value": ours,
				"unit": "s",
				"vs_baseline": base_time / ours,
				"stat": f"median of {REPS}",
				"device": device,
				"baseline_impl": base_impl,
				"baseline_reps": BASE_REPS,
				"baseline_stat": "median",
				"baseline_load1": base_load,
			}
		)
	)


if __name__ == "__main__":
	sys.exit(main())
