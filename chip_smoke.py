"""Run the fused estimators on a GPU at real sizes, each against an independent reference.

    python chip_smoke.py           # phases A-G on one GPU
    python chip_smoke.py --multi   # the sharded operators on four GPUs (that phase only)

Phases (one card):
  A  SLQ logdet, 1-D Laplacian + I, n = 10M, DIA          closed form
  B  heat-kernel trace + 8-point curve, 1000² mesh, DIA   separable closed form
  C  hutchpp / xtrace / diag, 500k power-law graph, CSR    exact trace, diagonal vs Rademacher s.e.
  D  xdiag / xnystrace, 16k block SPD, BSR 8×8             exact trace and diagonal
  E  eigsh + Chebyshev exp trace, 64³ FEM stencil, DIA     separable closed form
  F  xtrace at m = n, dense SPD n = 4096, f32              exact trace at rel 1e-4 (no TF32)
  G  jax.grad of autodiff.logdet(A + θI), phase A's A      Σ 1/λ_k

Each phase prints one JSON line: wall seconds, compile seconds, the device's
peak bytes so far, and every check (estimate, reference, error, tolerance).
The last line is ``{"ok": true, "device": {...}}`` only when every check of
every phase passed; otherwise the script exits 1. Without a GPU it exits 2
before any work. The phase functions take their sizes as arguments, so the
tests run each one tiny on the CPU against the same reference.
"""

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import scipy.sparse as sps

FULL = {
	"a_n": 10_000_000,
	"b_side": 1000,
	"c_n": 500_000,
	"d_n": 16_384,
	"e_side": 64,
	"f_n": 4096,
	"multi_dia_n": 40_000_000,
	"multi_n": 10_000_000,
	"probes": 64,
}

# Chebyshev degree for phase E's exp: the expansion of e^x on the operator's
# spectral interval [1, 13] converges to f32 roundoff well before this.
CHEB_DEG = 64


def check(name: str, estimate, reference, tol: float, err=None, **extra) -> dict:
	"""One comparison. ``err`` defaults to the relative error of scalars."""
	estimate, reference = float(np.asarray(estimate)), float(np.asarray(reference))
	if err is None:
		err = abs(estimate - reference) / abs(reference)
	return {"check": name, "estimate": estimate, "reference": reference, "err": float(err), "tol": tol, "ok": bool(err < tol), **extra}


def mean_of_ratios_factor(iters: int) -> float:
	"""Variance of ``diag``'s estimate over that of the plain mean of the same
	probes. ``diag`` returns the mean of its running ratios (reference
	parity), which weights batch s by Σ_{t≥s} 1/t."""
	h = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, iters + 1))])
	return float(np.sum((h[-1] - h[:-1]) ** 2) / iters)


def check_diagonal(name: str, est, A: sps.spmatrix, n_probes: int, var_factor: float = 1.0) -> dict:
	"""Diagonal estimate against the exact diagonal, in units of the Rademacher
	standard error se_i = sqrt(var_factor · Σ_{j≠i} a_ij² / n_probes),
	computed from A.

	With ~10⁵ entries, ~0.27% of them fall past 3 se by chance alone, so the
	check asks that at most 1% do and that none falls past 6 se (a Gaussian
	tail of ~2e-9 per entry)."""
	est = np.asarray(est, np.float64)
	exact = A.diagonal().astype(np.float64)
	off2 = np.asarray(A.multiply(A).sum(axis=1)).ravel() - exact**2
	se = np.sqrt(var_factor * np.maximum(off2, 0.0) / n_probes)
	z = np.abs(est - exact) / np.maximum(se, 1e-30)
	frac3, zmax = float(np.mean(z > 3.0)), float(z.max())
	ok = frac3 <= 0.01 and zmax <= 6.0 and est.shape == exact.shape and bool(np.all(np.isfinite(est)))
	return {
		"check": name, "estimate": float(est.sum()), "reference": float(exact.sum()),
		"err": zmax, "tol": 6.0, "frac_past_3se": frac3, "ok": bool(ok),
	}


# -- operators and their closed forms ----------------------------------------


def laplacian_1d(n: int) -> sps.csr_matrix:
	"""Path-graph Laplacian + I: tridiag(-1, 3, -1)."""
	one = np.ones(n, np.float32)
	return sps.diags([-one[1:], 3.0 * one, -one[1:]], [-1, 0, 1], format="csr", dtype=np.float32)


def laplacian_1d_eigs(n: int) -> np.ndarray:
	k = np.arange(1, n + 1, dtype=np.float64)
	return 3.0 - 2.0 * np.cos(k * np.pi / (n + 1))


def dirichlet_modes(side: int) -> np.ndarray:
	"""Eigenvalues 2 − 2cos(iπ/(side+1)) of one grid dimension's second difference."""
	i = np.arange(1, side + 1, dtype=np.float64)
	return 2.0 - 2.0 * np.cos(i * np.pi / (side + 1))


def _device_peak(device=None):
	"""The device's peak bytes in use so far, or None where it keeps no stats."""
	import jax

	stats = (device or jax.devices()[0]).memory_stats()
	return int(stats["peak_bytes_in_use"]) if stats else None


# -- phases -------------------------------------------------------------------


def phase_a(n: int, probes: int) -> list:
	import jax.numpy as jnp

	import primate_tpu as pt
	from primate_tpu.operators.sparse import DIAOperator

	op = DIAOperator.from_scipy(laplacian_1d(n), dtype=jnp.float32)
	M = pt.MatrixFunction(op, fun="log", deg=20, orth=0, dtype=jnp.float32)
	est = pt.hutch(M, batch=probes, converge="count", count=probes, seed=42)
	return [check("slq_logdet", est, np.log(laplacian_1d_eigs(n)).sum(), 1e-2)]


def phase_b(side: int, probes: int, nt: int = 8) -> list:
	import jax.numpy as jnp

	import primate_tpu as pt
	from benchmarks.configs import _laplacian_2d
	from primate_tpu.operators.sparse import DIAOperator

	op = DIAOperator.from_scipy(_laplacian_2d(side), dtype=jnp.float32)
	mu = dirichlet_modes(side)

	def heat_trace(t):  # tr exp(-t A), A = I + L_x ⊕ L_y
		return np.exp(-t) * np.exp(-t * mu).sum() ** 2

	M = pt.MatrixFunction(op, fun="exp", t=-1.0, deg=20, orth=0, dtype=jnp.float32)
	est = pt.hutch(M, batch=probes, converge="count", count=probes, seed=3)
	out = [check("heat_trace_t1", est, heat_trace(1.0), 1e-2)]
	ts = np.geomspace(0.05, 4.0, nt)
	Mc = pt.MatrixFunction(op, fun=pt.stacked("exp", -ts), deg=20, orth=0, dtype=jnp.float32)
	curve = np.asarray(pt.hutch(Mc, batch=probes, converge="count", count=probes, seed=3))
	assert curve.shape == (nt,), curve.shape
	for t, c in zip(ts, curve):
		out.append(check(f"heat_curve_t{t:.3g}", c, heat_trace(t), 1e-2))
	return out


def phase_c(n: int, probes: int) -> list:
	import jax.numpy as jnp

	import primate_tpu as pt
	from benchmarks.matrices import powerlaw_laplacian
	from primate_tpu.operators.sparse import CSROperator

	A = powerlaw_laplacian(n, m=4, seed=0)
	op = CSROperator.from_scipy(A, dtype=jnp.float32)
	tr = float(A.diagonal().astype(np.float64).sum())
	out = [
		check("hutchpp_m192", pt.hutchpp(op, m=3 * probes, seed=1), tr, 1e-2, layout=_csr_layout(op)),
		check("xtrace_128", pt.xtrace(op, batch=32, converge="count", count=128, seed=2), tr, 1e-2),
	]
	iters = probes // 16
	d = pt.diag(op, converge="count", count=iters, batch=16, seed=3)
	out.append(check_diagonal("diag_64", d, A, probes, mean_of_ratios_factor(iters)))
	return out


def _csr_layout(op) -> str:
	return "ell" if op.ell_data is not None else ("sliced-ell" if op.sell is not None else "segment_sum")


def phase_d(n: int, probes: int) -> list:
	import jax.numpy as jnp

	import primate_tpu as pt
	from benchmarks.matrices import block_random_spd
	from primate_tpu.operators.sparse import BSROperator

	A = block_random_spd(n)
	op = BSROperator.from_scipy(A, blocksize=(8, 8), dtype=jnp.float32)
	exact = A.diagonal().astype(np.float64)
	d = np.asarray(pt.xdiag(op, m=4 * probes, seed=4), np.float64)
	# XDiag's error on a diagonally dominant matrix with a flat spectrum is
	# set by the whole matrix, not its off-diagonal part, so the Rademacher
	# per-entry rule does not apply. The reference is a plain numpy XDiag
	# (f64, its own probes, same m): the library must come within 1.5× of
	# its relative error.
	ref = xdiag_numpy(A.astype(np.float64), sphere_probes(n, 2 * probes, np.random.default_rng(0)))
	rel = float(np.linalg.norm(d - exact) / np.linalg.norm(exact))
	rel_ref = float(np.linalg.norm(ref - exact) / np.linalg.norm(exact))
	return [
		check("xdiag_m256_rel_l2", rel, rel_ref, 1.5, err=rel / rel_ref),
		check("xdiag_m256_sum", d.sum(), exact.sum(), 1e-2),
		check("xnystrace_m720", pt.xnystrace(op, m=720, seed=5), exact.sum(), 1e-2),
	]


def sphere_probes(n: int, m: int, rng) -> np.ndarray:
	"""``m`` Gaussian columns scaled to norm √n."""
	om = rng.standard_normal((n, m))
	return om * (np.sqrt(n) / np.linalg.norm(om, axis=0))


def xdiag_numpy(A, om: np.ndarray) -> np.ndarray:
	"""XDiag (Epperly, Tropp & Webber 2024, Alg. SM4.3) in plain numpy, on
	the probe block ``om`` (n × m/2; the estimator spends m matvecs)."""
	m = om.shape[1]
	Y = A @ om
	Q, R = np.linalg.qr(Y)
	Z = A.T @ Q
	T = Z.T @ om
	S = np.linalg.inv(R).T
	S /= np.linalg.norm(S, axis=0)
	rows = lambda X, W: np.sum(X * W, axis=1)  # noqa: E731
	QS = Q @ S
	return rows(Q, Z) + (-rows(QS, Z @ S) + rows(om, Y) - rows(om, Q @ T) + rows(om, QS * rows(S.T, T.T)[None, :])) / m


def phase_e(side: int, probes: int) -> list:
	import jax.numpy as jnp

	import primate_tpu as pt
	from benchmarks.matrices import fem_laplacian_3d
	from primate_tpu.kpm import ChebyshevFunction
	from primate_tpu.operators.sparse import DIAOperator

	op = DIAOperator.from_scipy(fem_laplacian_3d(side), dtype=jnp.float32)
	mu = dirichlet_modes(side)
	lam = 1.0 + (mu[:, None, None] + mu[None, :, None] + mu[None, None, :]).ravel()
	top = np.sort(lam)[::-1][:6]
	w = np.sort(np.asarray(pt.eigsh(op, k=6, which="LA", seed=6, return_eigenvectors=False), np.float64))[::-1]
	out = [check("eigsh_top6", w.sum(), top.sum(), 1e-4, err=float(np.max(np.abs(w - top) / top)), values=w.tolist())]
	C = ChebyshevFunction(op, "exp", deg=CHEB_DEG, damping="none", seed=7)
	est = pt.hutch(C, batch=probes, converge="count", count=probes, seed=8)
	out.append(check("chebyshev_exp_trace", est, np.exp(1.0) * np.exp(mu).sum() ** 3, 1e-2))
	return out


def phase_f(n: int) -> list:
	import jax.numpy as jnp

	import primate_tpu as pt

	A = np.asarray(pt.symmetric(n, pd=True, seed=9), np.float32)
	est = pt.xtrace(jnp.asarray(A), batch=256, seed=10)  # default stop: m == n
	return [check("xtrace_m_eq_n", est, np.trace(A.astype(np.float64)), 1e-4)]


def phase_g(n: int, probes: int) -> list:
	import jax
	import jax.numpy as jnp

	import primate_tpu as pt
	from primate_tpu.operators.sparse import DIAOperator

	op = DIAOperator.from_scipy(laplacian_1d(n), dtype=jnp.float32)
	main = op.offsets.index(0)

	def logdet_shifted(theta):
		bands = op.bands.at[main].add(theta)
		return pt.autodiff.logdet(DIAOperator(bands, op.offsets, op.shape), deg=20, orth=0, nv=probes, seed=11)

	g = jax.grad(logdet_shifted)(jnp.float32(0.0))
	return [check("grad_logdet_shift", g, (1.0 / laplacian_1d_eigs(n)).sum(), 1e-2)]


def phases(sizes: dict) -> dict:
	p = sizes["probes"]
	return {
		"A": lambda: phase_a(sizes["a_n"], p),
		"B": lambda: phase_b(sizes["b_side"], p),
		"C": lambda: phase_c(sizes["c_n"], p),
		"D": lambda: phase_d(sizes["d_n"], p),
		"E": lambda: phase_e(sizes["e_side"], p),
		"F": lambda: phase_f(sizes["f_n"]),
		"G": lambda: phase_g(sizes["a_n"], p),
	}


# -- four cards -----------------------------------------------------------------


def _spread(arr, ndev: int) -> bool:
	"""True when ``arr`` is laid out over ``ndev`` devices, one equal shard each."""
	shards = arr.addressable_shards
	return len(arr.sharding.device_set) == ndev and len({s.data.shape for s in shards}) == 1


def multi_checks(sizes: dict, devices: list) -> list:
	"""The sharded operators on ``devices`` (4), each against the same call on
	``devices[0]`` alone (same seed, so identical threefry probes) and against
	the exact value."""
	import jax
	import jax.numpy as jnp

	import primate_tpu as pt
	from benchmarks.matrices import block_random_spd, fem_laplacian_3d, powerlaw_laplacian
	from primate_tpu.operators.sparse import BSROperator, CSROperator, DIAOperator
	from primate_tpu.parallel import ShardedBSROperator, ShardedCSROperator, ShardedDIAOperator, make_mesh

	ndev, p = len(devices), sizes["probes"]
	mesh = make_mesh((ndev, 1), ("op", "probe"), devices=devices)
	out = []

	def pair(name, call, sharded, single, exact, tol, arr):
		spread = _spread(arr, ndev)
		got, ref = float(call(sharded)), float(call(single))
		out.append(check(f"{name}_vs_one_card", got, ref, 1e-4, devices_used=len(arr.sharding.device_set), spread=spread))
		out[-1]["ok"] &= spread
		out.append(check(f"{name}_vs_exact", got, exact, tol))

	def slq(op):  # phase A's call; two batches of 32 keep the one-card copy in memory
		M = pt.MatrixFunction(op, fun="log", deg=20, orth=0, dtype=jnp.float32)
		return pt.hutch(M, batch=p // 2, converge="count", count=p, seed=42)

	# 1. banded halo ppermute at 4 × 10M rows
	n = sizes["multi_dia_n"]
	dia = DIAOperator.from_scipy(laplacian_1d(n), dtype=jnp.float32)
	sh = ShardedDIAOperator.from_dia(dia, mesh)
	pair("dia_halo_slq", slq, sh, dia, np.log(laplacian_1d_eigs(n)).sum(), 1e-2, sh.bands)
	peaks = [_device_peak(d) for d in devices]
	if None not in peaks:  # every device held at least its shard of the probe block
		probe_shard = (p // 2) * (n // ndev) * 4
		out.append({"check": "per_device_peak_bytes", "estimate": float(min(peaks)), "reference": float(probe_shard),
			"err": 0.0, "tol": 0.0, "ok": min(peaks) >= probe_shard, "peaks": peaks})
	del dia, sh

	# 2. CSR: allgather on the power-law graph, halo on the 1-D Laplacian
	A = powerlaw_laplacian(sizes["c_n"], m=4, seed=0)
	csr = CSROperator.from_scipy(A, dtype=jnp.float32)
	sh = ShardedCSROperator.from_csr(A, mesh, comm="allgather", dtype=np.float32)
	assert sh.comm == "allgather"
	pair("csr_allgather_hutchpp", lambda op: pt.hutchpp(op, m=3 * p, seed=1), sh, csr, float(A.diagonal().sum()), 1e-2, sh.data)
	n = sizes["multi_n"]
	L = laplacian_1d(n)
	sh = ShardedCSROperator.from_csr(L, mesh, comm="halo", dtype=np.float32)
	assert sh.comm == "halo"
	pair("csr_halo_slq", slq, sh, CSROperator.from_scipy(L, dtype=jnp.float32), np.log(laplacian_1d_eigs(n)).sum(), 1e-2, sh.data)
	del A, csr, sh

	# 3. BSR: allgather on phase D's scattered blocks (its pattern is not
	# halo-eligible), halo on phase E's banded stencil
	A = block_random_spd(sizes["d_n"])
	bsr = BSROperator.from_scipy(A, blocksize=(8, 8), dtype=jnp.float32)
	sh = ShardedBSROperator.from_bsr(bsr, mesh, comm="auto")
	assert sh.comm == "allgather", sh.comm
	pair("bsr_allgather_xnystrace", lambda op: pt.xnystrace(op, m=720, seed=5), sh, bsr, float(A.diagonal().sum()), 1e-2, sh.blocks)
	side = sizes["e_side"]
	F = fem_laplacian_3d(side)
	bsr = BSROperator.from_scipy(F, blocksize=(8, 8), dtype=jnp.float32)
	sh = ShardedBSROperator.from_bsr(bsr, mesh, comm="halo")
	mu = dirichlet_modes(side)
	lam = 1.0 + (mu[:, None, None] + mu[None, :, None] + mu[None, None, :]).ravel()
	pair("bsr_halo_slq", slq, sh, bsr, np.log(lam).sum(), 1e-2, sh.blocks)
	del A, F, bsr, sh

	# 4. the (op × probe) = (2, 2) mesh
	if ndev == 4:
		mesh22 = make_mesh((2, 2), ("op", "probe"), devices=devices)
		dia = DIAOperator.from_scipy(L, dtype=jnp.float32)
		sh = ShardedDIAOperator.from_dia(dia, mesh22, probe_axis="probe")
		pair("dia_mesh2x2_slq", slq, sh, dia, np.log(laplacian_1d_eigs(n)).sum(), 1e-2, sh.bands)

	# 5. the gradient of the sharded logdet in a diagonal shift
	dia = DIAOperator.from_scipy(L, dtype=jnp.float32)
	sh = ShardedDIAOperator.from_dia(dia, mesh)
	main = dia.offsets.index(0)

	def grad_at(op):
		leaves, treedef = jax.tree_util.tree_flatten(op)
		e = jnp.zeros((leaves[0].shape[0], 1), leaves[0].dtype).at[main].set(1.0)

		def f(theta):
			shifted = jax.tree_util.tree_unflatten(treedef, [leaves[0] + theta * e] + leaves[1:])
			return pt.autodiff.logdet(shifted, deg=20, orth=0, nv=p, seed=11)

		return jax.grad(f)(jnp.float32(0.0))

	pair("grad_logdet", grad_at, sh, dia, (1.0 / laplacian_1d_eigs(n)).sum(), 1e-2, sh.bands)
	return out


# -- driver ------------------------------------------------------------------------


class _CompileClock:
	"""Seconds JAX spent tracing, lowering and compiling (its monitoring events)."""

	def __init__(self):
		import jax

		self.total = 0.0
		jax.monitoring.register_event_duration_secs_listener(self._on_event)

	def _on_event(self, event: str, duration: float, **_):
		if event.startswith("/jax/core/compile/"):
			self.total += duration


def run_phase(name: str, fn, clock: _CompileClock) -> bool:
	"""Run one phase, print its JSON line, return whether every check passed."""
	c0, t0 = clock.total, time.perf_counter()
	try:
		checks, error = fn(), None
	except Exception:
		checks, error = [], traceback.format_exc()
	wall = time.perf_counter() - t0
	ok = error is None and bool(checks) and all(c["ok"] for c in checks)
	rec = {"phase": name, "ok": ok, "wall_s": wall, "compile_s": clock.total - c0, "peak_bytes": _device_peak(), "checks": checks}
	if error:
		rec["error"] = error[-4000:]
	print(json.dumps(rec), flush=True)
	return ok


def main(argv=None) -> int:
	ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
	ap.add_argument("--multi", action="store_true", help="run only the sharded phase, on four GPUs")
	args = ap.parse_args(argv)

	import jax

	devices = jax.devices()
	if devices[0].platform != "gpu":
		print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform!r}", file=sys.stderr)
		return 2
	want = 4 if args.multi else 1
	if len(devices) < want:
		print(f"chip_smoke: needs {want} GPUs; JAX found {len(devices)}", file=sys.stderr)
		return 2
	devices = devices[:want]

	from benchmarks.cache import enable_compile_cache

	from primate_tpu import native

	smi = subprocess.run(
		["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
	).stdout.strip()
	print(json.dumps({
		"nvidia_smi": smi.splitlines(),
		"device_kind": devices[0].device_kind,
		"matmul_precision": str(jax.config.jax_default_matmul_precision),
		"jax": jax.__version__,
		"compile_cache": enable_compile_cache(),
		"native_sparse_prep": native.available(),
	}), flush=True)

	clock = _CompileClock()
	if args.multi:
		ok = run_phase("multi", lambda: multi_checks(FULL, devices), clock)
	else:
		ok = all([run_phase(name, fn, clock) for name, fn in phases(FULL).items()])
	if not ok:
		print("chip_smoke: a phase failed", file=sys.stderr)
		return 1
	print(smi)
	print(json.dumps({"ok": True, "device": {"platform": devices[0].platform, "kind": devices[0].device_kind, "count": len(devices)}}))
	return 0


if __name__ == "__main__":
	sys.exit(main())
