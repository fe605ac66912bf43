"""Scaling-efficiency harness: sharded SLQ over growing device counts.

BASELINE.json's north star asks for ≥80% scaling efficiency at 1 chip /
1 host / N ≥ 2 hosts. Real multi-chip hardware is not attached to this
environment, so this harness measures the SAME fused sharded program the pod
would run on **emulated meshes** (clearly labeled as such):

  * single-process, ``--xla_force_host_platform_device_count=N`` virtual CPU
    devices for N ∈ {1, 2, 4, 8} — validates the shard_map/collective
    structure and measures the collective+partition overhead the program adds
    as the mesh grows;
  * 2 OS processes joined via ``jax.distributed.initialize`` (the DCN path on
    a real pod) with 2 virtual devices each — the cross-process collective
    overhead measurement.

Measurement design:

  * **Every measured child is pinned to a fixed CPU set** (``taskset``;
    ``SCALING_CPUSET``, default core 0). Round 3 ran unpinned on 4 shared
    cores and recorded overhead efficiencies of 1.33-1.50 — unphysical,
    because N shard_map partitions can saturate idle cores better than one
    fused single-device program, so "overhead" was confounded with
    parallel-speedup luck. On ONE core, the sharded program runs the same
    total flops plus partition/collective work: efficiency is structurally
    ≤ ~1 and measures exactly the overhead it claims to.
  * **Median of ``SCALING_REPS`` (default 10) timed reps** after a warm-up,
    all inside one child process (one compile), with the interquartile spread
    reported per cell. Cells whose spread exceeds 10% are flagged noisy.
  * The meaningful emulated metric is **overhead efficiency**: single-device
    median wall for the same TOTAL work divided by the sharded median wall
    (1.0 = the sharded program adds no partition/collective cost). On a real
    pod, per-device compute divides by N while the collective structure
    measured here is unchanged (ICI inside a slice, DCN across hosts).
  * The 2-process DCN row is compared against the single-process 2-device
    run under the SAME total resources (each side gets two cores: the two
    processes one core each, the reference both), so the ratio isolates the
    gRPC/DCN layer instead of mixing in a resource change.

CAVEAT (printed with every table): virtual devices share host CPU cores, so
wall times do NOT show real-hardware speedups; only the overhead ratios are
meaningful, and ICI latencies are absent. Run:
``python -m benchmarks.scaling`` (writes a table + JSON lines to stdout).
Each (mode, ndev) cell runs in a fresh subprocess so the forced device count
is set before jax initializes.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

ROWS_PER_DEV = 65_536  # weak scaling: constant rows per device
STRONG_ROWS = 262_144  # strong scaling: fixed total problem
DEG = 16
PROBES = 32
REPS = int(os.environ.get("SCALING_REPS", "10"))
CPUSET = os.environ.get("SCALING_CPUSET", "0")  # single core: see module docstring
NOISY_SPREAD = 0.10  # IQR/median above this flags the cell as noisy

_CHILD = r"""
import json, os, sys, time
import numpy as np
ndev = int(sys.argv[1])
n_rows = int(sys.argv[2])
reps = int(sys.argv[3])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ndev}"
import jax
jax.config.update("jax_platforms", "cpu")
import scipy.sparse as sps, jax.numpy as jnp
import primate_tpu as pt
from primate_tpu.operators.sparse import DIAOperator
from primate_tpu.parallel import make_mesh, shard_operator

DEG, PROBES = %d, %d


def lap(n):
    return sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1])


def slq(op):
    M = pt.MatrixFunction(op, fun="log", deg=DEG, orth=0, dtype=jnp.float32)
    return lambda: pt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=3)

# Sharded program on the full problem.
op = DIAOperator.from_scipy(lap(n_rows), dtype=jnp.float32)
if ndev > 1:
    mesh = make_mesh((ndev, 1), ("op", "probe"))
    op = shard_operator(op, mesh)
run_sharded = slq(op)

# Serial reference IN THE SAME PROCESS: one partition-sized chunk on a plain
# (unsharded) operator — predicted zero-overhead serial wall = ndev x chunk.
chunk = n_rows // ndev
run_chunk = slq(DIAOperator.from_scipy(lap(chunk), dtype=jnp.float32))

est = float(run_sharded()); run_sharded()  # compile + 2 warm reps
run_chunk(); run_chunk()
k = np.arange(1, n_rows + 1)
exact = float(np.sum(np.log(3.0 - 2.0 * np.cos(k * np.pi / (n_rows + 1)))))

# Interleaved, PAIRED reps: each rep times the sharded program and the chunk
# back to back, so slow co-tenant windows hit both sides of the ratio.
sh, ch = [], []
for _ in range(reps):
    t0 = time.perf_counter(); run_sharded(); sh.append(time.perf_counter() - t0)
    t0 = time.perf_counter(); run_chunk(); ch.append(time.perf_counter() - t0)
sh, ch = np.asarray(sh), np.asarray(ch)
eff = ndev * ch / sh  # per-rep paired overhead efficiency
q25, med, q75 = (float(np.percentile(sh, q)) for q in (25, 50, 75))
e25, emed, e75 = (float(np.percentile(eff, q)) for q in (25, 50, 75))
print(json.dumps({"ndev": ndev, "rows": n_rows, "wall_s": round(med, 4),
                  "q25_s": round(q25, 4), "q75_s": round(q75, 4),
                  "min_s": round(float(sh.min()), 4), "max_s": round(float(sh.max()), 4),
                  "serial_pred_min_s": round(ndev * float(ch.min()), 4),
                  "overhead_efficiency": round(emed, 3),
                  "eff_iqr": [round(e25, 3), round(e75, 3)],
                  "reps": reps, "spread": round((q75 - q25) / med, 4),
                  "rel_err": round(abs(est - exact) / abs(exact), 6)}))
""" % (DEG, PROBES)

_CHILD_2PROC = r"""
import json, os, sys, time
import numpy as np
pid, port, n_rows, reps = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid)
import scipy.sparse as sps, jax.numpy as jnp
import primate_tpu as pt
from primate_tpu.operators.sparse import DIAOperator
from primate_tpu.parallel import make_mesh, shard_operator

DEG, PROBES = %d, %d
L = sps.diags([-np.ones(n_rows - 1), 3.0 * np.ones(n_rows), -np.ones(n_rows - 1)], [-1, 0, 1])
mesh = make_mesh((jax.device_count(), 1), ("op", "probe"))
op = shard_operator(DIAOperator.from_scipy(L, dtype=jnp.float32), mesh)
M = pt.MatrixFunction(op, fun="log", deg=DEG, orth=0, dtype=jnp.float32)
run = lambda: pt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=3)
run(); run()
walls = []
for _ in range(reps):
    t0 = time.perf_counter(); run(); walls.append(time.perf_counter() - t0)
walls = np.asarray(walls)
q25, med, q75 = (float(np.percentile(walls, q)) for q in (25, 50, 75))
if pid == 0:
    print(json.dumps({"ndev": 2, "processes": 2, "rows": n_rows, "wall_s": round(med, 4),
                      "q25_s": round(q25, 4), "q75_s": round(q75, 4), "reps": reps,
                      "min_s": round(float(walls.min()), 4),
                      "spread": round((q75 - q25) / med, 4)}), flush=True)
""" % (DEG, PROBES)


def _pin(cpuset: str) -> list:
	"""``taskset`` prefix pinning a child to a fixed CPU set (no-op if absent)."""
	return ["taskset", "-c", cpuset] if shutil.which("taskset") else []


def _run_child(ndev: int, rows: int, timeout: float = 1800.0, cpuset: str = CPUSET) -> dict:
	r = subprocess.run(
		_pin(cpuset) + [sys.executable, "-c", _CHILD, str(ndev), str(rows), str(REPS)],
		capture_output=True,
		text=True,
		timeout=timeout,
		cwd=str(Path(__file__).resolve().parent.parent),
	)
	assert r.returncode == 0, r.stderr[-2000:]
	return json.loads(r.stdout.strip().splitlines()[-1])


def _free_port() -> int:
	with socket.socket() as s:
		s.bind(("localhost", 0))
		return s.getsockname()[1]


def _two_proc_cpusets() -> tuple:
	"""One core per process — disjoint, and jointly equal to the 2-core set the
	single-process reference gets."""
	cores = sorted(os.sched_getaffinity(0))
	if len(cores) >= 2:
		return str(cores[0]), str(cores[1]), f"{cores[0]},{cores[1]}"
	c = str(cores[0])
	return c, c, c


def _run_two_process(rows: int, timeout: float = 1800.0) -> dict:
	port = str(_free_port())
	cwd = str(Path(__file__).resolve().parent.parent)
	cpu0, cpu1, _ = _two_proc_cpusets()
	procs = [
		subprocess.Popen(
			_pin(cpu) + [sys.executable, "-c", _CHILD_2PROC, str(i), port, str(rows), str(REPS)],
			stdout=subprocess.PIPE,
			stderr=subprocess.PIPE,
			text=True,
			cwd=cwd,
		)
		for i, cpu in ((0, cpu0), (1, cpu1))
	]
	try:
		outs = [p.communicate(timeout=timeout) for p in procs]
	except Exception:
		# One child hung (port race / distributed-init stall): kill BOTH, or
		# they keep running pinned to the measurement cores and holding the
		# coordinator port, polluting every later pinned cell.
		for p in procs:
			if p.poll() is None:
				p.kill()
				p.wait()
		raise
	assert all(p.returncode == 0 for p in procs), outs[0][1][-1500:] + outs[1][1][-1500:]
	return json.loads(outs[0][0].strip().splitlines()[-1])


def main() -> None:
	print(f"# Scaling harness — EMULATED meshes, children pinned to CPU set [{CPUSET}] "
		f"(taskset {'available' if shutil.which('taskset') else 'MISSING — unpinned!'}), "
		f"median of {REPS} PAIRED reps with IQR.")
	print("# 'overhead efficiency' = median over paired reps of [ndev x chunk wall] / [sharded wall]",
		"— chunk = the same partition-sized problem on one device, timed back to back with the",
		"sharded program in the same process, so co-tenant noise and cache effects cancel.")
	results = {"weak": [], "strong": []}

	# Weak scaling: rows grow with the mesh (constant per-device chunk).
	for ndev in (1, 2, 4, 8):
		r = _run_child(ndev, ROWS_PER_DEV * ndev)
		r["noisy"] = bool(r["spread"] > NOISY_SPREAD)
		results["weak"].append(r)
		print(json.dumps({"mode": "weak", **r}), flush=True)

	# Strong scaling: fixed total rows, shrinking per-device chunk.
	for ndev in (1, 2, 4, 8):
		r = _run_child(ndev, STRONG_ROWS)
		r["noisy"] = bool(r["spread"] > NOISY_SPREAD)
		results["strong"].append(r)
		print(json.dumps({"mode": "strong", **r}), flush=True)

	# 2-process DCN-emulated path vs single-process 2-device on the SAME two
	# cores (equal resources, equal device count: the ratio isolates the
	# gRPC/DCN layer).
	try:
		_, _, both = _two_proc_cpusets()
		ref2 = _run_child(2, STRONG_ROWS, cpuset=both)
		two = _run_two_process(STRONG_ROWS)
		print(json.dumps({
			"mode": "2-process-dcn", **two,
			"ref_1proc_2dev_min_s": ref2["min_s"],
			"overhead_efficiency": round(ref2["min_s"] / two["min_s"], 3),
			"eff_median": round(ref2["wall_s"] / two["wall_s"], 3),
			"noisy": bool(max(ref2["spread"], two["spread"]) > NOISY_SPREAD),
		}), flush=True)
	except Exception as e:  # the 2-proc path needs free ports + distributed service
		print(json.dumps({"mode": "2-process-dcn", "error": str(e)[:200]}), flush=True)


if __name__ == "__main__":
	from benchmarks.cache import enable_compile_cache

	enable_compile_cache()
	main()
