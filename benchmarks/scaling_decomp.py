"""Decompose the emulated sharded-SLQ overhead.

The round-4 paired scaling table put weak-8dev overhead efficiency at 0.60:
40% of the single-core emulated wall is program structure added by sharding.
This harness splits that 40% into its candidate terms by timing ABLATED
variants of the same fused program (each child pinned like benchmarks.scaling):

  full      — the real sharded program (halo ppermute + concat + stencil)
  nocomm    — ppermute replaced by same-shape zeros (isolates the collective)
  nohalo    — no halo at all: boundary-zero stencil on the local block only
              (isolates the halo-concat data path; mathematically wrong at
              the 2·moff partition boundary rows, timing-only)
  chunk     — the plain single-device program on one partition's rows, ×ndev
              (the paired reference the efficiency is measured against)

Run: ``python -m benchmarks.scaling_decomp [--ndev 8] [--rows-per-dev 65536]``
Each variant runs in the same child process, interleaved per rep, so co-tenant
noise cancels within the paired ratios (same design as benchmarks.scaling).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

DEG, PROBES = 16, 32
REPS = int(os.environ.get("SCALING_REPS", "10"))
CPUSET = os.environ.get("SCALING_CPUSET", "0")

_CHILD = r"""
import json, os, sys, time
import numpy as np
ndev, n_rows, reps = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ndev}"
import jax
jax.config.update("jax_platforms", "cpu")
import scipy.sparse as sps, jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P
import primate_tpu as pt
from primate_tpu.operators.sparse import DIAOperator
from primate_tpu.parallel import make_mesh, shard_operator
from primate_tpu.parallel.sharded import ShardedDIAOperator

DEG, PROBES = %d, %d

def lap(n):
    return sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1])

def slq(op):
    M = pt.MatrixFunction(op, fun="log", deg=DEG, orth=0, dtype=jnp.float32)
    return lambda: pt.hutch(M, batch=PROBES, converge="count", count=PROBES, seed=3)

mesh = make_mesh((ndev, 1), ("op", "probe"))
base = DIAOperator.from_scipy(lap(n_rows), dtype=jnp.float32)
op_full = shard_operator(base, mesh)

@jax.tree_util.register_pytree_node_class
class NoCommDIA(ShardedDIAOperator):
    # ppermute -> zeros of the same shape: same data path minus the collective
    def matmat_t(self, Vt):
        n = self.shape[0]; ndev_ = self.mesh.shape[self.op_axis]
        n_pad = self.bands.shape[1]; n_loc = n_pad // ndev_
        moff = max((abs(o) for o in self.offsets), default=0)
        offsets = self.offsets; op_ax = self.op_axis
        def shard_fn(bands_loc, Vl):
            acc = jnp.promote_types(bands_loc.dtype, jnp.float32)
            tail = jnp.zeros_like(Vl[:, -moff:]); head = jnp.zeros_like(Vl[:, :moff])
            V_ext = jnp.concatenate([tail, Vl, head], axis=1)
            out = jnp.zeros((Vl.shape[0], n_loc), acc)
            for d, off in enumerate(offsets):
                out = out + bands_loc[d, None, :].astype(acc) * V_ext[:, moff + off : moff + off + n_loc]
            return out.astype(bands_loc.dtype)
        Vp = jnp.pad(Vt, ((0, 0), (0, n_pad - Vt.shape[1]))) if Vt.shape[1] != n_pad else Vt
        out = jax.shard_map(shard_fn, mesh=self.mesh,
                            in_specs=(P(None, op_ax), P(None, op_ax)), out_specs=P(None, op_ax))(self.bands, Vp)
        return out[:, :n]
    def _matmat(self, V):
        return self.matmat_t(V.T).T

@jax.tree_util.register_pytree_node_class
class NoHaloDIA(ShardedDIAOperator):
    # boundary-zero local stencil: no ppermute, no concat (slice+pad fuses)
    def matmat_t(self, Vt):
        n = self.shape[0]; ndev_ = self.mesh.shape[self.op_axis]
        n_pad = self.bands.shape[1]; n_loc = n_pad // ndev_
        offsets = self.offsets; op_ax = self.op_axis
        def shard_fn(bands_loc, Vl):
            acc = jnp.promote_types(bands_loc.dtype, jnp.float32)
            out = jnp.zeros((Vl.shape[0], n_loc), acc)
            for d, off in enumerate(offsets):
                b = bands_loc[d, None, :].astype(acc)
                if off == 0:
                    out = out + b * Vl
                elif off > 0:
                    out = out + b * jnp.pad(Vl[:, off:], ((0, 0), (0, off)))
                else:
                    out = out + b * jnp.pad(Vl[:, :off], ((0, 0), (-off, 0)))
            return out.astype(bands_loc.dtype)
        Vp = jnp.pad(Vt, ((0, 0), (0, n_pad - Vt.shape[1]))) if Vt.shape[1] != n_pad else Vt
        out = jax.shard_map(shard_fn, mesh=self.mesh,
                            in_specs=(P(None, op_ax), P(None, op_ax)), out_specs=P(None, op_ax))(self.bands, Vp)
        return out[:, :n]
    def _matmat(self, V):
        return self.matmat_t(V.T).T

op_nocomm = NoCommDIA(op_full.bands, op_full.offsets, op_full.shape, mesh, "op", "probe")
op_nohalo = NoHaloDIA(op_full.bands, op_full.offsets, op_full.shape, mesh, "op", "probe")
chunk = DIAOperator.from_scipy(lap(n_rows // ndev), dtype=jnp.float32)

runs = {"full": slq(op_full), "nocomm": slq(op_nocomm), "nohalo": slq(op_nohalo), "chunk": slq(chunk)}
for f in runs.values():
    f(); f()  # compile + warm
walls = {k: [] for k in runs}
for _ in range(reps):
    for k, f in runs.items():
        t0 = time.perf_counter(); f(); walls[k].append(time.perf_counter() - t0)
med = {k: float(np.median(v)) for k, v in walls.items()}
out = {"ndev": ndev, "rows": n_rows, "reps": reps,
       "wall_med_s": {k: round(v, 4) for k, v in med.items()},
       "serial_pred_s": round(ndev * med["chunk"], 4),
       "eff_full": round(ndev * med["chunk"] / med["full"], 3),
       "eff_nocomm": round(ndev * med["chunk"] / med["nocomm"], 3),
       "eff_nohalo": round(ndev * med["chunk"] / med["nohalo"], 3),
       "collective_share": round((med["full"] - med["nocomm"]) / med["full"], 3),
       "halo_datapath_share": round((med["nocomm"] - med["nohalo"]) / med["full"], 3),
       "partition_residual_share": round((med["nohalo"] - ndev * med["chunk"]) / med["full"], 3)}
print(json.dumps(out))
""" % (DEG, PROBES)


def main() -> None:
	ap = argparse.ArgumentParser()
	ap.add_argument("--ndev", type=int, default=8)
	ap.add_argument("--rows-per-dev", type=int, default=65_536)
	args = ap.parse_args()
	pin = ["taskset", "-c", CPUSET] if shutil.which("taskset") else []
	r = subprocess.run(
		pin + [sys.executable, "-c", _CHILD, str(args.ndev), str(args.ndev * args.rows_per_dev), str(REPS)],
		capture_output=True, text=True, timeout=3600,
	)
	sys.stderr.write(r.stderr[-2000:] if r.returncode else "")
	print(r.stdout.strip().splitlines()[-1] if r.stdout.strip() else json.dumps({"error": r.returncode}))


if __name__ == "__main__":
	from benchmarks.cache import enable_compile_cache

	enable_compile_cache()
	main()
