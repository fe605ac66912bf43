"""Multi-process (multi-host analog) distributed estimation.

Spawns 2 OS processes that join via ``jax.distributed.initialize`` (the path
several hosts would take), build a 4-device global mesh (2 processes × 2 virtual
CPU devices), row-partition a banded Laplacian across it, and run the fused
``hutch`` program — validating collectives across the process boundary and
that every process computes the identical estimate.
"""

import socket
import subprocess
import sys
from pathlib import Path

import pytest

_WORKER = r"""
import os, sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc and jax.device_count() == 2 * nproc

import numpy as np, scipy.sparse as sps, jax.numpy as jnp
import primate_tpu as pt
from primate_tpu.operators.sparse import DIAOperator
from primate_tpu.parallel import make_mesh, shard_operator
from jax.experimental import multihost_utils

n = 64
L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1])
mesh = make_mesh((jax.device_count(), 1), ("op", "probe"))
op = shard_operator(DIAOperator.from_scipy(L), mesh)
V = np.random.default_rng(0).normal(size=(n, 4))
out = op.matmat(jnp.asarray(V))
got = np.asarray(multihost_utils.process_allgather(out, tiled=True))
assert np.abs(got - L @ V).max() < 1e-4  # f32
est = pt.hutch(op, seed=1, converge="count", count=256)
assert abs(est - 3.0 * n) < 15
print(f"RESULT {est:.10f}", flush=True)
"""


def _free_port() -> int:
	with socket.socket() as s:
		s.bind(("localhost", 0))
		return s.getsockname()[1]


def test_two_process_distributed_hutch(tmp_path):
	worker = tmp_path / "worker.py"
	worker.write_text(_WORKER)
	port = _free_port()
	repo = str(Path(__file__).resolve().parent.parent)
	procs = [
		subprocess.Popen(
			[sys.executable, str(worker), str(i), "2", str(port)],
			stdout=subprocess.PIPE,
			stderr=subprocess.PIPE,
			text=True,
			env={**__import__("os").environ, "PYTHONPATH": repo},
		)
		for i in range(2)
	]
	outs = []
	for p in procs:
		out, err = p.communicate(timeout=220)
		assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
		outs.append(out)
	results = [line.split()[1] for o in outs for line in o.splitlines() if line.startswith("RESULT")]
	assert len(results) == 2
	assert results[0] == results[1], "processes disagree on the estimate"
