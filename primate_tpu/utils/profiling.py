"""Tracing / profiling / kernel cost reporting (SURVEY §5.1).

The reference buries microsecond matvec timers inside every C++ operator
(`eigen_operators.h:21-29`, `pylinop.h:20-39`) and never surfaces them. Here
profiling is first-class:

  * ``annotate`` — `jax.profiler` trace annotation + XLA ``named_scope`` so
    Lanczos sweeps / SpMM kernels show up by name in TensorBoard/xprof traces;
  * ``CountingOperator`` — eager matvec counter/timer wrapper (the reference's
    ``matvec_time``, actually surfaced). Under jit it counts **traces**, not
    executions — fused loops should read the iteration counter carried in the
    estimator state instead (``EstimatorResult.nit``);
  * ``kernel_stats`` / ``benchmark_matvec`` — the BASELINE.json metrics
    (nnz/s, matvecs/s, effective GB/s) for any operator.
"""

import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..operators.base import LinearOperator, aslinop

__all__ = ["annotate", "CountingOperator", "kernel_stats", "benchmark_matvec"]


@contextmanager
def annotate(name: str):
	"""Label a region for xprof/TensorBoard: host trace + XLA op names."""
	with jax.profiler.TraceAnnotation(name), jax.named_scope(name):
		yield


@jax.tree_util.register_pytree_node_class
class CountingOperator(LinearOperator):
	"""Wrap an operator to count matvec applications and accumulate wall time.

	Parity: the reference's per-operator ``matvec_time``/``n_matvecs``
	(`eigen_operators.h:21,113`) — surfaced as ``.n_matvecs`` /
	``.matvec_time`` (seconds). Eager-mode accounting; inside jit the counts
	reflect tracing, not execution.
	"""

	def __init__(self, A):
		self.A = aslinop(A)
		self.shape = self.A.shape
		self.dtype = self.A.dtype
		self.n_matvecs = 0
		self.matvec_time = 0.0

	def _matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		t0 = time.perf_counter()
		out = self.A.matmat(V)
		self.n_matvecs += int(V.shape[1]) if V.ndim == 2 else 1
		self.matvec_time += time.perf_counter() - t0
		return out

	def tree_flatten(self):
		return (self.A,), (self.shape, self.dtype)

	@classmethod
	def tree_unflatten(cls, aux, children):
		obj = object.__new__(cls)
		obj.A = children[0]
		obj.shape, obj.dtype = aux
		obj.n_matvecs, obj.matvec_time = 0, 0.0
		return obj


def kernel_stats(A) -> Dict[str, Any]:
	"""Static cost model of one matvec: nnz, flops, bytes moved."""
	op = A if isinstance(A, LinearOperator) else aslinop(A)
	n, m = op.shape
	itemsize = jnp.dtype(op.dtype).itemsize
	nnz = getattr(op, "nnz", None)
	if nnz is None:
		nnz = n * m if hasattr(op, "A") and isinstance(getattr(op, "A"), jnp.ndarray) else None
	stats = {"shape": op.shape, "dtype": str(op.dtype), "nnz": nnz}
	if nnz is not None:
		stats["flops_per_matvec"] = 2 * nnz
		stats["bytes_per_matvec"] = nnz * itemsize + 2 * n * itemsize
	return stats


def benchmark_matvec(A, k: int = 32, iters: int = 20, seed: int = 0, warmup: int = 2) -> Dict[str, float]:
	"""Measure SpMM throughput: the BASELINE.json north-star metrics.

	Chains ``iters`` dependent matmats inside ONE jitted program (so dispatch
	latency amortizes, like a real Lanczos sweep) and reports wall time per
	operator application plus derived nnz/s / matvecs/s / effective GB/s.
	"""
	op = A if isinstance(A, LinearOperator) else aslinop(A)
	n = op.shape[1]
	V = jax.random.normal(jax.random.PRNGKey(seed), (n, k), jnp.result_type(op.dtype, jnp.float32)).astype(op.dtype)

	@jax.jit
	def chain(V):
		def step(carry, _):
			out = op.matmat(carry)
			return out / jnp.linalg.norm(out, axis=0, keepdims=True), None

		out, _ = jax.lax.scan(step, V, None, length=iters)
		return jnp.sum(out)

	pull = lambda r: complex(jax.device_get(r))  # noqa: E731 — scalar pull forces completion; complex() accepts real AND complex scalars
	for _ in range(warmup):
		pull(chain(V))
	t0 = time.perf_counter()
	pull(chain(V))
	dt = (time.perf_counter() - t0) / iters

	out: Dict[str, float] = {"sec_per_matmat": dt, "matvecs_per_s": k / dt}
	stats = kernel_stats(op)
	if stats.get("nnz"):
		out["nnz_per_s"] = stats["nnz"] / dt
		out["effective_GBps"] = (stats["nnz"] + 2 * n * k) * jnp.dtype(op.dtype).itemsize / dt / 1e9
	return out
