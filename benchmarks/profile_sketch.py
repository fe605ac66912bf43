"""Micro-profile of sketch-estimator walls on the attached device.

Decomposes each estimator's warm wall into (host pre-dispatch, dispatch->pull)
to find host syncs that stall the device. Run: python -m benchmarks.profile_sketch
"""

import json
import time

import numpy as np
import scipy.sparse as sps
import jax
import jax.numpy as jnp

import primate_tpu as pt
from benchmarks.head_to_head import _spd_sparse


def _best(fn, reps=7):
	best = np.inf
	out = None
	for _ in range(reps):
		t0 = time.perf_counter()
		out = fn()
		best = min(best, time.perf_counter() - t0)
	return best, out


def main():
	print(f"backend: {jax.default_backend()}")
	A = _spd_sparse(4096, 8, 0)
	from primate_tpu.operators import CSROperator

	op = CSROperator.from_scipy(A, dtype=jnp.float32)
	true_tr = float(A.diagonal().sum())

	# RTT floor: device_get of a committed scalar
	x = jax.device_put(jnp.zeros(()))
	x.block_until_ready()
	t_rtt, _ = _best(lambda: jax.device_get(x))
	# dispatch+pull of a trivial jitted fn
	f = jax.jit(lambda v: v + 1)
	f(x).block_until_ready()
	t_disp, _ = _best(lambda: jax.device_get(f(x)))
	print(f"RTT floor (pull committed scalar): {t_rtt*1e3:.1f} ms; trivial dispatch+pull: {t_disp*1e3:.1f} ms")

	rows = {}
	for name, fn in [
		("xnystrace_m128", lambda: pt.xnystrace(op, m=128, seed=7)),
		("xdiag_m128", lambda: float(np.sum(pt.xdiag(op, m=128, seed=7)))),
		("xtrace_b32_c128", lambda: pt.xtrace(op, batch=32, converge="count", count=128, seed=7)),
		("hutchpp_m96", lambda: pt.hutchpp(op, m=96, seed=7)),
		("hutchpp_m240", lambda: pt.hutchpp(op, m=240, seed=7)),
		("diag_c8_b64", lambda: float(np.sum(np.asarray(pt.diag(op, converge="count", count=8, seed=11, batch=64))))),
	]:
		fn()  # warm/compile
		t, est = _best(fn)
		rows[name] = t
		print(f"{name:18s} {t*1e3:7.1f} ms  est={est:.2f}  (true {true_tr:.2f})  vs floor {t/t_disp:.2f}x")

	print(json.dumps({k: round(v * 1e3, 1) for k, v in rows.items()}))


if __name__ == "__main__":
	from benchmarks.cache import enable_compile_cache

	enable_compile_cache()
	main()
