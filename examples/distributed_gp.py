"""Distributed differentiable GP-style training: sharded operator + jax.grad.

The capability stack this library exists for, end to end on a device mesh:

  * a structured kernel operator row-partitioned across the ``op`` mesh axis
    (halo ``ppermute`` exchange — interconnect traffic O(bandwidth), not O(n));
  * the SLQ logdet as a `custom_vjp` (`primate_tpu.autodiff`): forward = the
    fused Lanczos-quadrature sweep over shared Rademacher probes, backward =
    tr(K⁻¹∂K) via distributed CG **through the same halo exchange**, with the
    cotangent landing on each chip's local block leaves;
  * one `jax.jit(value_and_grad(...))` training step — compile once, run for
    every optimizer iteration.

Here the "hyperparameter" is a global scale on a banded precision-matrix
kernel K(s) = s·L + I (an intentionally simple parameterization so the exact
gradient is known in closed form and printed for comparison:
d/ds logdet(sL + I) = tr((sL + I)⁻¹ L)).

Run (8 emulated devices):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/distributed_gp.py
On a multi-GPU host the SAME program runs with the mesh over the cards.
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))

import numpy as np
import scipy.sparse as sps
import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu.autodiff import logdet
from primate_tpu.parallel import make_mesh, shard_operator


def main():
	n_dev = len(jax.devices())
	n_probe = 2 if (n_dev % 2 == 0 and n_dev >= 4) else 1
	mesh = make_mesh((n_dev // n_probe, n_probe), ("op", "probe"))
	n = mesh.shape["op"] * 128  # 128 rows per chip (tiny demo shapes)

	# Banded SPD "precision matrix" L (+I later): path-graph Laplacian.
	off = -np.ones(n - 1, np.float32)
	L = sps.diags([off, 2.0 * np.ones(n, np.float32), off], [-1, 0, 1]).tocsr()
	Lop = shard_operator(L, mesh, probe_axis="probe", comm="halo", blocksize=(8, 8))
	children, treedef = jax.tree_util.tree_flatten(Lop)
	# Identity expressed on L's OWN sparsity pattern, so its sharded block
	# layout is identical to L's and the two block arrays add directly.
	E = L.copy()
	E.data[:] = 0.0
	E.setdiag(1.0)
	eye_blocks = jax.tree_util.tree_leaves(
		shard_operator(E.tocsr(), mesh, probe_axis="probe", comm="halo", blocksize=(8, 8))
	)[0]

	def K_of(s):
		"""K(s) = s·L + I as a sharded operator (same pattern, scaled blocks)."""
		blocks = s * children[0] + eye_blocks
		return jax.tree_util.tree_unflatten(treedef, [blocks] + children[1:])

	# Synthetic data drawn from the TRUE model K(s*) = s*·L + I, s* = 3.
	s_true = 3.0
	rng = np.random.default_rng(0)
	K_true = (s_true * L + sps.eye(n)).toarray()
	y = jnp.asarray(np.linalg.cholesky(K_true) @ rng.normal(size=n), jnp.float32)

	def nll(theta, key):
		"""-2·log p(y | s=e^θ): SLQ logdet + distributed-CG quadratic term."""
		K = K_of(jnp.exp(theta))
		ld = logdet(K, deg=16, orth=8, nv=32, seed=key)
		alpha = pt.solve(K, y, rtol=1e-6)
		return 0.5 * (ld + y @ alpha)

	step = jax.jit(jax.value_and_grad(nll))

	def exact_nll_grad(theta):
		s = float(np.exp(theta))
		Kd = (s * L + sps.eye(n)).toarray()
		Ki_y = np.linalg.solve(Kd, np.asarray(y))
		dK = L.toarray()
		g_s = 0.5 * (np.trace(np.linalg.solve(Kd, dK)) - Ki_y @ dK @ Ki_y)
		return g_s * s  # chain rule through s = e^θ

	theta = jnp.asarray(0.0)  # s₀ = 1
	key = jax.random.key(0)
	print(f"mesh {dict(mesh.shape)}  n={n}  (maximize p(y | s·L + I); true s* = {s_true})")
	for it in range(25):
		val, g = step(theta, jax.random.fold_in(key, it))
		theta = theta - 0.002 * g
		if it % 4 == 0:
			print(f"  it {it:2d}: s={float(jnp.exp(theta)):.3f}  nll={float(val):9.3f}  "
				f"grad={float(g):8.3f}  exact={exact_nll_grad(float(theta)):8.3f}")
	s_fit = float(jnp.exp(theta))
	print(f"fitted s = {s_fit:.3f} (true {s_true}) on a {n_dev}-device mesh")
	print("(per-step gradients near the optimum are probe-noise dominated — the")
	print(" documented estimator-gradient caveat; resampled probes average it out)")
	assert abs(s_fit - s_true) / s_true < 0.2, s_fit


if __name__ == "__main__":
	main()
