"""Count-then-slice: interior eigenmodes of a 2-D mesh Laplacian.

The workflow the reference cannot do (it can only *count* eigenvalues in an
interval, `docs/src/table.qmd`): locate a spectral window stochastically, then
compute EVERY eigenpair inside it — matrix-free, GEMM-only — with
`filtered_eigsh` (Chebyshev-Jackson filtered subspace iteration).

The target: interior vibration modes of an ``nx × ny`` grid Laplacian near a
prescribed frequency — the "find the modes near the driving frequency"
problem of modal analysis, which shift-invert solves with a factorization
this operator (implicit, possibly sharded) does not have.

  1. `gershgorin_interval` — deterministic spectral enclosure (free, exact
     for a stencil).
  2. `recipes.eigencount` — stochastic count in the window (sizes the work).
  3. `filtered_eigsh` — the eigenpairs themselves.
  4. cross-checks: count vs found, residuals, and the window's heat-kernel
     trace vs the slice's direct sum.

Run: python examples/spectrum_slicing.py
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))  # repo-checkout runs

import numpy as np
import scipy.sparse as sps

import primate_tpu as pt
from primate_tpu.operators.prepare import gershgorin_interval
from primate_tpu.operators.sparse import DIAOperator


def grid_laplacian(nx: int, ny: int) -> sps.csr_matrix:
	"""5-point Laplacian of an nx × ny grid (Dirichlet), eigenvalues known:
	λ_{jk} = 4 sin²(jπ/2(nx+1)) + 4 sin²(kπ/2(ny+1))."""
	ex = np.ones(nx)
	ey = np.ones(ny)
	Tx = sps.diags([-ex[:-1], 2 * ex, -ex[:-1]], [-1, 0, 1])
	Ty = sps.diags([-ey[:-1], 2 * ey, -ey[:-1]], [-1, 0, 1])
	return (sps.kron(sps.identity(ny), Tx) + sps.kron(Ty, sps.identity(nx))).tocsr()


def main():
	nx, ny = 40, 25  # n = 1000
	A = grid_laplacian(nx, ny)
	op = DIAOperator.from_scipy(A)  # banded after kron ordering → stencil matvecs

	jx = np.arange(1, nx + 1)
	jy = np.arange(1, ny + 1)
	lam = (4 * np.sin(jx * np.pi / (2 * (nx + 1))) ** 2)[:, None] + (4 * np.sin(jy * np.pi / (2 * (ny + 1))) ** 2)[None, :]
	lam = np.sort(lam.ravel())

	lo, hi = gershgorin_interval(op)
	print(f"Gershgorin enclosure: [{lo:.3f}, {hi:.3f}] (true range [{lam[0]:.3f}, {lam[-1]:.3f}])")

	window = (3.0, 3.3)  # interior window, nowhere near either spectral edge
	true_inside = lam[(lam >= window[0]) & (lam <= window[1])]

	count = pt.recipes.eigencount(op, window, deg=40, converge="count", count=256, seed=0)
	print(f"eigencount{window}: {count} (true {len(true_inside)})")

	w, V = pt.filtered_eigsh(op, window, k=count, spectral_interval=(lo, hi), seed=1)
	resid = np.linalg.norm(A @ V - V * w[None, :], axis=0) if len(w) else np.zeros(0)
	print(f"filtered_eigsh: {len(w)} eigenpairs, max residual {resid.max() if len(w) else 0:.2e}")
	err = np.abs(np.sort(w) - true_inside).max() if len(w) == len(true_inside) else np.inf
	print(f"eigenvalue error vs closed form: {err:.2e}")

	# Consistency: Σ exp(−λᵢ) over the slice, two independent ways.
	direct = float(np.sum(np.exp(-w)))
	windowed = pt.recipes.weighted_trace(
		op, np.ones(op.shape[0]), fun=lambda x: _window_exp(x, window), deg=60, orth=-1,
		converge="count", count=512, seed=2,
	)
	print(f"slice heat mass: direct Σexp(−λ) = {direct:.4f}, stochastic windowed trace ≈ {float(windowed):.4f}")

	assert len(w) == len(true_inside) and err < 1e-3, "slice mismatch"  # f32 on accelerators
	print("OK")


def _window_exp(x, window):
	"""exp(−x) masked to the window by smoothsteps (for the stochastic check)."""
	import jax.numpy as jnp

	from primate_tpu.special import smoothstep

	a, b = window
	wdt = 0.02 * (b - a)
	rise = smoothstep(a=a - wdt, b=a + wdt)
	fall = smoothstep(a=b - wdt, b=b + wdt)
	return jnp.exp(-x) * (rise(x) - fall(x))


if __name__ == "__main__":
	main()
