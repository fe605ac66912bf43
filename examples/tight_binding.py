"""Spectral physics of a complex-Hermitian tight-binding Hamiltonian.

A magnetic-flux-threaded 2-D lattice (Hofstadter model) has a genuinely
complex Hermitian Hamiltonian: hopping terms carry Peierls phases
``e^{2πi·α·x}``, so neither the reference library (real-symmetric only) nor
any real-arithmetic path can touch it. This example computes — matrix-free,
on a sparse CSR operator —

  * the density of states by KPM (Jackson-damped Chebyshev) and by SLQ,
  * the partition function ``Z(β) = tr e^{−βH}`` over a temperature sweep
    (ONE Lanczos sweep for all β via `special.stacked`),
  * the local density of states diag(δ_σ(E − H)) at the band center,
  * unit-phase probes (`pdf="phase"`) vs real Rademacher variance.

Run: python examples/tight_binding.py
"""

import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parents[1]))  # repo-checkout runs

import numpy as np
import jax.numpy as jnp
import scipy.sparse as sps

import primate_tpu as pt
from primate_tpu.operators.sparse import CSROperator


def hofstadter_hamiltonian(nx: int, ny: int, alpha: float = 1.0 / 5.0) -> sps.csr_matrix:
	"""Square-lattice Hofstadter Hamiltonian with flux ``alpha`` per plaquette.

	Landau gauge: x-hops are real (−1); y-hops pick up ``−e^{2πi·α·x}``.
	Hermitian with genuinely complex off-diagonals whenever ``alpha ∉ ½ℤ``.
	"""
	n = nx * ny
	idx = lambda x, y: x * ny + y  # noqa: E731
	rows, cols, vals = [], [], []
	for x in range(nx):
		for y in range(ny):
			i = idx(x, y)
			j = idx((x + 1) % nx, y)  # x-hop (periodic)
			rows += [i, j]
			cols += [j, i]
			vals += [-1.0, -1.0]
			j = idx(x, (y + 1) % ny)  # y-hop with Peierls phase
			t = -np.exp(2j * np.pi * alpha * x)
			rows += [i, j]
			cols += [j, i]
			vals += [t, np.conj(t)]
	H = sps.csr_matrix((vals, (rows, cols)), shape=(n, n), dtype=np.complex128)
	assert abs(H - H.getH()).max() < 1e-12
	return H


def main():
	nx, ny, alpha = 40, 40, 1.0 / 5.0
	H = hofstadter_hamiltonian(nx, ny, alpha)
	op = CSROperator.from_scipy(H)
	n = op.shape[0]
	print(f"Hofstadter lattice {nx}x{ny} (n={n}, nnz={H.nnz}, flux α={alpha})")

	# --- density of states: the α=1/5 spectrum splits into 5 Hofstadter bands.
	ts, dos_kpm = pt.kpm_density(op, m=256, nv=32, pdf="phase", seed=0)
	_, dos_slq = pt.spectral_density(op, deg=64, nv=16, seed=1)
	# band/gap contrast from the KPM curve: count local minima below 20% of peak
	thresh = 0.2 * dos_kpm.max()
	in_gap = dos_kpm < thresh
	print(f"KPM DOS: {int(np.sum(np.diff(in_gap.astype(int)) == 1))} gap entries; "
		f"SLQ grid agrees on support [{ts.min():.2f}, {ts.max():.2f}]")

	# --- partition function over a β sweep — one Lanczos sweep for all β.
	betas = np.array([0.25, 0.5, 1.0, 2.0])
	logz = pt.recipes.heat_kernel_trace(op, t=betas, deg=48, seed=2, converge="count", count=64)
	print("Z(β) = tr e^{−βH}:", np.array2string(np.asarray(logz), precision=1))

	# --- local density of states at the band center (E = 0): a Gaussian
	# spectral window δ_σ(E − H) estimated entrywise with unit-phase probes.
	sigma = 0.1
	window = pt.ChebyshevFunction(
		op, fun=lambda x: jnp.exp(-(x**2) / (2 * sigma**2)) / (sigma * np.sqrt(2 * np.pi)), deg=256
	)
	ldos = pt.diag(window, pdf="phase", converge="count", count=192, seed=3)
	ldos = np.asarray(ldos)
	print(f"LDOS(E=0): mean {ldos.mean():.4f}, translation-flatness (std/mean) "
		f"{ldos.std() / max(ldos.mean(), 1e-12):.2f} (finite-probe noise; exact LDOS is x-periodic)")

	# --- probe-variance comparison: phase vs real rademacher on tr(e^{−H}).
	ests_p = [float(pt.hutch(pt.MatrixFunction(op, "exp", t=-1.0, deg=48), pdf="phase",
		converge="count", count=32, seed=s)) for s in range(8)]
	ests_r = [float(pt.hutch(pt.MatrixFunction(op, "exp", t=-1.0, deg=48), pdf="rademacher",
		converge="count", count=32, seed=s)) for s in range(8)]
	print(f"tr e^(-H) — phase probes: {np.mean(ests_p):.1f} ± {np.std(ests_p):.2f}, "
		f"rademacher: {np.mean(ests_r):.1f} ± {np.std(ests_r):.2f}")


if __name__ == "__main__":
	main()
