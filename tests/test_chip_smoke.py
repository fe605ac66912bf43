"""chip_smoke.py's phases at tiny sizes on the CPU, against the references the
GPU run uses, and its refusal to run without a GPU."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import scipy.sparse as sps

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

TINY = {
	"a_n": 20_000,
	"b_side": 200,
	"c_n": 5_000,
	"d_n": 1024,
	"e_side": 32,
	"f_n": 256,
	"multi_dia_n": 40_000,
	"multi_n": 4_000,
	"probes": 64,
}


@pytest.mark.parametrize("name", list("ACDEFG"))
def test_phase_passes_at_tiny_size(name):
	checks = cs.phases(TINY)[name]()
	assert checks and all(c["ok"] for c in checks), checks


def test_phase_b_heat_curve_at_tiny_size():
	"""Phase B with more probes: at 40k rows the t = 4 point's Hutchinson
	spread needs them to stay inside rel 1e-2."""
	checks = cs.phase_b(TINY["b_side"], probes=256)
	assert len(checks) == 9
	assert all(c["ok"] for c in checks), checks


def test_multi_checks_on_four_virtual_devices():
	checks = cs.multi_checks(TINY, jax.devices()[:4])
	names = {c["check"] for c in checks}
	for want in ("dia_halo_slq", "csr_allgather_hutchpp", "csr_halo_slq", "bsr_allgather_xnystrace", "bsr_halo_slq", "dia_mesh2x2_slq", "grad_logdet"):
		assert f"{want}_vs_one_card" in names and f"{want}_vs_exact" in names
	assert all(c["ok"] for c in checks), [c for c in checks if not c["ok"]]
	assert all(c["devices_used"] == 4 for c in checks if "devices_used" in c)


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_cpu(argv, capsys):
	assert cs.main(argv) == 2
	out = capsys.readouterr()
	assert out.out == "" and "needs a GPU" in out.err


def test_script_alone_fails(tmp_path):
	"""In a directory holding only chip_smoke.py it exits non-zero and prints
	no result line."""
	shutil.copy(REPO / "chip_smoke.py", tmp_path)
	r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=120,
		env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path)})
	assert r.returncode != 0
	assert '"ok": true' not in r.stdout


def test_bench_refuses_cpu(capsys):
	import importlib.util

	spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
	bench = importlib.util.module_from_spec(spec)
	spec.loader.exec_module(bench)
	assert bench.main() == 2
	assert "needs a GPU" in capsys.readouterr().err


def test_check_tolerance_and_relative_error():
	c = cs.check("x", 101.0, 100.0, 2e-2)
	assert c["ok"] and abs(c["err"] - 0.01) < 1e-12
	assert not cs.check("x", 103.0, 100.0, 2e-2)["ok"]
	assert not cs.check("x", float("nan"), 100.0, 2e-2)["ok"]


def test_check_diagonal_flags_an_outlier():
	A = sps.random(400, 400, density=0.05, random_state=0, format="csr")
	A = (A + A.T + sps.eye(400) * 5).tocsr()
	exact = A.diagonal()
	off2 = np.asarray(A.multiply(A).sum(axis=1)).ravel() - exact**2
	se = np.sqrt(off2 / 64)
	z = np.random.default_rng(1).standard_normal(400).clip(-2.5, 2.5)
	assert cs.check_diagonal("d", exact + z * se, A, 64)["ok"]
	bad = exact + z * se
	bad[7] = exact[7] + 7 * se[7]
	assert not cs.check_diagonal("d", bad, A, 64)["ok"]


def test_mean_of_ratios_factor_matches_simulation():
	"""The variance factor of diag's mean-of-running-ratios estimate."""
	assert cs.mean_of_ratios_factor(1) == 1.0
	rng = np.random.default_rng(0)
	T = 4
	x = rng.standard_normal((200_000, T))
	running = np.cumsum(x, axis=1) / np.arange(1, T + 1)
	sim = running.mean(axis=1).var() * T  # over the plain mean's variance 1/T
	assert abs(sim - cs.mean_of_ratios_factor(T)) < 0.02


def test_xdiag_numpy_matches_library_on_the_same_probes():
	"""The plain-numpy XDiag reference and the library's fused XDiag agree
	when both see the same probe block."""
	import jax.numpy as jnp

	import primate_tpu as pt
	from primate_tpu.diagonal import _xdiag_program
	from primate_tpu.random import as_key, sample_isotropic

	n, m = 60, 16
	A = np.asarray(sps.random(n, n, density=0.2, random_state=2).toarray())
	A = A + A.T + 5 * np.eye(n)
	key = as_key(3)
	om = np.asarray(sample_isotropic(key, (n, m), pdf="sphere", dtype=jnp.float64))
	got = np.asarray(_xdiag_program(pt.operators.aslinop(jnp.asarray(A)), key, n=n, m=m, pdf="sphere"))
	assert np.allclose(cs.xdiag_numpy(A, om), got, atol=1e-8)
	assert np.allclose(got, pt.xdiag(jnp.asarray(A), m=2 * m, seed=3), atol=1e-10)


def test_closed_forms_match_dense_eigenvalues():
	n = 50
	L = cs.laplacian_1d(n).toarray().astype(np.float64)
	assert np.allclose(np.sort(np.linalg.eigvalsh(L)), np.sort(cs.laplacian_1d_eigs(n)))
	from benchmarks.configs import _laplacian_2d

	side = 7
	mu = cs.dirichlet_modes(side)
	lam = 1.0 + (mu[:, None] + mu[None, :]).ravel()
	assert np.allclose(np.sort(np.linalg.eigvalsh(_laplacian_2d(side).toarray())), np.sort(lam), atol=1e-5)

