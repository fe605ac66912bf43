"""primate_tpu — accelerator-native stochastic spectral estimation.

A from-scratch JAX/XLA framework with the capabilities of
`peekxc/primate` (probabilistic implicit matrix trace/diagonal estimation):

  * trace estimators: Girard-Hutchinson (`hutch`), Hutch++, XTrace
  * diagonal estimators: `diag`, XDiag
  * matrix-free block Lanczos tridiagonalization (`lanczos`, `rayleigh_ritz`)
  * Gaussian quadrature from Jacobi matrices (`quadrature`: Golub-Welsch, FTTR)
  * implicit matrix functions `f(A)` (`MatrixFunction`) for logdet, exp, inv,
    Schatten norms, numerical rank, heat-kernel signatures
  * composable adaptive stopping criteria evaluated **on-device**
  * sparse CSR/COO/BSR/DIA operators (XLA gather, ELL and stencil SpMM)
  * multi-chip scaling via `jax.sharding` row-partitioned operators

Everything in the compute path is jittable: estimators compile to a single
fused device program (`lax.while_loop` over batched Lanczos sweeps), probes
are batched into GEMM/SpMM, and randomness is stateless threefry.
"""

__version__ = "0.4.0"

from . import autodiff, kpm, operators, random, recipes, special, stats
from .bidiag import lanczos_bidiag
from .block_krylov import block_lanczos, block_quadrature, block_slq_trace
from .density import cumulative_spectral_density, spectral_density, spectral_quantile
from .diagonal import diag, diagpp, xdiag
from .eigen import eigsh, filtered_eigsh, rand_nystrom, rsvd, svds
from .estimators import (
	ConfidenceCriterion,
	ConfidenceEstimator,
	ControlVariableEstimator,
	ConvergenceCriterion,
	CountCriterion,
	EstimatorResult,
	KneeCriterion,
	MeanEstimator,
	ToleranceCriterion,
	convergence_criterion,
)
from .integrate import lanczos_quadrature, lobatto_rule, quadrature, radau_rule
from .kpm import ChebyshevFunction, kpm_density, kpm_trace, suggest_chebyshev_degree
from .lanczos import OrthogonalPolynomialBasis, lanczos, lanczos_block, rayleigh_ritz
from .operators import (
	MatrixFunction,
	Toeplitz,
	auto_operator,
	is_linear_op,
	is_valid_operator,
	matrix_function,
	normalize_unit,
)
from .random import haar, hermitian, isotropic, symmetric
from .autodiff import spectral_sum
from .solvers import NystromPreconditioner, cg, nystrom_precond, solve
from .special import param_callable, stacked
from .trace import hutch, hutchpp, xnystrace, xtrace
from .tridiag import eigh_tridiag, eigvalsh_tridiag

__all__ = [
	"ConfidenceCriterion",
	"ConfidenceEstimator",
	"ControlVariableEstimator",
	"ConvergenceCriterion",
	"ChebyshevFunction",
	"CountCriterion",
	"EstimatorResult",
	"KneeCriterion",
	"MatrixFunction",
	"MeanEstimator",
	"NystromPreconditioner",
	"ToleranceCriterion",
	"Toeplitz",
	"auto_operator",
	"cg",
	"convergence_criterion",
	"diag",
	"diagpp",
	"eigh_tridiag",
	"eigsh",
	"filtered_eigsh",
	"rand_nystrom",
	"rsvd",
	"eigvalsh_tridiag",
	"haar",
	"hermitian",
	"hutch",
	"hutchpp",
	"is_linear_op",
	"is_valid_operator",
	"isotropic",
	"kpm_density",
	"kpm_trace",
	"suggest_chebyshev_degree",
	"lanczos",
	"lanczos_block",
	"block_lanczos",
	"block_quadrature",
	"block_slq_trace",
	"lanczos_bidiag",
	"matrix_function",
	"normalize_unit",
	"nystrom_precond",
	"operators",
	"lobatto_rule",
	"lanczos_quadrature",
	"quadrature",
	"radau_rule",
	"random",
	"OrthogonalPolynomialBasis",
	"rayleigh_ritz",
	"solve",
	"special",
	"spectral_sum",
	"stacked",
	"param_callable",
	"stats",
	"svds",
	"symmetric",
	"trace",
	"xdiag",
	"xnystrace",
	"xtrace",
]


def get_include() -> str:
	"""Directory containing primate_tpu's native C headers (``sparse_prep.h``).

	Parity: reference ``primate.get_include()`` (`__init__.py:17-38`), which
	exposes its C++ operator headers to downstream extensions. Here the
	*compute* extension point is the operator protocol (any jittable callable);
	the header covers the host-side sparse-prep C ABI for external data
	loaders::

	    Extension('ext', ..., include_dirs=[primate_tpu.get_include()])
	"""
	import os

	return os.path.join(os.path.dirname(__file__), "native")
