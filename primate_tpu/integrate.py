"""Gaussian quadrature rules from Jacobi (tridiagonal) matrices.

Parity: reference ``src/primate/integrate.py`` (`quadrature` with Golub-Welsch
and FTTR weight computation).

Accelerator-first: both methods are batched over a leading probe axis — the Lanczos
sweep produces nv Jacobi matrices at once, and the nodes/weights for all of
them come from one batched `jnp.linalg.eigh` (Golub-Welsch) or one vmapped
recurrence scan (FTTR). Everything is jittable, so stochastic Lanczos
quadrature traces as a single device program.
"""

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .fttr import fttr_weights
from .tridiag import eigh_tridiag, eigvalsh_tridiag

__all__ = ["quadrature", "lanczos_quadrature", "radau_rule", "lobatto_rule", "spectral_quad_form", "spectral_density"]


def spectral_density(*args, **kwargs):
	"""Alias for :func:`primate_tpu.density.spectral_density`.

	The reference plans this import location (commented
	``from .integrate import spectral_density, quadrature`` in its
	``__init__.py``); the implementation lives in `density.py`.
	"""
	from .density import spectral_density as _sd

	return _sd(*args, **kwargs)


@partial(jax.custom_jvp, nondiff_argnums=(2,))
def spectral_quad_form(d: jnp.ndarray, e: jnp.ndarray, fun: Callable) -> jnp.ndarray:
	"""``e₁ᵀ f(J(d, e)) e₁ = Σᵢ f(θᵢ) τᵢ`` with a degeneracy-stable derivative.

	Differentiating the Golub-Welsch rule naively goes through eigenvector
	derivatives, whose ``1/(θᵢ−θⱼ)`` terms produce NaN/∞ gradients the moment
	Ritz values cluster — routine for smooth kernels. This primitive's JVP is
	the Daleckii–Krein Fréchet derivative instead:

		d[e₁ᵀ f(J) e₁] = y₀ᵀ (L ∘ YᵀdJ Y) y₀,  L_ij = f[θᵢ, θⱼ]

	with the divided difference L_ij → f'(θᵢ) as θⱼ → θᵢ — finite for any
	clustering. Linear in the tangents, so reverse-mode transposes through it
	automatically (SLQ losses get stable gradients).

	``d (..., k)``, ``e (..., k-1)`` batched; returns ``(...,)``.
	"""
	theta, Y = eigh_tridiag(d, e)
	return jnp.sum(fun(theta) * Y[..., 0, :] ** 2, axis=-1)


@spectral_quad_form.defjvp
def _spectral_quad_form_jvp(fun, primals, tangents):
	d, e = primals
	dd, de = tangents
	theta, Y = eigh_tridiag(d, e)
	y0 = Y[..., 0, :]
	f_theta = fun(theta)
	val = jnp.sum(f_theta * y0**2, axis=-1)

	# Elementwise f' via forward-mode on the (vector-valued) spectral function.
	fp = jax.jvp(fun, (theta,), (jnp.ones_like(theta),))[1]
	diff = theta[..., :, None] - theta[..., None, :]
	fdiff = f_theta[..., :, None] - f_theta[..., None, :]
	scale = jnp.maximum(jnp.max(jnp.abs(theta), axis=-1, keepdims=True)[..., None], 1.0)
	near = jnp.abs(diff) <= 1e-7 * scale
	L = jnp.where(near, 0.5 * (fp[..., :, None] + fp[..., None, :]), fdiff / jnp.where(near, 1.0, diff))

	# (dJ Y) for tridiagonal dJ: rows get dd_k·Y_k + de_k·Y_{k+1} + de_{k-1}·Y_{k-1}.
	pad = jnp.zeros(de.shape[:-1] + (1,), de.dtype)
	lo = jnp.concatenate([de, pad], axis=-1)[..., :, None]  # de_k (k < deg-1)
	hi = jnp.concatenate([pad, de], axis=-1)[..., :, None]  # de_{k-1} (k > 0)
	Y_down = jnp.concatenate([Y[..., 1:, :], jnp.zeros_like(Y[..., :1, :])], axis=-2)
	Y_up = jnp.concatenate([jnp.zeros_like(Y[..., :1, :]), Y[..., :-1, :]], axis=-2)
	dJY = dd[..., :, None] * Y + lo * Y_down + hi * Y_up
	M = jnp.einsum("...ki,...kj->...ij", Y, dJY)
	tangent = jnp.einsum("...i,...ij,...j->...", y0, L * M, y0)
	return val, tangent


def _solve_shifted(d: jnp.ndarray, e: jnp.ndarray, rhs_last: jnp.ndarray, shift) -> jnp.ndarray:
	"""Solve ``(J(d, e) − shift·I) x = rhs_last · e_k`` batched; returns ``x_k``.

	The Jacobi matrices are tiny (deg ≲ 100) and arrive in probe batches, so a
	dense batched solve is the device-natural route (same reasoning as the
	densify+eigh tridiagonal eigensolver in `tridiag.py`).
	"""
	from .tridiag import tridiag_matrix

	J = tridiag_matrix(d, e)
	k = d.shape[-1]
	A = J - shift * jnp.eye(k, dtype=J.dtype)
	rhs = jnp.zeros(d.shape[:-1] + (k, 1), J.dtype).at[..., -1, 0].set(rhs_last)
	x_k = jnp.linalg.solve(A, rhs)[..., -1, 0]
	# Deflated probes zero-pad their Jacobi coefficients, so J gains exact-zero
	# eigenvalues and a shift at (or numerically on) one of them makes the
	# solve singular — the NaN would otherwise poison EVERY node of the
	# modified rule (NaN·0 = NaN survives a zero quadrature weight). δ = 0
	# degrades gracefully: the modified corner becomes d̂ = x0, i.e. x0 is
	# (approximately) a node of the plain extended rule.
	return jnp.where(jnp.isfinite(x_k), x_k, 0.0)


def radau_rule(
	d: jnp.ndarray, e: jnp.ndarray, beta_end: jnp.ndarray, x0
) -> Tuple[jnp.ndarray, jnp.ndarray]:
	r"""Gauss–Radau rule with one node fixed at ``x0`` (Golub 1973).

	Given the Jacobi matrix ``J_k(d, e)`` of a ``k``-step Lanczos sweep and the
	*next* coupling ``beta_end = β_k`` (the final residual norm the sweep
	already produces — `lanczos_block` returns it as ``betas[-1]``), the
	(k+1)-point rule comes from the extended Jacobi matrix with modified corner

		d̂_{k+1} = x0 + δ_k,   (J_k − x0·I) δ = β_k² e_k,

	whose Gauss rule has a node *exactly* at ``x0`` (Golub & Meurant,
	*Matrices, Moments and Quadrature*, §6.2). With ``x0`` outside the spectrum
	the remaining nodes stay inside, and for integrands with sign-definite
	derivatives the rule brackets the true integral from the side opposite to
	the plain Gauss rule — see :func:`primate_tpu.recipes.trace_bounds`.

	``d (..., k)``, ``e (..., k-1)``, ``beta_end (...,)`` batched; returns
	``(nodes, weights)`` of shape ``(..., k+1)``. Jittable/differentiable.
	"""
	d, e, beta_end = jnp.asarray(d), jnp.asarray(e), jnp.asarray(beta_end)
	x0 = jnp.asarray(x0, d.dtype)
	delta_k = _solve_shifted(d, e, beta_end**2, x0)
	d_ext = jnp.concatenate([d, (x0 + delta_k)[..., None]], axis=-1)
	e_ext = jnp.concatenate([e, beta_end[..., None]], axis=-1)
	theta, Y = eigh_tridiag(d_ext, e_ext)
	return theta, Y[..., 0, :] ** 2


def lobatto_rule(
	d: jnp.ndarray, e: jnp.ndarray, beta_end: jnp.ndarray, x0, x1
) -> Tuple[jnp.ndarray, jnp.ndarray]:
	r"""Gauss–Lobatto rule with nodes fixed at both ``x0 < x1`` (Golub 1973).

	Extends ``J_k(d, e)`` by one row/column whose corner ``d̂_{k+1}`` and
	coupling ``β̂_k`` solve the 2×2 system built from

		(J_k − x0·I) δ = e_k,   (J_k − x1·I) μ = e_k,
		d̂ = (x1·δ_k − x0·μ_k)/(δ_k − μ_k),   β̂² = (x1 − x0)/(δ_k − μ_k),

	placing nodes exactly at both prescribed endpoints (Golub & Meurant §6.3).
	``beta_end`` is accepted for signature symmetry with :func:`radau_rule`
	but unused — the Lobatto coupling is *derived*, not measured. Batched like
	:func:`radau_rule`; returns ``(nodes, weights)`` of shape ``(..., k+1)``.
	"""
	d, e = jnp.asarray(d), jnp.asarray(e)
	del beta_end
	x0 = jnp.asarray(x0, d.dtype)
	x1 = jnp.asarray(x1, d.dtype)
	ones = jnp.ones(d.shape[:-1], d.dtype)
	delta_k = _solve_shifted(d, e, ones, x0)  # > 0 when x0 < λmin (J − x0·I PD)
	mu_k = _solve_shifted(d, e, ones, x1)  # < 0 when x1 > λmax
	denom = delta_k - mu_k
	safe = jnp.where(denom == 0, 1.0, denom)
	d_hat = (x1 * delta_k - x0 * mu_k) / safe
	beta2 = (x1 - x0) / safe
	d_ext = jnp.concatenate([d, d_hat[..., None]], axis=-1)
	e_ext = jnp.concatenate([e, jnp.sqrt(jnp.maximum(beta2, 0.0))[..., None]], axis=-1)
	theta, Y = eigh_tridiag(d_ext, e_ext)
	return theta, Y[..., 0, :] ** 2


def quadrature(
	d: jnp.ndarray,
	e: jnp.ndarray,
	deg: Optional[int] = None,
	quad: str = "gw",
	nodes: Optional[jnp.ndarray] = None,
	weights: Optional[jnp.ndarray] = None,
	**kwargs,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
	r"""Degree-``deg`` Gaussian quadrature rule of the Jacobi matrix ``J(d, e)``.

	Nodes are the eigenvalues of ``J``; weights are the squared first components
	of its normalized eigenvectors (Golub-Welsch, ``quad="gw"``) or come from the
	forward three-term recurrence (``quad="fttr"``, O(1) space, not backward
	stable — see reference `integrate.py:50-55` for the tradeoff).

	``d (..., n)`` and ``e`` (length n with leading ≈0, or n-1) may carry batch
	axes; the rule is computed for every batch element on-device.

	The optional ``nodes``/``weights`` output arrays of the reference API are
	accepted for parity but, JAX arrays being immutable, the filled copies are
	returned rather than written in place.
	"""
	d, e = jnp.asarray(d), jnp.asarray(e)
	n = d.shape[-1]
	deg = n if deg is None else int(min(deg, n))
	# Normalize to the leading-zero convention used by the reference.
	if e.shape[-1] == n - 1:
		pad = jnp.zeros(e.shape[:-1] + (1,), e.dtype)
		e = jnp.concatenate([pad, e], axis=-1)
	assert e.shape[-1] == n, "Subdiagonal must have length n or n-1"

	if quad in {"gw", "golub_welsch"}:
		theta, ev = eigh_tridiag(d[..., :deg], e[..., :deg], **kwargs)
		tau = ev[..., 0, :] ** 2
	elif quad == "fttr":
		# Truncate the Jacobi matrix BEFORE solving (as the gw branch does):
		# the degree-deg rule comes from the leading deg×deg submatrix, and
		# nodes/weights must share its length.
		theta = eigvalsh_tridiag(d[..., :deg], e[..., :deg], **kwargs)
		tau = fttr_weights(theta, d[..., :deg], e[..., :deg], k=deg)
	else:
		raise ValueError(f"Invalid quadrature method '{quad}' supplied")

	if nodes is not None and weights is not None:
		# Partial fill into larger preallocated outputs (reference semantics:
		# only the first deg entries are written) — a full-array .set would
		# demand broadcast-equal shapes and crash.
		k = theta.shape[-1]
		nodes = jnp.asarray(nodes).at[..., :k].set(theta)
		weights = jnp.asarray(weights).at[..., :k].set(tau)
		return nodes, weights
	return theta, tau


# Drop-in alias: the reference documents this entry point as
# ``quadrature.lanczos_quadrature`` (docs/src/reference/lanczos_quadrature.qmd)
# with the identical (d, e, deg, quad, nodes, weights) signature.
lanczos_quadrature = quadrature
