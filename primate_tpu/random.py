"""Isotropic probe generation and random test-matrix fixtures (device-native).

Parity: reference ``src/primate/random.py`` (isotropic / Isotropic / symmetric / haar).

Design notes (accelerator-first):
  * All randomness is **stateless threefry**: the jittable core is
    :func:`sample_isotropic`, which maps ``(key, shape) -> array`` and is safe to
    call inside `lax.while_loop` / `lax.scan` bodies (keys are folded per batch).
    This replaces the reference's per-thread spawned `np.random.Generator`s
    (`random.py:100-142`) — here probe generation happens on-device and is
    deterministic across shardings by construction.
  * Columns are the probe vectors (shape ``(n, nv)``), matching the reference's
    Fortran-ordered column convention, so probes feed straight into SpMM/GEMM.
  * ``sphere`` probes are scaled to norm ``sqrt(n)`` per column — the same
    normalization as the reference (`random.py:36-41`) so that
    ``E[v vᵀ] = I`` holds for all three distributions.
"""

from typing import Callable, Optional, Union

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
	"sample_isotropic",
	"isotropic",
	"Isotropic",
	"symmetric",
	"haar",
	"hermitian",
	"as_key",
	"real_dtype",
]


def real_dtype(dtype) -> jnp.dtype:
	"""Real counterpart of a floating dtype (``complex64 → float32`` etc.).

	Probes for complex-Hermitian operators are sampled REAL (unbiased:
	``E[vvᵀ] = I`` and ``v†Av ∈ ℝ``), and estimator state stays real — this is
	the single dtype rule shared by every estimator's Hermitian path.
	"""
	dt = jnp.dtype(dtype)
	return jnp.dtype(np.finfo(dt).dtype) if dt.kind == "c" else dt

_ISO_DISTRIBUTIONS = {
	"rademacher": "rademacher",
	"normal": "normal",
	"sphere": "sphere",
	"signs": "rademacher",
	"gaussian": "normal",
	"phase": "phase",  # complex unit phases e^{iθ} — Hermitian operators only
}


def as_key(seed: Union[int, np.random.Generator, jax.Array, None] = None) -> jax.Array:
	"""Coerce a seed-like object into a JAX PRNG key.

	Accepts an int, an existing JAX key, a numpy Generator (an int is drawn from
	it, so `seed=np.random.default_rng(1234)` behaves reproducibly), or None
	(fresh OS entropy).
	"""
	if isinstance(seed, jax.Array) and jnp.issubdtype(seed.dtype, jax.dtypes.prng_key):
		return seed
	if isinstance(seed, (jax.Array, np.ndarray)) and seed.dtype == jnp.uint32 and seed.shape == (2,):
		# Legacy raw PRNGKey (jax.random.PRNGKey): wrap into a typed key.
		return jax.random.wrap_key_data(jnp.asarray(seed))

	def _mk():
		if seed is None:
			return jax.random.key(np.random.SeedSequence().generate_state(1)[0].item())
		if isinstance(seed, np.random.Generator):
			return jax.random.key(int(seed.integers(0, 2**63 - 1)))
		if isinstance(seed, np.random.SeedSequence):
			return jax.random.key(seed.generate_state(1)[0].item())
		return jax.random.key(int(seed))

	try:
		# Build the key on the LOCAL CPU backend: `jax.random.key` is an eager
		# op, and running it on the accelerator costs a dispatch and a sync
		# before the estimator's own dispatch. A host-resident key ships with
		# the dispatch arguments instead (one transfer total).
		with jax.default_device(jax.local_devices(backend="cpu")[0]):
			return _mk()
	except RuntimeError:  # no cpu backend registered (exotic configs)
		return _mk()


def classify_pdf(pdf) -> str:
	"""Classify a ``pdf`` argument: "string" | "key" | "size".

	The reference accepts callables everywhere a distribution name is allowed
	(`trace.py:34`, its closures are numpy-style ``pdf(size=...)``). Here two
	callable conventions are supported:

	  * "key"  — jax-traceable ``(key, shape, dtype) -> array``; rides inside
	    the fused device programs via :func:`sample_isotropic`.
	  * "size" — numpy-style ``pdf(size=...)`` (typically stateful, e.g. a
	    closure over a Generator); estimators that support it sample on host
	    in their host-stepped loop, exactly like the reference's hot loop.
	"""
	if isinstance(pdf, str):
		return "string"
	assert callable(pdf), f"pdf must be a distribution name or a callable; got {type(pdf)}"
	import inspect

	try:
		params = inspect.signature(pdf).parameters
	except (TypeError, ValueError):
		# Uninspectable callables (C-implemented, some wrappers) are in practice
		# numpy-style samplers from migrating reference users — jax-style
		# samplers are ordinary Python functions whose signatures inspect fine.
		# "size" also fails loudly at the call site if the guess is wrong,
		# instead of a TypeError from deep inside a fused program.
		return "size"
	return "size" if "size" in params else "key"


def sample_isotropic(
	key: jax.Array,
	shape: Union[int, tuple],
	pdf: str = "rademacher",
	dtype: Optional[jnp.dtype] = None,
) -> jnp.ndarray:
	"""Draw isotropic random vectors (columns) — pure and jittable.

	Parameters:
		key: JAX PRNG key.
		shape: output shape; an int ``n`` is promoted to ``(n, 1)``.
		pdf: one of "rademacher"/"signs", "normal"/"gaussian", "sphere".
		dtype: element type (defaults to the canonical float dtype).

	Returns:
		Array of the given shape whose columns satisfy ``E[v vᵀ] = I``.
	"""
	if callable(pdf):
		# Custom jax-traceable sampler ``(key, shape, dtype) -> array`` — the
		# stateless analog of the reference's callable pdfs (`trace.py:34`).
		# Isotropy (E[vvᵀ] = I) is the caller's contract, as upstream.
		shape = (shape, 1) if isinstance(shape, int) else tuple(shape)
		dtype = dtype or jnp.asarray(0.0).dtype
		out = jnp.asarray(pdf(key, shape, dtype))
		assert out.shape == shape, f"custom pdf returned shape {out.shape}, expected {shape}"
		return out
	assert pdf in _ISO_DISTRIBUTIONS, f"Invalid distribution '{pdf}' supplied."
	pdf = _ISO_DISTRIBUTIONS[pdf]
	shape = (shape, 1) if isinstance(shape, int) else tuple(shape)
	dtype = dtype or jnp.asarray(0.0).dtype
	if pdf == "phase":
		# Uniform unit phases (the complex rademacher analog): E[v v†] = I and
		# every |v_i| = 1, so the Girard variance sees Σ_{i≠j}|A_ij|² — smaller
		# than real-rademacher's 2·Σ Re(A_ij)² whenever off-diagonals are
		# predominantly real. Hermitian (complex-dtype) operators only.
		assert jnp.dtype(dtype).kind == "c", "pdf='phase' needs a complex dtype (Hermitian operators)."
		theta = jax.random.uniform(key, shape, dtype=real_dtype(dtype), minval=0.0, maxval=2.0 * np.pi)
		return jnp.exp(1j * theta).astype(dtype)
	if pdf == "rademacher":
		return jax.random.rademacher(key, shape, dtype=dtype)
	W = jax.random.normal(key, shape, dtype=dtype)
	if pdf == "sphere":
		# Uniform on the sphere of radius sqrt(n); columns are the vectors.
		# |W|² (not W·W) so complex draws normalize by the true norm — W·W is a
		# complex number whose sqrt would rescale AND phase-rotate the column,
		# breaking E[vv†] = I. Identical on the real path.
		c = jnp.sqrt(jnp.sum(jnp.abs(W) ** 2, axis=0, keepdims=True))
		W = W * (jnp.sqrt(W.shape[0]) / c).astype(dtype)
	return W


class Isotropic:
	"""Stateful isotropic sampler (host-facing convenience).

	Each call to :meth:`__call__` advances an internal counter and folds it into
	the base key, so successive calls yield independent (but reproducible)
	batches. The jittable core is :func:`sample_isotropic`; use that (with
	explicitly managed keys) inside device loops.

	Replaces the reference's thread-pool RNG filler (`random.py:100-142`) — on
	the device, parallel generation is the default.
	"""

	def __init__(
		self,
		size: Optional[tuple] = None,
		pdf: str = "rademacher",
		seed: Union[int, np.random.Generator, jax.Array, None] = None,
		dtype: Optional[jnp.dtype] = None,
		threads: Optional[int] = None,
	):
		# `threads` is accepted for drop-in parity with the reference's
		# ThreadPoolExecutor column filler (`random.py:100-142`) and ignored:
		# generation here is one vectorized on-device program.
		del threads
		assert pdf in _ISO_DISTRIBUTIONS, f"Invalid distribution '{pdf}' supplied."
		self.pdf = _ISO_DISTRIBUTIONS[pdf]
		self.key = as_key(seed)
		self.dtype = dtype
		self.shape = size
		self._counter = 0

	def __call__(self, size: Union[int, tuple, None] = None) -> jnp.ndarray:
		size = size if size is not None else self.shape
		assert size is not None, "A sample shape must be provided."
		shape = (size, 1) if isinstance(size, int) else tuple(size)
		if len(shape) > 2:
			subkey = jax.random.fold_in(self.key, self._counter)
			self._counter += 1
			return sample_isotropic(subkey, shape, pdf=self.pdf, dtype=self.dtype)
		# Column-keyed streams: column c of any draw uses fold_in(key, counter+c),
		# and the counter advances by the number of columns — so 150 sequential
		# single-column draws replay one (n, 150) batched draw exactly (the
		# reference's stream-order guarantee, `tests/test_random.py:23-40`).
		n = shape[0]
		ncols = shape[1] if len(shape) == 2 else 1
		base = self._counter
		self._counter += ncols
		keys = jax.vmap(lambda c: jax.random.fold_in(self.key, c))(jnp.arange(base, base + ncols))
		cols = jax.vmap(lambda k: sample_isotropic(k, (n, 1), pdf=self.pdf, dtype=self.dtype))(keys)
		out = jnp.moveaxis(cols[..., 0], 0, -1)  # (n, ncols)
		return out[:, 0] if len(shape) == 1 else out

	def fill(self) -> jnp.ndarray:
		"""Sample an array of the configured shape (API parity with the reference)."""
		self.values = self(self.shape)
		return self.values


def isotropic(
	size: Union[int, tuple, None] = None,
	pdf: str = "rademacher",
	seed: Union[int, np.random.Generator, jax.Array, None] = None,
	out: Optional[np.ndarray] = None,
) -> Union[None, jnp.ndarray, Callable]:
	"""Generate random vectors from an isotropic distribution.

	If ``out`` is given, it is filled in place and None is returned (reference
	`random.py:67-70`). Otherwise, if ``size`` is None, returns a stateful
	sampler ``f(size) -> array``; else returns an array of shape ``size`` (an
	int is promoted to ``(size, 1)``).

	Parity: reference `random.py:47-97`.
	"""
	sampler = Isotropic(pdf=pdf, seed=seed)
	if out is not None:
		assert isinstance(out, np.ndarray), "`out` must be a preallocated numpy array."
		out[...] = np.asarray(sampler(out.shape), dtype=out.dtype)
		return None

	def _isotropic(size: Union[int, tuple]) -> jnp.ndarray:
		return sampler(size)

	return _isotropic if size is None else _isotropic(size)


def symmetric(
	n: int,
	dist: str = "normal",
	pd: bool = False,
	ew: Optional[np.ndarray] = None,
	seed: Union[int, np.random.Generator, jax.Array, None] = None,
	dtype: Optional[jnp.dtype] = None,
) -> jnp.ndarray:
	"""Random symmetric ``n x n`` matrix with prescribed eigenvalues ``ew``.

	The orthogonal change-of-basis is drawn by QR-factorizing a random Gaussian
	matrix. If ``ew`` is None, eigenvalues are uniform in ``[0, 1]`` (``pd=True``)
	or ``[-1, 1]``. Parity: reference `random.py:145-180` (test fixture — ground
	truth for trace/diagonal/eigenvalue assertions is exact by construction).
	"""
	key = as_key(seed)
	k_m, k_ew = jax.random.split(key)
	dtype = dtype or jnp.asarray(0.0).dtype
	if dist == "uniform":
		M = jax.random.uniform(k_m, (n, n), dtype=dtype)
	elif dist == "normal":
		M = jax.random.normal(k_m, (n, n), dtype=dtype)
	else:
		raise ValueError(f"Invalid distribution {dist} supplied")
	Q, _ = jnp.linalg.qr(M)
	if ew is None:
		ew = jax.random.uniform(k_ew, (n,), dtype=dtype, minval=0.0 if pd else -1.0, maxval=1.0)
	ew = jnp.atleast_1d(jnp.asarray(ew, dtype=dtype))
	A = (Q * ew[None, :]) @ Q.T
	return (A + A.T) / 2


def hermitian(
	n: int,
	pd: bool = False,
	ew: Optional[np.ndarray] = None,
	seed: Union[int, np.random.Generator, jax.Array, None] = None,
	dtype: Optional[jnp.dtype] = None,
) -> jnp.ndarray:
	"""Random complex Hermitian ``n x n`` matrix with prescribed eigenvalues.

	The unitary change-of-basis is the QR factor of a complex Gaussian matrix;
	eigenvalues are REAL (uniform in ``[0, 1]`` for ``pd=True``, else
	``[-1, 1]``, or prescribed via ``ew``). Complex analog of
	:func:`symmetric` — ground truth for the Hermitian estimator paths
	(quantum/tight-binding operators are this class; the reference is
	real-symmetric only, `random.py:145-180`).
	"""
	key = as_key(seed)
	k_re, k_im, k_ew = jax.random.split(key, 3)
	dtype = jnp.dtype(dtype or (jnp.complex128 if jnp.asarray(0.0).dtype == jnp.float64 else jnp.complex64))
	r_dtype = np.finfo(dtype).dtype
	M = jax.random.normal(k_re, (n, n), dtype=r_dtype) + 1j * jax.random.normal(k_im, (n, n), dtype=r_dtype)
	Q, _ = jnp.linalg.qr(M.astype(dtype))
	if ew is None:
		ew = jax.random.uniform(k_ew, (n,), dtype=r_dtype, minval=0.0 if pd else -1.0, maxval=1.0)
	ew = jnp.atleast_1d(jnp.asarray(ew, dtype=r_dtype))
	A = (Q * ew[None, :].astype(dtype)) @ jnp.conj(Q).T
	return (A + jnp.conj(A).T) / 2


def haar(
	n: int,
	ew: Optional[np.ndarray] = None,
	seed: Union[int, np.random.Generator, jax.Array, None] = None,
	dtype: Optional[jnp.dtype] = None,
) -> jnp.ndarray:
	"""Random matrix with prescribed eigenvalues via a Haar-distributed basis.

	Samples ``U`` uniformly from the orthogonal group O(n) (QR of a Gaussian
	matrix with the sign correction of Mezzadri 2006) and returns
	``U diag(ew) Uᵀ``. Parity: reference `random.py:183-201`.
	"""
	key = as_key(seed)
	k_m, k_ew = jax.random.split(key)
	dtype = dtype or jnp.asarray(0.0).dtype
	M = jax.random.normal(k_m, (n, n), dtype=dtype)
	Q, R = jnp.linalg.qr(M)
	# Sign correction makes the QR-sampled Q exactly Haar-distributed.
	d = jnp.sign(jnp.diagonal(R))
	U = Q * jnp.where(d == 0, 1.0, d)[None, :]
	if ew is None:
		ew = jax.random.uniform(k_ew, (n,), dtype=dtype, minval=-1.0, maxval=1.0)
	ew = jnp.atleast_1d(jnp.asarray(ew, dtype=dtype))
	ev = jnp.zeros(n, dtype=dtype).at[: ew.shape[0]].set(ew)
	return (U * ev[None, :]) @ U.T
