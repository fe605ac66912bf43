"""Extremal eigenpairs of implicit symmetric operators (`eigsh`).

Beyond-reference capability: the reference leans on scipy/ARPACK (`eigsh` in
`operators.py:186-193` for `normalize_unit`) — a host-serial shift-invert
Lanczos behind an FFI boundary. The device-native replacement is **blocked
LOBPCG**: all k Ritz vectors advance together, every iteration is three block
GEMMs plus a (3k x 3k) dense eigensolve — exactly the GEMM-shaped work an
accelerator wants (`jax.experimental.sparse.linalg.lobpcg_standard`).

`which` handling uses spectral shifts instead of shift-INVERT (no
factorizations exist for implicit operators):

  * "LA"  — largest algebraic: LOBPCG directly.
  * "SA"  — smallest algebraic: largest of ``c I − A`` with ``c`` an upper
    spectral bound (cheap Rayleigh-Ritz estimate, inflated), mapped back.
  * "LM"  — largest magnitude: both ends, keep the k largest ``|λ|``.
  * "BE"  — both ends: ⌈k/2⌉ from each side (scipy semantics).
"""

from typing import Callable, Optional, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .operators import aslinop

__all__ = ["eigsh", "filtered_eigsh", "rand_nystrom", "rsvd", "svds"]


def _lobpcg_top(matmat: Callable, n: int, k: int, dtype, key, maxiter: int, tol) -> Tuple[jnp.ndarray, jnp.ndarray]:
	from jax.experimental.sparse.linalg import lobpcg_standard

	X0 = jax.random.normal(key, (n, k), dtype=dtype)
	# ``tol`` is a relative residual, as in `_trlan_top`. lobpcg_standard
	# stops at ‖r‖ < tol'·10n·(‖Av‖ + θ) ≈ tol'·20n·θ, a bound that grows with
	# n: at its default tol' = eps, a 262k-row f32 problem "converges" after
	# one iteration. Dividing by 20n makes the stop independent of n.
	tol = float(np.sqrt(jnp.finfo(dtype).eps)) if tol is None else float(tol)
	theta, U, _ = lobpcg_standard(matmat, X0, m=maxiter, tol=tol / (20 * n))
	return theta, U


def _trlan_cycle(matmat, V, lam, s, ell, key, *, m: int, keep: int):
	"""One thick-restart cycle: extend the basis to ``m`` Lanczos vectors,
	eigendecompose the projected matrix, compress back to ``keep`` Ritz pairs.

	State (all shapes static; ``ell`` is a traced scalar so first and restart
	cycles share ONE compiled program):
	  V    (n, m+1) — cols [0, ell) kept Ritz vectors, col ell the next start
	  lam  (m,)     — kept Ritz values (zero-padded)
	  s    (m,)     — residual couplings: A·V_i = λ_i·V_i + s_i·v_ell
	"""
	n = V.shape[0]
	dtype = V.dtype
	eps = jnp.finfo(dtype).eps
	idx = jnp.arange(m + 1)
	kept = (idx[:m] < ell).astype(dtype)
	# Projected matrix: diag of kept Ritz values + coupling row/col at ell.
	e_ell = (idx[:m] == ell).astype(dtype)
	col = jnp.where(idx[:m] < ell, s, 0.0)
	T = jnp.diag(lam * kept) + jnp.outer(col, e_ell) + jnp.outer(e_ell, col)

	def body(j, carry):
		V, T, _ = carry
		v = jnp.take(V, j, axis=1)
		w = matmat(v[:, None])[:, 0]
		alpha = jnp.dot(v, w)
		mask = (idx <= j).astype(dtype)
		for _ in range(2):  # CGS2 against the FULL current basis (cols 0..j)
			w = w - V @ ((V.T @ w) * mask)
		beta = jnp.linalg.norm(w)
		tiny = 10.0 * eps * (jnp.abs(alpha) + beta + 1.0)
		ok = beta > tiny
		bet = jnp.where(ok & (j + 1 < m), beta, 0.0)  # last step stores no off-diagonal
		jp = jnp.minimum(j + 1, m - 1)  # when j+1 == m both adds hit [m-1,m-1] with bet=0
		T = T.at[j, j].add(alpha).at[j, jp].add(bet).at[jp, j].add(bet)

		def renew(w):
			# Invariant subspace: continue the basis with a fresh random
			# direction orthogonalized against everything found so far.
			r = jax.random.normal(jax.random.fold_in(key, j), (n,), dtype)
			for _ in range(2):
				r = r - V @ ((V.T @ r) * mask)
			return r / jnp.maximum(jnp.linalg.norm(r), eps)

		w_next = lax.cond(ok, lambda w: w / jnp.maximum(beta, eps), renew, w)
		return V.at[:, j + 1].set(w_next), T, jnp.where(ok, beta, 0.0)

	V, T, beta_last = lax.fori_loop(ell, m, body, (V, T, jnp.zeros((), dtype)))
	theta, Y = jnp.linalg.eigh(T)
	order = jnp.argsort(-theta)
	sel = order[:keep]
	resid = beta_last * jnp.abs(Y[m - 1, :])
	lam_new = jnp.zeros(m, dtype).at[:keep].set(theta[sel])
	s_new = jnp.zeros(m, dtype).at[:keep].set(beta_last * Y[m - 1, sel])
	V_new = jnp.zeros_like(V)
	V_new = V_new.at[:, :keep].set(V[:, :m] @ Y[:, sel])
	V_new = V_new.at[:, keep].set(V[:, m])
	return V_new, lam_new, s_new, theta[order], resid[order]


def _trlan_top(matmat: Callable, n: int, k: int, dtype, key, maxiter: int, tol) -> Tuple[jnp.ndarray, jnp.ndarray]:
	"""Top-``k`` eigenpairs by thick-restart Lanczos (Wu-Simon 2000).

	The implicit-restart engine of the reference's scipy/ARPACK dependency,
	rebuilt device-native: every cycle is a fixed-shape program — (m−ℓ) matvecs,
	each followed by a CGS2 sweep against the (n, m+1) basis (two GEMMs), one
	(m×m) dense `eigh`, one (n,m)×(m,keep) compression GEMM — reused across
	restarts because ``ell`` is traced, not compiled in. Converges faster than
	LOBPCG for well-separated extremal eigenvalues (Krylov vs block-gradient
	rates); LOBPCG remains the default for clustered/multiple eigenvalues,
	which single-vector Lanczos resolves only through restart randomization.
	"""
	assert n >= k + 4, f"thick-restart Lanczos needs n ≥ k+4 (room to extend past the kept set); got k={k}, n={n}"
	m = int(min(n - 1, max(3 * k, k + 12)))
	keep = min(max(k, min(2 * k, k + 8)), m - 2)
	assert keep >= k  # guaranteed by n ≥ k+4 → m ≥ k+3 → m−2 ≥ k+1
	tol = float(np.sqrt(jnp.finfo(dtype).eps)) if tol is None else float(tol)
	span = max(1, m - keep)
	ncycles = int(np.clip((int(maxiter) * max(k, 1)) // span + 1, 10, 500))

	key, k0 = jax.random.split(key)
	v0 = jax.random.normal(k0, (n,), dtype)
	V = jnp.zeros((n, m + 1), dtype).at[:, 0].set(v0 / jnp.linalg.norm(v0))
	lam = jnp.zeros(m, dtype)
	s = jnp.zeros(m, dtype)

	# ALL restart cycles run under one on-device while_loop: the per-cycle
	# residual check happens in the loop condition, not on host, so no cycle
	# waits on a host sync (the estimators' fused loops are the model). Cycle
	# counts are identical to the host-stepped loop: the condition
	# sees each cycle's (θ, resid) before the next body runs.
	def cond(carry):
		it, V, lam, s, ell, theta, resid = carry
		scale = jnp.maximum(jnp.max(jnp.abs(theta)), 1e-30)
		return jnp.logical_and(it < ncycles, jnp.logical_not(jnp.all(resid[:k] <= tol * scale)))

	def body(carry):
		it, V, lam, s, ell, _, _ = carry
		V, lam, s, theta, resid = _trlan_cycle(matmat, V, lam, s, ell, jax.random.fold_in(key, it), m=m, keep=keep)
		return (it + 1, V, lam, s, jnp.asarray(keep, jnp.int32), theta, resid)

	init = (
		jnp.zeros((), jnp.int32),
		V,
		lam,
		s,
		jnp.zeros((), jnp.int32),
		jnp.zeros(m, dtype),
		jnp.full(m, jnp.inf, dtype),
	)
	_, V, lam, s, _, _, _ = lax.while_loop(cond, body, init)
	return lam[:k], V[:, :k]


class _Realified:
	"""Real symmetric ``2n × 2n`` image ``[[B, −C], [C, B]]`` of a complex
	Hermitian ``A = B + iC``: identical spectrum with doubled multiplicity, and
	a real eigenvector ``[u_r; u_i]`` collapses to the complex eigenvector
	``u_r + i·u_i`` (any unit vector of a doubled pair's 2-D eigenspace is some
	phase ``e^{iφ}u``). One complex matmat per apply — LOBPCG stays real."""

	def __init__(self, op):
		from .random import real_dtype

		self._op = op
		n = op.shape[0]
		self.shape = (2 * n, 2 * n)
		self.dtype = real_dtype(op.dtype)

	def matmat(self, V: jnp.ndarray) -> jnp.ndarray:
		n = self._op.shape[0]
		Vc = (V[:n] + 1j * V[n:]).astype(self._op.dtype)
		Y = self._op.matmat(Vc)
		return jnp.concatenate([jnp.real(Y), jnp.imag(Y)], axis=0).astype(V.dtype)

	def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
		return self.matmat(v[:, None])[:, 0]


def _collapse_realified(w2: np.ndarray, V2: np.ndarray, k: int, order: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
	"""Fold realified eigenpairs back to ≤k distinct complex eigenpairs.

	Each real vector individually collapses to a valid complex eigenvector; the
	doubled multiplicity shows up as a phase-rotated copy of an already-kept
	direction. Dedup by PROJECTION (orthogonalize against the kept set, keep
	the residual direction when it is substantial): unlike a pairwise-overlap
	test, this keeps the full d-dimensional complex eigenspace of a degenerate
	eigenvalue — a second genuine basis vector can have |⟨u, u_kept⟩| anywhere
	in [0, 1] depending on how the realified solver rotated the 2d-dimensional
	real eigenspace."""
	n = V2.shape[0] // 2
	U = V2[:n] + 1j * V2[n:]
	keep_w, keep_u = [], []
	for i in order:
		u = U[:, i]
		nrm = np.linalg.norm(u)
		if nrm < 1e-10:
			continue
		u = u / nrm
		for uj in keep_u:  # project out the kept directions (CGS)
			u = u - np.vdot(uj, u) * uj
		res = np.linalg.norm(u)
		if res < 0.3:  # phase/rotation copy of the kept set
			continue
		keep_w.append(float(w2[i]))
		keep_u.append(u / res)
		if len(keep_w) == k:
			break
	return np.asarray(keep_w), (np.stack(keep_u, axis=1) if keep_u else np.zeros((n, 0), U.dtype))


def _upper_bound(op, seed) -> float:
	"""Cheap inflated upper bound on the spectrum (Rayleigh-Ritz sweep)."""
	from .lanczos import rayleigh_ritz

	deg = int(min(32, op.shape[0]))
	rw = np.asarray(rayleigh_ritz(op, deg=deg, orth=-1, seed=seed))
	lo, hi = float(rw.min()), float(rw.max())
	return hi + 0.1 * max(hi - lo, 1.0)


def eigsh(
	A,
	k: int = 6,
	which: str = "LA",
	maxiter: int = 200,
	tol: Optional[float] = None,
	return_eigenvectors: bool = True,
	seed=None,
	dtype=None,
	method: str = "lobpcg",
) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
	"""Extremal eigenpairs of a symmetric operator, scipy-`eigsh`-compatible.

	Matrix-free: ``A`` is anything `aslinop` accepts (arrays, scipy sparse,
	the sparse pytree operators, sharded operators, jittable callables).
	Returns eigenvalues in ascending order (and eigenvectors as columns,
	like `scipy.sparse.linalg.eigsh`).

	``method`` selects the iteration: ``"lobpcg"`` (default — blocked, robust
	to clustered/multiple eigenvalues) or ``"trlan"`` (thick-restart Lanczos —
	the ARPACK-style Krylov engine, faster per matvec for well-separated
	extremal eigenvalues). Both stop when every wanted residual is below
	``tol`` (default √eps) relative to the largest Ritz value, or after
	``maxiter`` iterations.
	"""
	from .random import as_key

	op = aslinop(A, dtype=dtype)
	n = op.shape[0]
	assert 0 < k < n, f"k must be in (0, n); got k={k}, n={n}"
	which = which.upper()
	assert which in ("LA", "SA", "LM", "BE"), f"Unknown which='{which}'"
	method = method.lower()
	assert method in ("lobpcg", "trlan"), f"Unknown method='{method}'"
	_solve_top = _trlan_top if method == "trlan" else _lobpcg_top
	f_dtype = jnp.promote_types(op.dtype, jnp.float32)

	is_cplx = jnp.dtype(op.dtype).kind == "c"
	# LOBPCG needs 5·(search dim) < n; below that the operator is tiny anyway —
	# densify (n matvecs) and eigendecompose directly. Complex operators go
	# through the realified 2n-dim solver (below), so their headroom doubles.
	if 5 * (k + 2) >= n or (is_cplx and 5 * (min(2 * k + 2, 2 * n - 1) + 2) >= 2 * n):
		Ad = jnp.asarray(op.todense(), f_dtype)
		sym = np.asarray(Ad)
		ws, Vs = np.linalg.eigh(0.5 * (sym + sym.conj().T))
		if which == "LA":
			sel = np.arange(n - k, n)
		elif which == "SA":
			sel = np.arange(k)
		elif which == "LM":
			sel = np.sort(np.argsort(-np.abs(ws))[:k])
		else:  # BE: k//2 from the low end, the rest (incl. the odd extra) from the high end
			sel = np.concatenate([np.arange(k // 2), np.arange(n - (k - k // 2), n)])
		w, V = ws[sel], Vs[:, sel]
		return (w, V) if return_eigenvectors else w

	if is_cplx:
		# Hermitian complex operators: LOBPCG over the REAL 2n-dim realified
		# image (jax's lobpcg_standard is real-only), then fold the doubled
		# pairs back to k complex eigenpairs.
		if which == "BE":
			k_top, k_bot = (k + 1) // 2, k // 2
			w_t, V_t = eigsh(op, k=k_top, which="LA", maxiter=maxiter, tol=tol, seed=seed, method=method)
			if k_bot > 0:
				w_b, V_b = eigsh(op, k=k_bot, which="SA", maxiter=maxiter, tol=tol, seed=seed, method=method)
				w = np.concatenate([w_b, w_t])
				V = np.concatenate([np.asarray(V_b), np.asarray(V_t)], axis=1)
			else:
				w, V = w_t, np.asarray(V_t)
			asc = np.argsort(w)
			w, V = w[asc], V[:, asc]
			return (w, V) if return_eigenvectors else w
		k2 = min(2 * k + 2, 2 * n - 1)
		w2, V2 = eigsh(_Realified(op), k=k2, which=which, maxiter=maxiter, tol=tol, seed=seed, method=method)
		w2, V2 = np.asarray(w2), np.asarray(V2)
		if which == "LA":
			order = np.argsort(-w2)
		elif which == "SA":
			order = np.argsort(w2)
		else:  # LM
			order = np.argsort(-np.abs(w2))
		w, V = _collapse_realified(w2, V2, k, order)
		asc = np.argsort(w)
		w, V = w[asc], V[:, asc]
		return (w, V) if return_eigenvectors else w

	key = as_key(seed)
	k_lo, k_hi = jax.random.split(key)

	# Guard vectors: LOBPCG's trailing Ritz values converge last; solve for a
	# few extra and truncate (standard practice, scipy does the analog via ncv).
	pad = min(max(2, k // 4), n - k - 1, max(0, (n - 1) // 5 - k)) if n - k > 1 else 0

	def top(kk, key2):
		th, U = _solve_top(lambda X: op.matmat(X.astype(op.dtype)).astype(f_dtype), n, kk, f_dtype, key2, maxiter, tol)
		return th[:kk], U  # both solvers return descending theta

	def bottom(kk, key2, c):
		th, U = _solve_top(
			lambda X: (c * X - op.matmat(X.astype(op.dtype)).astype(f_dtype)), n, kk, f_dtype, key2, maxiter, tol
		)
		return c - th[:kk], U  # ascending eigenvalues of A

	if which == "LA":
		th, U = top(k + pad, k_hi)
		w, V = np.asarray(th[:k]), np.asarray(U[:, :k])
	elif which == "SA":
		c = _upper_bound(op, seed)
		th, U = bottom(k + pad, k_lo, c)
		w, V = np.asarray(th[:k]), np.asarray(U[:, :k])
	else:
		k_top = (k + 1) // 2 if which == "BE" else k
		k_bot = k // 2 if which == "BE" else k
		th_t, U_t = top(k_top + pad, k_hi)
		c = _upper_bound(op, seed)
		th_b, U_b = bottom(k_bot + pad, k_lo, c)
		cand_w = np.concatenate([np.asarray(th_t[:k_top]), np.asarray(th_b[:k_bot])])
		cand_V = np.concatenate([np.asarray(U_t[:, :k_top]), np.asarray(U_b[:, :k_bot])], axis=1)
		if which == "LM":
			order = np.argsort(-np.abs(cand_w))[:k]
		else:  # BE: exactly the selected ends
			order = np.arange(cand_w.shape[0])
		# Dedup eigenpairs found from both ends (vectors nearly parallel).
		keep: list = []
		for i in order:
			if all(abs(float(cand_V[:, i] @ cand_V[:, j])) < 0.5 for j in keep):
				keep.append(int(i))
			if len(keep) == k:
				break
		w, V = cand_w[keep], cand_V[:, keep]

	asc = np.argsort(w)
	w, V = w[asc], V[:, asc]
	return (w, V) if return_eigenvectors else w


def filtered_eigsh(
	A,
	interval: Tuple[float, float],
	k: Optional[int] = None,
	deg: Optional[int] = None,
	maxiter: int = 30,
	tol: Optional[float] = None,
	oversample: Optional[int] = None,
	spectral_interval: Optional[Tuple[float, float]] = None,
	seed=None,
	dtype=None,
) -> Tuple[np.ndarray, np.ndarray]:
	"""All eigenpairs inside ``interval = (a, b)`` — spectrum slicing by
	Chebyshev-Jackson filtered subspace iteration (Zhou-Saad).

	Interior eigenproblems defeat both shift-invert (no factorization exists
	for an implicit operator) and plain Krylov (interior Ritz values converge
	last). The filter route is device-native end to end: each iteration applies a
	degree-``deg`` Chebyshev bandpass approximant ``ρ(A)`` to the whole
	``(n, s)`` subspace — ``deg`` operator applications via the Clenshaw
	recurrence of :class:`~primate_tpu.ChebyshevFunction`, all GEMM/SpMM — then
	one thin QR and one ``(s, s)`` Rayleigh-Ritz eigensolve. ρ amplifies the
	slice and damps everything else, so a handful of iterations converge.

	``k`` (the expected count in the slice) defaults to a stochastic
	:func:`~primate_tpu.recipes.eigencount` estimate — the natural workflow is
	count-then-slice, and both consume the same operator. The subspace is
	oversampled by ``max(6, k/4)`` and grown adaptively if it saturates (more
	eigenvalues inside than the sketch can hold).

	Beyond-reference capability: the reference can only *count* eigenvalues in
	an interval (`docs/src/table.qmd`), not compute them.

	Returns ``(w, V)``: ascending eigenvalues in the closed slice and their
	orthonormal eigenvectors.
	"""
	from .kpm import ChebyshevFunction, _spectral_interval
	from .random import as_key
	from .special import smoothstep

	op = aslinop(A, dtype=dtype)
	n = op.shape[0]
	a, b = float(interval[0]), float(interval[1])
	assert a < b, f"interval must satisfy a < b; got {interval}"
	lmin, lmax = spectral_interval if spectral_interval is not None else _spectral_interval(op, seed)
	a, b = max(a, lmin), min(b, lmax)
	if a >= b:
		# The requested slice lies entirely outside the (inflated) estimated
		# spectral range — it cannot contain eigenvalues. Return empty rather
		# than iterating a degenerate filter.
		import warnings

		warnings.warn(
			f"filtered_eigsh: interval {interval} is outside the estimated spectral "
			f"range [{lmin:g}, {lmax:g}]; returning no eigenpairs.",
			stacklevel=2,
		)
		rd = np.dtype(jnp.finfo(jnp.promote_types(op.dtype, jnp.float32)).dtype)
		return np.zeros(0, rd), np.zeros((n, 0), np.dtype(op.dtype))
	f_dtype = jnp.promote_types(op.dtype, jnp.float32)
	r_dtype = jnp.finfo(f_dtype).dtype if jnp.dtype(f_dtype).kind == "c" else f_dtype
	# Relative-residual target. Filtered subspace iteration converges at the
	# ratio of filter gains, which for eigenvalues near the slice boundary is
	# barely below 1 — boundary pairs land at ~1e-6 relative quickly and then
	# crawl. 1e-6 accepts them; pass a tighter tol (and more maxiter) to polish.
	tol = max(1e-6, float(np.sqrt(jnp.finfo(r_dtype).eps))) if tol is None else float(tol)
	key = as_key(seed)

	if k is None:
		from .recipes import eigencount

		k = max(int(eigencount(op, (a, b), seed=seed)), 1)
	k = int(min(k, n))  # a whole-spectrum slice (eigencount ≈ n, ± noise) is legitimate
	assert k > 0, f"k must be positive; got k={k}"

	# Bandpass filter: difference of smoothsteps (the eigencount window) with a
	# transition of ~2% of the slice, Jackson-damped. Degree heuristic: the
	# Chebyshev resolution near the slice must match the transition width —
	# ~8·(spectral range)/(slice width), clamped.
	width = 0.02 * (b - a)
	rise, fall = smoothstep(a=a - width, b=a + width), smoothstep(a=b - width, b=b + width)
	window = lambda x: rise(x) - fall(x)  # noqa: E731
	if deg is None:
		deg = int(np.clip(8.0 * (lmax - lmin) / max(b - a, 1e-12), 32, 600))
	# Fail fast on an unresolvable ask: a degree-`deg` Chebyshev filter cannot
	# separate a slice much narrower than ~(spectral range)/deg — the transition
	# band swamps the slice, every Ritz pair inside is a ghost, and the
	# iteration burns its whole budget before reporting 0 accepted pairs.
	resolution = (lmax - lmin) / max(int(deg), 1)
	if (b - a) < 0.5 * resolution:
		import warnings

		warnings.warn(
			f"filtered_eigsh: slice width {b - a:.3g} is below the degree-{deg} filter's "
			f"resolution ~{resolution:.3g} (spectral range {lmax - lmin:.3g}); pass a larger "
			"deg= (cost grows linearly) or widen the interval — returning no eigenpairs.",
			stacklevel=2,
		)
		rd = np.dtype(jnp.finfo(jnp.promote_types(op.dtype, jnp.float32)).dtype)
		return np.zeros(0, rd), np.zeros((n, 0), np.dtype(op.dtype))
	rho = ChebyshevFunction(op, fun=window, deg=int(deg), interval=(lmin, lmax), damping="jackson", dtype=dtype)

	s = min(k + (int(oversample) if oversample is not None else max(6, k // 4)), n)
	scale = max(abs(lmin), abs(lmax), 1e-30)
	X = _gaussian_sketch(key, (n, s), op.dtype)

	# Subspace iterations run under an on-device `lax.while_loop` — convergence,
	# stall detection, and the saturation test all evaluate in the loop condition
	# (no host sync per iteration). The loop exits to host ONLY when the sketch saturates — the
	# subspace then grows (a shape change XLA cannot trace through) and a fresh
	# fused loop continues with reset stall counters. Iteration accounting and
	# the stall/ghost heuristics are identical to the host-stepped original.
	def _filtered_epoch(X, it0, s):
		r_big = jnp.asarray(np.inf, r_dtype)

		def cond(carry):
			it, X, theta, resid, best_acc, best_rem, stall = carry
			inside = (theta >= a) & (theta <= b)
			n_in = jnp.count_nonzero(inside)
			saturated = n_in >= s - 1 if s < n else jnp.asarray(False)
			ok = jnp.where(inside, resid, 0.0) <= tol * scale
			converged = (n_in > 0) & jnp.all(ok)
			fresh = resid[0] == r_big  # sentinel: no iteration has run this epoch yet
			keep_going = jnp.logical_not(converged | saturated | (stall >= 4))
			return (it < int(maxiter)) & (fresh | keep_going)

		def body(carry):
			it, X, _, _, best_acc, best_rem, stall = carry
			Q, _ = jnp.linalg.qr(rho.matmat(X).astype(f_dtype))
			W = op.matmat(Q.astype(op.dtype)).astype(f_dtype)
			H = jnp.conj(Q).T @ W
			theta, U = jnp.linalg.eigh(0.5 * (H + jnp.conj(H).T))
			Xn = Q @ U
			R = W @ U - Xn * theta[None, :]
			resid = jnp.linalg.norm(R, axis=0).astype(r_dtype)
			inside = (theta >= a) & (theta <= b)
			n_in = jnp.count_nonzero(inside)
			saturated = (n_in >= s - 1) if s < n else jnp.asarray(False)
			# Ghost Ritz pairs in the filter's transition band hover with O(1)
			# residuals no matter how long we iterate. Detect a TRUE stall — no
			# new pair converging AND no geometric-mean improvement among the
			# rest. A saturated iteration leaves the counters untouched (the
			# host resets them after growing the sketch).
			acc_mask = inside & (resid <= tol * scale)
			n_acc = jnp.count_nonzero(acc_mask).astype(jnp.int32)
			rem_mask = inside & (resid > tol * scale)
			n_rem = jnp.count_nonzero(rem_mask)
			log_rem = jnp.where(rem_mask, jnp.log(jnp.maximum(resid, 1e-300)), 0.0)
			cur = jnp.where(n_rem > 0, jnp.exp(jnp.sum(log_rem) / jnp.maximum(n_rem, 1)), r_big)
			improve = (n_acc > best_acc) | (cur < 0.9 * best_rem)
			stall_n = jnp.where(saturated, stall, jnp.where(improve, 0, stall + 1))
			best_acc_n = jnp.where(saturated, best_acc, jnp.maximum(best_acc, n_acc))
			best_rem_n = jnp.where(saturated | (n_rem == 0), best_rem, jnp.minimum(best_rem, cur))
			return (it + 1, Xn, theta, resid, best_acc_n, best_rem_n, stall_n)

		init = (
			jnp.asarray(it0, jnp.int32),
			X.astype(f_dtype),  # the carry holds the post-Rayleigh-Ritz basis at f_dtype
			jnp.full(s, jnp.asarray(a, r_dtype) - 1.0),  # sentinel: nothing inside yet
			jnp.full(s, r_big),
			jnp.asarray(-1, jnp.int32),
			r_big,
			jnp.zeros((), jnp.int32),
		)
		return lax.while_loop(cond, body, init)

	theta = resid = inside = None
	it = 0
	while it < int(maxiter):
		it, X, theta, resid, _, _, _ = _filtered_epoch(X, it, s)
		it = int(it)
		resid = np.asarray(resid)
		theta_np = np.asarray(theta)
		inside = (theta_np >= a) & (theta_np <= b)
		n_in = int(np.count_nonzero(inside))
		if n_in >= s - 1 and s < n:
			# Slice saturated the sketch: eigencount undercounted. Grow the
			# subspace with fresh random directions and keep iterating.
			grow = min(max(s // 2, 4), n - s)
			key, kg = jax.random.split(key)
			X = jnp.concatenate([X, _gaussian_sketch(kg, (n, grow), op.dtype)], axis=1)
			s += grow
			continue
		break

	# If the growth branch fired on the FINAL iteration, X carries fresh random
	# columns the last Rayleigh-Ritz never saw — `accept` indexes the pre-growth
	# Ritz columns only.
	if inside is not None and X.shape[1] != inside.shape[0]:
		X = X[:, : inside.shape[0]]
	# Accept converged pairs only; an unconverged pair inside the slice is a
	# transition-band ghost (or a genuinely missed direction — warn either way).
	# 10× slack over the stop tolerance keeps slow boundary pairs (their
	# residuals crawl at the filter-gain ratio) while rejecting O(1)-residual
	# ghosts in any precision.
	accept = inside & (resid <= 10.0 * tol * scale)
	n_drop = int(np.count_nonzero(inside & ~accept))
	if n_drop:
		import warnings

		warnings.warn(
			f"filtered_eigsh: dropped {n_drop} unconverged Ritz pair(s) inside "
			f"[{a:g}, {b:g}] (relative residual > {10.0 * tol:g}); if the count "
			"looks short, raise deg/maxiter or widen the interval.",
			stacklevel=2,
		)
	w = np.asarray(theta)[accept]
	V = np.asarray(X)[:, accept]
	order = np.argsort(w)
	return w[order], V[:, order]


def svds(
	X,
	k: int = 6,
	maxiter: int = 200,
	tol: Optional[float] = None,
	return_vectors: bool = True,
	seed=None,
	dtype=None,
):
	"""Top-``k`` singular triplets of a (rectangular) matrix-free operator.

	scipy-`svds`-shaped surface for implicit data matrices: runs blocked LOBPCG
	(:func:`eigsh`) on the **Gram operator** ``XᵀX`` — never formed, two
	operator applications per iteration (the reference's gram-mode trick,
	`eigen_operators.h:58,69-75`, upgraded from spectral sums to actual
	triplets). Left vectors recovered as ``U = X V Σ⁻¹``.

	Returns ``(U, s, Vh)`` with ``s`` ascending (scipy convention), or just
	``s`` when ``return_vectors=False``.
	"""
	from .operators.sparse import GramOperator

	op = aslinop(X, dtype=dtype)
	m, n = op.shape
	assert 0 < k < min(m, n), f"k must be in (0, min(m, n)); got k={k}, shape={op.shape}"
	gram = GramOperator(op, transpose_first=(n <= m))  # eig-solve the smaller Gram side
	w, W = eigsh(gram, k=k, which="LA", maxiter=maxiter, tol=tol, seed=seed)
	s = np.sqrt(np.maximum(w, 0.0))
	if not return_vectors:
		return s
	safe = np.where(s > 0, s, 1.0)
	if n <= m:  # W are right singular vectors
		V = W
		U = np.asarray(op.matmat(jnp.asarray(V, op.dtype))) / safe[None, :]
	else:  # solved XXᵀ: W are left singular vectors
		U = W
		from .operators.sparse import _rmatmat

		V = np.asarray(_rmatmat(op, jnp.asarray(U, op.dtype))) / safe[None, :]
	return U, s, np.conj(V).T  # Vh = V† (conj is a no-op for real V)


def _gaussian_sketch(key, shape, dtype):
	"""Standard (complex when ``dtype`` is complex) Gaussian test matrix."""
	if jnp.issubdtype(dtype, jnp.complexfloating):
		from .random import real_dtype

		kr, ki = jax.random.split(key)
		rd = real_dtype(dtype)
		sc = jnp.asarray(np.sqrt(0.5), rd)
		return (jax.random.normal(kr, shape, rd) * sc + 1j * (jax.random.normal(ki, shape, rd) * sc)).astype(dtype)
	return jax.random.normal(key, shape, dtype)


def rsvd(
	X,
	k: int = 6,
	oversample: int = 8,
	n_iter: int = 2,
	seed=None,
	dtype=None,
):
	"""Rank-``k`` randomized SVD of a (rectangular) matrix-free operator.

	Halko–Martinsson–Tropp range finder with ``n_iter`` QR-stabilized subspace
	(power) iterations: every step is an operator application on a full
	``(·, k+oversample)`` block — GEMM/SpMM — plus a thin QR; the
	only small dense factorization is the SVD of the ``(k+oversample, n)``
	projected matrix. Complex operators get complex Gaussian test matrices and
	return ``Vh = V†``.

	Complements :func:`svds` (LOBPCG on the Gram operator — iterate-to-
	tolerance, best for a few extremal triplets): `rsvd` has a *fixed* cost of
	``2·n_iter + 2`` block applications and excels when the spectrum decays.

	Beyond-reference capability (the reference ships no low-rank
	approximation); the analog of its gram-trick spectral sums upgraded to
	factors. Returns ``(U, s, Vh)`` with ``s`` DESCENDING (`np.linalg.svd`
	convention; note :func:`svds` follows scipy's ascending order).
	"""
	from .operators.sparse import _rmatmat
	from .random import as_key

	op = aslinop(X, dtype=dtype)
	m, n = op.shape
	ell = int(min(k + oversample, min(m, n)))
	assert 0 < k <= ell, f"k must be in (0, min(m, n)]; got k={k}, shape={op.shape}"
	key = as_key(seed)

	Om = _gaussian_sketch(key, (n, ell), op.dtype)
	Q, _ = jnp.linalg.qr(op.matmat(Om))  # (m, ell) orthonormal range sketch
	for _ in range(int(n_iter)):
		Z, _ = jnp.linalg.qr(_rmatmat(op, Q))  # (n, ell)
		Q, _ = jnp.linalg.qr(op.matmat(Z))
	B = jnp.conj(_rmatmat(op, Q)).T  # (ell, n) = Q† X
	Ub, s, Vh = jnp.linalg.svd(B, full_matrices=False)
	U = Q @ Ub
	return np.asarray(U[:, :k]), np.asarray(s[:k]), np.asarray(Vh[:k])


def rand_nystrom(A, rank: int = 6, oversample: int = 8, seed=None, dtype=None):
	"""Rank-``rank`` randomized Nyström approximation ``Â = U diag(w) U†`` of a
	PSD operator.

	Single-pass, shift-stabilized (Tropp-Yurtsever-Udell-Cevher 2017): ONE
	block application ``Y = AΩ`` against an orthonormalized Gaussian sketch,
	then ``Â = Y (Ω†Y)⁻¹ Y†`` factored through a Cholesky of the small core and
	a thin SVD — all GEMMs plus ``(s×s)``/``(n×s)`` dense factorizations. The
	ν-shift regularizes the core Cholesky; ν is subtracted back from the
	eigenvalues.

	This is the *approximation-grade* sibling of
	:func:`~primate_tpu.solvers.nystrom_precond` (which trades accuracy for
	speed via a Gram eigh — fine for clustering a spectrum, not for factors)
	and the input to deflation workflows: feed ``(w, U)`` to
	`operators.DeflatedOperator` / `recipes.deflated_trace` to split a spectral
	sum into an exact low-rank part plus a small stochastic remainder.

	Returns ``(w, U)`` with ``w`` DESCENDING and ``U`` orthonormal ``(n, rank)``.
	Beyond-reference capability.
	"""
	op = aslinop(A, dtype=dtype)
	n = op.shape[0]
	assert op.shape[0] == op.shape[1], "rand_nystrom requires a square (PSD) operator"
	from .random import as_key, real_dtype

	ell = int(min(rank + oversample, n))
	assert 0 < rank <= ell
	acc = jnp.promote_types(op.dtype, jnp.float32)
	r_acc = real_dtype(acc)

	Om = _gaussian_sketch(as_key(seed), (n, ell), op.dtype)
	Om, _ = jnp.linalg.qr(Om.astype(acc))
	Y = op.matmat(Om.astype(op.dtype)).astype(acc)
	nu = jnp.finfo(r_acc).eps * jnp.linalg.norm(Y) / jnp.sqrt(jnp.asarray(n, r_acc))
	Y = Y + nu * Om
	core = 0.5 * ((jnp.conj(Om).T @ Y) + (jnp.conj(Y).T @ Om))  # ½(Ω†Y + Y†Ω), Hermitian
	L = jnp.linalg.cholesky(core)
	if not bool(np.all(np.isfinite(np.asarray(L)))):
		# A numerically INDEFINITE input (PSD up to roundoff with a small
		# negative eigenvalue the ε-scale ν-shift cannot cover) makes the
		# Cholesky return NaN silently — which would propagate into (w, U) and
		# poison every downstream deflation. Re-shift by the core's most
		# negative eigenvalue and retry; the extra shift is subtracted back.
		w_core = jnp.linalg.eigvalsh(core)
		bump = jnp.maximum(-w_core[0], 0.0) * 2.0 + jnp.finfo(r_acc).eps * jnp.abs(w_core[-1])
		Y = Y + bump * Om
		nu = nu + bump
		core = core + bump * jnp.eye(ell, dtype=acc)
		L = jnp.linalg.cholesky(core)
	L_inv = jax.scipy.linalg.solve_triangular(L, jnp.eye(ell, dtype=acc), lower=True)
	B = Y @ jnp.conj(L_inv).T  # (n, ell), Â = BB†
	U, s, _ = jnp.linalg.svd(B, full_matrices=False)  # accurate path: thin SVD, no Gram squaring
	w = jnp.maximum(s**2 - nu, 0.0)
	return np.asarray(w[:rank]), np.asarray(U[:, :rank])
