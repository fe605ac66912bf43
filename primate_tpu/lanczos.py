"""Matrix-free block Lanczos tridiagonalization as a batched `lax.scan`.

Parity: reference C++ kernel ``src/primate/include/lanczos.h:89-148``
(`lanczos_recurrence`, Paige's A27 variant) and Python API
``src/primate/lanczos.py:25-164`` (`lanczos`, `rayleigh_ritz`).

Accelerator design (NOT a translation of the C++ loop):
  * The reference runs one serial three-term recurrence per probe vector behind
    an FFI boundary. Here **all nv probes advance together**: the Krylov step is
    one operator application on an ``(n, nv)`` block — a single GEMM/SpMM per
    Lanczos step — and the α/β updates are batched reductions.
  * The recurrence itself is a `lax.scan` over ``deg`` steps (Lanczos is
    inherently sequential in the degree; all parallelism comes from the probe
    block and from sharding the ``n`` axis across devices).
  * The reference's ring buffer of ``ncv`` basis vectors with cyclic index
    rotation (`lanczos.h:113-147`) becomes a ``(ncv, n, nv)`` carry written with
    `lax.dynamic_update_index_in_dim`; selective re-orthogonalization against
    the last ``orth`` vectors is a **masked classical Gram-Schmidt** — two
    batched reductions per pass (CGS2 by default, which is both more stable and
    more parallel than the reference's serial MGS sweep,
    `lanczos.h:43-66`).
  * Early exit on an invariant subspace (β ≤ √n·rtol, `lanczos.h:139-141`)
    cannot break out of a traced loop, so each probe carries a ``done`` flag
    that freezes its column: α/β emit zeros afterwards, which makes the
    tridiagonal matrix decouple exactly as the reference's zero-fill does.
  * All reductions accumulate in float32 (or float64 under x64) regardless of
    the storage dtype, so bf16 operators keep accurate Jacobi coefficients.
"""

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .tridiag import eigh_tridiag, eigvalsh_tridiag

__all__ = ["lanczos", "rayleigh_ritz", "lanczos_block", "lanczos_block_op", "LanczosOutput", "OrthogonalPolynomialBasis"]


class LanczosOutput(NamedTuple):
	"""Batched Lanczos results: probe axis last.

	alphas: (deg, nv) diagonal entries α_0..α_{deg-1} of the Jacobi matrices.
	betas:  (deg, nv) off-diagonals/residuals β_1..β_deg (β_deg is the final
	        residual norm; the deg×deg tridiagonal uses betas[:deg-1]).
	Q:      (ncv, n, nv) window of Lanczos basis vectors (slot ``t % ncv``
	        holds q_t) — the full basis when ``ncv == deg``.
	"""

	alphas: jnp.ndarray
	betas: jnp.ndarray
	Q: Optional[jnp.ndarray]
	y: Optional[jnp.ndarray] = None  # Σ_t coeffs[t]·q_t when coeffs given (2-pass f(A)v)
	reorth_steps: Optional[jnp.ndarray] = None  # (deg,) bool — selective-reorth trigger trace


def _validate_params(n: int, deg: int, orth: int, ncv: Optional[int], return_basis: bool) -> Tuple[int, int, int]:
	"""Clamp (deg, orth, ncv) with the reference's rules (`lanczos.py:88-89`, `_lanczos.h:71-87`)."""
	deg = int(np.clip(deg, 1, n))
	orth = deg if (orth < 0 or orth > deg) else int(orth)
	if ncv is None:
		ncv = deg if return_basis else int(np.clip(max(orth, 2), 2, deg))
	ncv = int(np.clip(ncv, min(2, deg), deg))
	# A user ncv smaller than orth cannot hold the requested window — the
	# mod-ncv age mask would silently re-orthogonalize against ncv vectors
	# only. Clamp like the reference's orth ≤ ncv rule (`lanczos.py:13-16`).
	orth = min(orth, ncv)
	return deg, orth, ncv


@partial(jax.jit, static_argnames=("deg", "ncv", "orth", "reorth_passes", "return_basis", "basis_dtype", "selective"))
def lanczos_block_op(
	op,
	V0: jnp.ndarray,
	deg: int,
	ncv: int,
	orth: int = 0,
	rtol: float = 1e-8,
	reorth_passes: int = 2,
	return_basis: bool = True,
	coeffs: Optional[jnp.ndarray] = None,
	basis_dtype=None,
	selective: bool = False,
) -> LanczosOutput:
	"""`lanczos_block` with the operator as a PYTREE argument.

	Prefer this entry point when sweeping over many operators: the compiled
	program is keyed on the operator's structure, so swapping matrices of the
	same shape re-uses it. The callable-based `lanczos_block` keys on the
	callable's identity — a bound method pins the cache to one instance and
	bakes its arrays into the executable as constants.

	The operator's apply is traced into the scan step, so XLA fuses it with
	the recurrence's β-axpy and α-reduction (the reason the stencil stays
	plain XLA: a custom kernel call cannot join that fusion).
	"""
	return _lanczos_core(
		op.matmat, V0, deg=deg, ncv=ncv, orth=orth, rtol=rtol, reorth_passes=reorth_passes,
		return_basis=return_basis, coeffs=coeffs, basis_dtype=basis_dtype,
		matmat_t=getattr(op, "matmat_t", None), selective=selective,
	)


@partial(jax.jit, static_argnames=("matmat", "deg", "ncv", "orth", "reorth_passes", "return_basis", "basis_dtype", "matmat_t", "selective"))
def lanczos_block(
	matmat: Callable[[jnp.ndarray], jnp.ndarray],
	V0: jnp.ndarray,
	deg: int,
	ncv: int,
	orth: int = 0,
	rtol: float = 1e-8,
	reorth_passes: int = 2,
	return_basis: bool = True,
	coeffs: Optional[jnp.ndarray] = None,
	basis_dtype=None,
	matmat_t: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
	selective: bool = False,
) -> LanczosOutput:
	"""Run ``deg`` Lanczos steps on a block of probes ``V0 (n, nv)`` — pure/jittable.

	``matmat`` applies the symmetric operator to an ``(n, nv)`` block. Each scan
	step costs one ``matmat`` plus O(ncv) batched inner products. See module
	docstring for the design rationale.

	Performance notes (the scan step is HBM-bound — every full-array op is a
	~n·nv pass):
	  * with ``return_basis=False`` and ``orth == 0`` no basis window is
	    carried at all — the quadrature path (`MatrixFunction.quad`) only needs
	    (α, β), and skipping the window removes the dominant carry traffic;
	  * early-exit freezing relies on zero-propagation instead of full-array
	    selects: once β ≈ 0, the guarded divide makes q_next ≈ 0 and the
	    recurrence self-extinguishes (matmat(0) = 0), so only the tiny (nv,)
	    α/β outputs need masking. The basis window (when kept) still masks its
	    slot writes so early-exit columns retain their last valid vectors
	    (reference zero-fill semantics, `lanczos.h:139-141`).

	With ``coeffs (deg, nv)`` the sweep additionally accumulates
	``y = Σ_t coeffs[t]·q_t`` in O(n·nv) memory — the second pass of two-pass
	Lanczos ``f(A)v``, which never materializes the (deg, n, nv) basis.
	Early-exit columns stop contributing automatically (q_t → 0).

	``selective=True`` enables ω-monitored partial re-orthogonalization
	(Simon 1984): the scalar ω-recurrence estimates every ⟨q_{j+1}, q_t⟩ at
	O(ncv·nv) per step (no n-sized work), and the CGS window pass runs under
	``lax.cond`` only on steps where max|ω| crosses √eps — cleaning TWO
	consecutive vectors per breach so the β-coupling cannot re-inject the
	loss. Semiorthogonality (‖QᵀQ − I‖ ≲ √eps) is maintained, which keeps the
	Jacobi coefficients fully accurate; the trigger rate adapts to the
	spectrum (benign spectra: a few percent of steps; a converged dominant
	Ritz pair: every other step — the theoretical requirement). Use
	``ncv=deg`` (the driver `lanczos(..., selective=True)` forces this): the ω
	slots are window-cyclic, so a short window would track the wrong vectors.
	The per-step trigger trace is returned as ``reorth_steps``. The ``orth``
	parameter is ignored when selective is on.
	"""
	return _lanczos_core(
		matmat, V0, deg=deg, ncv=ncv, orth=orth, rtol=rtol, reorth_passes=reorth_passes,
		return_basis=return_basis, coeffs=coeffs, basis_dtype=basis_dtype, matmat_t=matmat_t,
		selective=selective,
	)


def _lanczos_core(
	matmat: Callable[[jnp.ndarray], jnp.ndarray],
	V0: jnp.ndarray,
	*,
	deg: int,
	ncv: int,
	orth: int,
	rtol: float,
	reorth_passes: int,
	return_basis: bool,
	coeffs: Optional[jnp.ndarray],
	basis_dtype=None,
	matmat_t: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
	selective: bool = False,
) -> LanczosOutput:
	n, nv = V0.shape
	dtype = V0.dtype
	acc_dtype = jnp.promote_types(dtype, jnp.float32)  # f32 accumulation for bf16 storage
	# Complex-Hermitian operators: inner products conjugate the bra side; α/β
	# (and the Jacobi matrix) are REAL — downstream quadrature/eigensolves are
	# unchanged. The real path keeps its exact original lowering (static branch).
	is_cplx = np.dtype(dtype).kind == "c"
	r_dtype = np.finfo(acc_dtype).dtype if is_cplx else acc_dtype
	# Storage dtype for the carried basis window only. bf16 halves the dominant
	# HBM traffic of the scan step (the window is read twice per re-orth pass);
	# the recurrence itself — q_prev/q_cur, α/β, all reductions — stays in
	# dtype/acc_dtype, so Jacobi coefficients keep full precision and only the
	# re-orth *corrections* (second-order) and the returned basis are truncated.
	b_dtype = jnp.dtype(basis_dtype) if basis_dtype is not None else dtype
	keep_window = return_basis or orth > 0 or selective

	# The whole sweep runs PROBE-MAJOR: state is (nv, n), window (ncv, nv, n).
	# The contiguous axis is n, so no array's minor dimension depends on the
	# probe count (kept from the first accelerator this library targeted,
	# where narrow node-major blocks padded badly; the layout is unmeasured on
	# the GPU). Operators apply via ``matmat_t``
	# (probe-major stencils/GEMMs where natural, transpose-wrapped ``matmat``
	# otherwise); outputs transpose back at exit, amortized over all deg steps.
	if matmat_t is None:
		matmat_t = lambda Vt: matmat(Vt.T).T  # noqa: E731
	V0t = V0.T

	if is_cplx:
		norm0 = jnp.sqrt(jnp.sum(jnp.abs(V0t.astype(acc_dtype)) ** 2, axis=1))
	else:
		norm0 = jnp.sqrt(jnp.sum(V0t.astype(acc_dtype) ** 2, axis=1))
	q0 = (V0t / jnp.where(norm0 > 0, norm0, 1)[:, None].astype(dtype)).astype(dtype)
	residual_tol = jnp.sqrt(jnp.asarray(n, r_dtype)) * jnp.asarray(rtol, r_dtype)

	Q_win = jnp.zeros((ncv, nv, n), b_dtype).at[0].set(q0.astype(b_dtype)) if keep_window else jnp.zeros((0,), b_dtype)
	# coeffs (deg, nv) — or (deg, ..., nv) for a STACKED family of expansions
	# sharing this sweep (multi-f two-pass matvec); y broadcasts accordingly.
	y0 = jnp.zeros(coeffs.shape[1:] + (n,), acc_dtype) if coeffs is not None else jnp.zeros((0,), acc_dtype)
	# Selective (partial) re-orthogonalization state — Simon's ω-recurrence:
	# ω_j[t] estimates ⟨q_j, q_t⟩ for every window slot at O(ncv·nv) per step
	# (no n involved). The CGS pass then runs under `lax.cond` only on steps
	# where max|ω| crosses √eps — long stretches of a well-behaved sweep skip
	# the window traffic entirely. (The reference has no analog: its C++ loop
	# re-orthogonalizes unconditionally, `lanczos.h:132-136`.)
	eps_noise = jnp.asarray(float(jnp.finfo(r_dtype).eps) * np.sqrt(n), r_dtype)
	sel_tol = jnp.sqrt(jnp.asarray(float(jnp.finfo(r_dtype).eps), r_dtype))
	om0 = jnp.zeros((nv, ncv), r_dtype).at[:, 0].set(1.0) if selective else jnp.zeros((0,), r_dtype)
	sel0 = (
		jnp.zeros((nv, ncv), r_dtype),  # ω_{j-1}
		om0,  # ω_j (j=0: only q0 itself)
		jnp.zeros((nv, ncv), r_dtype),  # α_t per slot
		jnp.zeros((nv, ncv), r_dtype),  # β_t per slot (coupling q_{t-1}→q_t)
		jnp.asarray(False),  # force: a breach last step → clean this step too
	) if selective else ()
	# (A deferred-normalization carry — (v, β) with q = v/β recomputed in
	# consumer fusions — was prototyped and measured neutral: XLA
	# materializes the shared q subexpression anyway since three fusions
	# consume it, so the explicit divide pass below costs the same and keeps
	# the code simpler and bit-stable.)
	carry0 = (
		jnp.zeros((nv, n), dtype),  # q_prev
		q0,  # q_cur
		Q_win,
		jnp.zeros(nv, r_dtype),  # beta_j (coupling into the current step; real)
		jnp.zeros(nv, bool),  # done
		y0,
	) + sel0

	# Re-orth window validity: slot s at step j holds q_t with age (j - s) mod ncv;
	# valid if the slot was written (age <= j) and within the last `orth` vectors.
	slot_ids = jnp.arange(ncv)

	def _cgs_window(v, Q_win, valid):
		"""reorth_passes of classical Gram-Schmidt against the masked window."""
		for _ in range(max(1, reorth_passes)):
			if is_cplx:
				proj = jnp.sum(jnp.conj(Q_win) * v[None, :, :], axis=2) * valid[:, None]
			else:
				proj = jnp.sum(Q_win * v[None, :, :], axis=2) * valid[:, None]
			v = v - jnp.sum(Q_win * proj[:, :, None].astype(acc_dtype), axis=0)
		return v

	def step(carry, j):
		q_prev, q_cur, Q_win, beta_j, done, y, *sel = carry
		if coeffs is not None:
			y = y + coeffs[j][..., None].astype(acc_dtype) * q_cur.astype(acc_dtype)
		with jax.named_scope("lanczos_matmat"):  # xprof/trace label (SURVEY §5.1)
			v = matmat_t(q_cur).astype(acc_dtype)
		v = v - beta_j[:, None] * q_prev.astype(acc_dtype)
		qc = q_cur.astype(acc_dtype)
		if is_cplx:
			alpha_j = jnp.sum(jnp.real(jnp.conj(qc) * v), axis=1)  # ⟨q,v⟩ real (Hermitian)
		else:
			alpha_j = jnp.sum(v * qc, axis=1)
		v = v - alpha_j[:, None] * qc

		if selective:
			om_pp, om_p, a_win, b_win, force = sel
			# ω-recurrence level j+1 (estimates ⟨q_{j+1}, q_t⟩ for window slots),
			# using the pre-reorth residual norm as the β_{j+1} denominator.
			if is_cplx:
				beta_est = jnp.sqrt(jnp.sum(jnp.abs(v) ** 2, axis=1))
			else:
				beta_est = jnp.sqrt(jnp.sum(v * v, axis=1))
			slot_j = j % ncv
			a_win = a_win.at[:, slot_j].set(alpha_j.astype(r_dtype))
			b_win = b_win.at[:, slot_j].set(beta_j.astype(r_dtype))
			# neighbors in t map to adjacent slots (slot = t mod ncv)
			om_tp1 = jnp.roll(om_p, -1, axis=1)
			om_tm1 = jnp.roll(om_p, 1, axis=1)
			b_tp1 = jnp.roll(b_win, -1, axis=1)
			num = b_tp1 * om_tp1 + (a_win - alpha_j[:, None].astype(r_dtype)) * om_p + b_win * om_tm1 - beta_j[:, None] * om_pp
			om_next = num / jnp.where(beta_est > 0, beta_est, jnp.inf)[:, None].astype(r_dtype)
			# rounding-noise floor: inflate MAGNITUDE by ε for either sign (a
			# signed `+ sign(ω)ε + ε` would cancel to zero on negative entries,
			# systematically under-tracking negative orthogonality loss)
			om_next = jnp.where(om_next >= 0, om_next + eps_noise, om_next - eps_noise)
			age_next = (j + 1 - slot_ids) % ncv  # slot ages at level j+1
			written_next = age_next <= j + 1
			tracked = written_next & (age_next >= 2)  # exclude q_{j+1} itself and q_j (locally orthogonal)
			om_next = jnp.where(tracked[None, :], om_next, 0.0)
			om_next = om_next.at[:, slot_j].set(eps_noise)  # ⟨q_{j+1}, q_j⟩ ≈ ε (local orthogonality)
			om_next = om_next.at[:, (j + 1) % ncv].set(1.0)  # q_{j+1} against itself
			# one collective trigger for the whole probe block (a per-probe cond
			# would vmap into a select — executing both branches for everyone)
			live = jnp.abs(om_next) * (~done)[:, None].astype(r_dtype)
			breach = jnp.any(live * tracked[None, :].astype(r_dtype) > sel_tol)
			# A breach cleans TWO consecutive vectors (Simon's rule): q_j's
			# own lost orthogonality re-enters q_{j+2} through the β-coupling,
			# so cleaning q_{j+1} alone just re-fires every other step.
			trigger = breach | force
			valid_all = ((j - slot_ids) % ncv <= j).astype(r_dtype)  # every written slot incl. q_j
			with jax.named_scope("lanczos_selective_reorth"):
				v = lax.cond(trigger, lambda v: _cgs_window(v, Q_win, valid_all), lambda v: v, v)
			# after a CGS2 pass the window components sit at the noise floor —
			# floor BOTH carried ω levels (q_{j+1} is clean now; q_j will be
			# clean after the forced pass next step)
			om_next = jnp.where(trigger & tracked[None, :], jnp.sign(om_next) * eps_noise, om_next)
			om_p_out = jnp.where(trigger & (slot_ids != (j % ncv))[None, :], jnp.sign(om_p) * eps_noise, om_p)
			sel = (om_p_out, om_next, a_win, b_win, breach)
			trig_out = trigger
		else:
			trig_out = jnp.asarray(False)
		if not selective and orth > 0:
			age = (j - slot_ids) % ncv
			valid = ((age < orth) & (age <= j)).astype(r_dtype)  # (ncv,)
			with jax.named_scope("lanczos_reorth"):  # xprof/trace label (SURVEY §5.1)
				# Broadcast-multiply + reductions over n, NOT dot_general:
				# the contraction over n with the probe axis as batch
				# lowers to per-probe GEMVs; as elementwise+reduce it
				# streams the window once.
				# Q_win is used at its storage dtype — mixed-dtype multiply
				# promotes inside the fusion, so no materialized f32 copy
				# of the (ncv, nv, n) window per step.
				v = _cgs_window(v, Q_win, valid)

		if is_cplx:
			beta_next = jnp.sqrt(jnp.sum(jnp.abs(v) ** 2, axis=1))
		else:
			beta_next = jnp.sqrt(jnp.sum(v * v, axis=1))
		newly_done = beta_next < residual_tol
		alpha_out = jnp.where(done, 0.0, alpha_j)
		beta_out = jnp.where(done, 0.0, beta_next)

		# Guarded divide: once β vanishes, q_next ≈ 0 and the recurrence
		# self-extinguishes — no full-array freeze selects needed.
		q_next = (v / jnp.where(beta_next > residual_tol, beta_next, jnp.inf)[:, None]).astype(dtype)
		if keep_window:
			slot = (j + 1) % ncv
			if return_basis:
				# Masked write: early-exit columns keep their last valid basis
				# vectors (reference zero-fill semantics, `lanczos.h:139-141`).
				advance = ~(done | newly_done) & (j + 1 < deg)
				old_slot = lax.dynamic_index_in_dim(Q_win, slot, axis=0, keepdims=False)
				new_slot = jnp.where(advance[:, None], q_next.astype(b_dtype), old_slot)
			else:
				# Window exists only for re-orthogonalization: q_next is exactly
				# 0 for exited columns (guarded divide), so an unconditional
				# write is equivalent for the projection math — and, with no
				# read-before-write on the carry, XLA updates the (ncv, nv, n)
				# buffer in place instead of copying it every step.
				new_slot = q_next.astype(b_dtype)
			Q_win = lax.dynamic_update_index_in_dim(Q_win, new_slot, slot, axis=0)

		return (q_cur, q_next, Q_win, beta_next, done | newly_done, y) + tuple(sel), (alpha_out, beta_out, trig_out)

	(_, _, Q_win, _, _, y_fin, *_sel_fin), (alphas, betas, trig_trace) = lax.scan(step, carry0, jnp.arange(deg))
	return LanczosOutput(
		alphas=alphas,
		betas=betas,
		Q=jnp.swapaxes(Q_win, 1, 2) if keep_window else None,  # → (ncv, n, nv) API layout
		y=jnp.swapaxes(y_fin, -1, -2) if coeffs is not None else None,  # → (..., n, nv)
		reorth_steps=trig_trace if selective else None,
	)


def lanczos(
	A,
	v0: Optional[jnp.ndarray] = None,
	deg: Optional[int] = None,
	rtol: float = 1e-8,
	orth: int = 0,
	sparse_mat: bool = False,
	return_basis: bool = False,
	seed=None,
	dtype=None,
	ncv: Optional[int] = None,
	reorth_passes: int = 2,
	basis_dtype=None,
	selective: bool = False,
	**kwargs,
) -> tuple:
	r"""Lanczos tridiagonalization: build ``T = Qᵀ A Q`` from a symmetric operator.

	Runs ``deg`` steps of the β-coupled three-term recurrence with ``orth``
	re-orthogonalizations per step (0 = none, ``deg`` or negative = full).
	Accepts a single start vector ``v0 (n,)`` — reference-compatible output — or
	a block ``v0 (n, nv)`` of probes, which all advance in one fused sweep.

	Returns ``(a, b)``: diagonal (deg,) and off-diagonal (deg-1,) of the Jacobi
	matrix (with a trailing probe axis when batched); with ``return_basis=True``
	also the basis ``Q`` — ``(n, ncv)`` for a single ``v0``, ``(nv, n, ncv)``
	probe-major for a block; with ``sparse_mat=True`` the dense
	tridiagonal matrix itself (JAX has no host-sparse spdiags — downstream
	eigensolves densify anyway since deg ≲ 100).

	Parity: reference `lanczos.py:25-117`.

	``selective=True`` replaces the fixed ``orth`` window policy with
	ω-monitored partial re-orthogonalization: full-reorthogonalization
	accuracy at a per-step cost that adapts to the spectrum (see
	:func:`lanczos_block`). Implies ``ncv = deg``.
	"""
	from .operators import aslinop

	if kwargs:
		# The reference signature swallows extra kwargs silently
		# (`lanczos.py:35`); warn instead so typos (`rtoll=`, `ncv_=`) surface.
		import warnings

		warnings.warn(f"lanczos() ignoring unrecognized kwargs: {sorted(kwargs)}", stacklevel=2)
	op = aslinop(A, dtype=dtype)
	n = op.shape[0]
	deg = n if deg is None else min(int(deg), n)
	assert deg > 0, "Number of steps must be positive!"
	if selective:
		# ω-monitored partial reorthogonalization needs the whole basis window
		# to project against when it fires; the ω bookkeeping is slot-cyclic,
		# so a short window would silently track the wrong vectors.
		ncv = deg
	deg, orth, ncv = _validate_params(n, deg, orth, ncv, return_basis)

	f_dtype = dtype or op.dtype
	single = False
	if v0 is None:
		from .random import as_key, real_dtype

		# Random v0 is sampled REAL even for complex-Hermitian operators (the
		# Krylov space is the same; α/β stay real either way).
		v0 = jax.random.uniform(as_key(seed), (n,), dtype=real_dtype(f_dtype), minval=-1.0, maxval=1.0)
	v0 = jnp.asarray(v0, dtype=f_dtype)
	if v0.ndim == 1:
		single, v0 = True, v0[:, None]
	assert v0.shape[0] == n, "Invalid starting vector; must match the number of columns of A."

	out = lanczos_block_op(
		op, v0, deg=deg, ncv=ncv, orth=orth, rtol=rtol, reorth_passes=reorth_passes,
		return_basis=return_basis, basis_dtype=basis_dtype, selective=selective,
	)
	# Jacobi coefficients stay in the ACCUMULATION dtype: the core reduces in
	# f32 precisely so bf16/f16 operators keep accurate α/β — casting them back
	# down to the storage dtype here would throw that accuracy away (Ritz
	# values / quadrature nodes would drop to ~3 decimal digits). For complex
	# Hermitian operators α/β are REAL (documented contract; tqli/hypot and
	# the quadrature paths require it) — compare/return via the real component
	# dtype, never the complex one.
	r_of = lambda dt: jnp.dtype(jnp.finfo(dt).dtype) if jnp.dtype(dt).kind == "c" else jnp.dtype(dt)  # noqa: E731
	c_dtype = r_of(f_dtype) if r_of(f_dtype).itemsize >= jnp.dtype(out.alphas.dtype).itemsize else out.alphas.dtype
	a = out.alphas.astype(c_dtype)  # (deg, nv)
	b = out.betas[: deg - 1].astype(c_dtype)  # (deg-1, nv)
	Q = None
	if return_basis:
		# Rearrange ring-buffer slots into natural order: slot s holds q_t with
		# t ≡ s (mod ncv), so the last ncv vectors q_{deg-ncv}..q_{deg-1} start
		# at slot deg % ncv (identity when ncv == deg — slots never wrap).
		Qw = jnp.roll(out.Q, -(deg % ncv), axis=0) if ncv < deg else out.Q
		Q = jnp.moveaxis(Qw, 0, -1)  # (n, nv, ncv)
	if single:
		a, b = a[:, 0], b[:, 0]
		Q = Q[:, 0, :] if Q is not None else None
	elif Q is not None:
		Q = jnp.moveaxis(Q, 1, 0)  # (nv, n, ncv)

	if sparse_mat:
		T = _tridiag_matrix(a, b)
		return T if not return_basis else (T, Q)
	return (a, b) if not return_basis else ((a, b), Q)


def _tridiag_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
	"""Densify Jacobi coefficients into (.., deg, deg) tridiagonal matrices."""
	a = jnp.atleast_2d(a.T)  # (nv, deg) or (1, deg)
	b = jnp.atleast_2d(b.T)
	T = jax.vmap(lambda ai, bi: jnp.diag(ai) + jnp.diag(bi, 1) + jnp.diag(bi, -1))(a, b)
	return T[0] if T.shape[0] == 1 else T


def rayleigh_ritz(
	A,
	deg: Optional[int] = None,
	return_eigenvectors: bool = False,
	method: str = "auto",
	**kwargs,
) -> Union[jnp.ndarray, tuple]:
	"""Rayleigh-Ritz eigenvalue approximations via Lanczos + tridiagonal eigensolve.

	Parity: reference `lanczos.py:120-164`. ``method`` selects the tridiagonal
	solver ("auto"/"eigh" → batched dense `jnp.linalg.eigh` on the deg×deg Jacobi
	matrix; "tqli" → the O(1)-space implicit-shift QL solver).
	"""
	n = A.shape[0]
	deg = n if deg is None else min(int(deg), n)
	deg = int(np.clip(deg, 2, n))
	Q_basis = kwargs.pop("return_basis", False)
	if Q_basis:
		(a, b), Q = lanczos(A, deg=deg, return_basis=True, **kwargs)
	else:
		a, b = lanczos(A, deg=deg, return_basis=False, **kwargs)

	# Batched probes come back as (deg, nv)/(deg-1, nv); the tridiagonal
	# eigensolvers take deg on the LAST axis (batch leading).
	if jnp.ndim(a) == 2:
		a, b = a.T, b.T
	if return_eigenvectors:
		rw, Y = eigh_tridiag(a, b, method=method)
		return (rw, Y) if not Q_basis else (rw, Y, Q)
	rw = eigvalsh_tridiag(a, b, method=method)
	return rw if not Q_basis else (rw, Q)


class OrthogonalPolynomialBasis:
	r"""The orthonormal polynomial basis of the spectral measure ψ(·; A, v).

	Lanczos on ``(A, v)`` is equivalent to the Stieltjes procedure on the
	(discrete) spectral measure of ``A`` localized at ``v``: the Jacobi
	coefficients (α, β) define the three-term recurrence of the polynomials
	``p_0, p_1, ..., p_{deg-1}`` orthonormal w.r.t. ψ. This class bundles those
	coefficients with vectorized evaluation, Gauss nodes/weights, and the
	associated Jacobi matrix.

	Parity note: the reference *plans* this class (commented import in
	``src/primate/__init__.py``: ``from .lanczos import
	OrthogonalPolynomialBasis, ...``) but never ships it; the evaluation
	recurrence is its Pythran ``ortho_poly`` (``fttr.py:5-11``).

	Construct either from an operator (runs a Lanczos sweep) or directly from
	coefficients::

	    basis = OrthogonalPolynomialBasis(A, deg=16, seed=0)   # Stieltjes via Lanczos
	    P = basis(x)                # (len(x), deg) polynomial values
	    theta, tau = basis.gauss_quadrature()

	If Lanczos terminates early (invariant subspace: β_k ≈ 0), the basis is
	truncated to the k polynomials that exist — only they are well defined for
	the measure; past that point the recurrence would divide by ~0.
	"""

	def __init__(
		self,
		A=None,
		deg: Optional[int] = None,
		*,
		alphas=None,
		betas=None,
		mu_0: float = 1.0,
		betas_kind: str = "auto",
		**kwargs,
	):
		if A is not None:
			assert alphas is None and betas is None, "Pass either an operator or coefficients, not both"
			alphas, betas = lanczos(A, deg=deg, **kwargs)
		assert alphas is not None and betas is not None, "Need an operator or (alphas, betas)"
		self.alphas = jnp.asarray(alphas)
		assert self.alphas.ndim == 1, "Batched coefficient sets not supported; construct one basis per probe"
		b = jnp.asarray(betas)
		deg_ = self.alphas.shape[-1]
		# Resolve the betas layout to leading-slot (b[0] unused, b[i] couples
		# p_{i-1}→p_i). (deg,)-length input is AMBIGUOUS — it could be
		# leading-slot or lanczos_block's trailing-residual (β_1..β_deg) — so it
		# must be labeled explicitly; shape-guessing would silently shift every
		# coupling by one for the other convention.
		if betas_kind == "auto":
			assert b.shape[-1] == deg_ - 1, (
				f"betas of length {b.shape[-1]} with {deg_} alphas is ambiguous; pass the (deg-1,) "
				"off-diagonals (lanczos() output), or set betas_kind='leading' (b[0] unused) or "
				"'trailing' (lanczos_block output β_1..β_deg, last = residual)"
			)
			b = jnp.concatenate([jnp.zeros_like(b[..., :1]), b], axis=-1)
		elif betas_kind == "offdiag":
			assert b.shape[-1] == deg_ - 1, f"offdiag betas must have length deg-1={deg_ - 1}"
			b = jnp.concatenate([jnp.zeros_like(b[..., :1]), b], axis=-1)
		elif betas_kind == "leading":
			assert b.shape[-1] == deg_, f"leading-slot betas must have length deg={deg_}"
		elif betas_kind == "trailing":
			assert b.shape[-1] == deg_, f"trailing betas must have length deg={deg_}"
			b = jnp.concatenate([jnp.zeros_like(b[..., :1]), b[..., : deg_ - 1]], axis=-1)
		else:
			raise ValueError(f"Unknown betas_kind {betas_kind!r}; use 'auto'|'offdiag'|'leading'|'trailing'")
		# Truncate at the first negligible coupling: an early-terminated Lanczos
		# sweep (invariant subspace) defines only the polynomials up to that
		# point; keeping more would divide by ~0 in the recurrence → inf/NaN.
		b_np = np.asarray(b, float)
		scale = max(float(np.abs(np.asarray(self.alphas)).max(initial=0.0)), float(np.abs(b_np).max(initial=0.0)), 1.0)
		tiny = np.abs(b_np[1:]) <= 1e-12 * scale
		if tiny.any():
			k = int(np.argmax(tiny)) + 1  # keep p_0..p_{k-1}
			self.alphas, b = self.alphas[:k], b[:k]
		self.betas = b
		self.mu_0 = float(mu_0)  # total mass of the measure (1 for a unit start vector)

	@property
	def deg(self) -> int:
		return int(self.alphas.shape[-1])

	def __len__(self) -> int:
		return self.deg

	def __call__(self, x) -> jnp.ndarray:
		"""Evaluate ``[p_0(x), ..., p_{deg-1}(x)]`` → shape ``x.shape + (deg,)``."""
		from .fttr import ortho_poly

		return ortho_poly(x, 1.0 / np.sqrt(self.mu_0), self.alphas, self.betas)

	def jacobi_matrix(self) -> jnp.ndarray:
		"""The deg×deg symmetric tridiagonal (Jacobi) matrix of the recurrence."""
		return _tridiag_matrix(self.alphas, self.betas[1:])

	def gauss_quadrature(self, quad: str = "gw"):
		"""Nodes and weights of the deg-point Gauss rule for ψ (weights × mu_0)."""
		from .integrate import quadrature

		theta, tau = quadrature(self.alphas, self.betas[1:], quad=quad)
		return theta, tau * self.mu_0
