"""Stochastic trace estimators: Girard-Hutchinson, Hutch++, XTrace.

Parity: reference ``src/primate/trace.py`` (`hutch`, `hutchpp`, `xtrace`).

Accelerator design:
  * **hutch** compiles to ONE device program: a `lax.while_loop` whose
    condition evaluates the composed convergence criterion on-device and whose
    body draws a threefry probe batch, applies the operator as a single
    GEMM/SpMM, and merges the quadratic forms into a Welford covariance state.
    No host round-trips until the loop exits (the reference re-enters Python
    every batch, `trace.py:107-116`). A host-stepped path (one jitted step per
    batch) is used only when a per-batch ``callback`` is requested.
  * **hutchpp** is one fused program: sketch, QR-deflate, and both trace terms.
  * **xtrace** replaces the reference's serial per-column `qr_insert` +
    rank-one triangular updates (`trace.py:296-301`) with **block** QR append
    (CGS2 + local QR — all GEMMs) and a block triangular-inverse update; the
    leave-one-out exchangeability identities (`trace.py:185-227`) are kept
    mathematically verbatim as batched einsums. The reference's
    "converge |= ..." self-OR quirk (`trace.py:273-275`) is deliberately fixed:
    a user criterion ORs with the m == n exactness stop.
"""

from functools import partial
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .estimators import (
	ConvergenceCriterion,
	CountCriterion,
	EstimatorResult,
	EstSnapshot,
	MeanEstimator,
	convergence_criterion,
	criterion_needs_values,
	default_trace_criterion,
	is_jittable_criterion,
	note_capped,
)
from .linalg import colwise_dot, qr_append, tall_qr, update_trinv_block


def _reject_stacked(op, name: str) -> None:
	"""Sketch estimators deflate through QR of ``A @ W`` — a stacked operator
	(family-valued matmat) has no single range to sketch. Fail at entry with a
	clear message instead of a shape error deep in the Lanczos core; `hutch` /
	`diag` DO support stacked operators (shared-sweep families)."""
	if getattr(op, "stack_shape", ()) or ():
		raise NotImplementedError(
			f"{name} does not support stacked (family-valued) operators; use hutch/diag "
			"for shared-sweep families, or run one estimator per family member."
		)
from .operators import aslinop, is_valid_operator, quad_form
from .random import as_key, classify_pdf, real_dtype, sample_isotropic
from .stats import CovState, cov_matrix, cov_update, make_cov_state

__all__ = ["hutch", "hutchpp", "xnystrace", "xtrace"]

def _hiprec_trace(fn):
	"""Trace the wrapped program under full matmul precision: the sketch /
	leave-one-out identities are exact algebra, and a reduced-precision matmul
	default (TF32 on the GPU) costs digits (see linalg._hiprec)."""
	import functools

	@functools.wraps(fn)
	def wrapped(*a, **k):
		with jax.default_matmul_precision("highest"):
			return fn(*a, **k)

	return wrapped



class _HutchCarry(NamedTuple):
	it: jnp.ndarray  # () int32 — batches executed
	cov: CovState  # dim-d Welford state (d = 1, or nt for a stacked quad)
	delta: jnp.ndarray  # (d,) last mean movement
	values: Optional[jnp.ndarray]  # (maxiter*batch,) recorded samples or None


def _carry_snapshot(c: _HutchCarry) -> EstSnapshot:
	# Scalar variance proxy: mean of the per-output sample variances (for a
	# scalar estimate this IS the sample variance; for a stacked estimate it
	# plays the same role as diag's dim-N proxy).
	var = jnp.mean(jnp.diagonal(cov_matrix(c.cov, ddof=1)))
	return EstSnapshot(n=c.cov.n, estimate=c.cov.mu, delta=c.delta, var=var, values=c.values)


@partial(jax.jit, static_argnames=("n", "batch", "pdf", "maxiter", "record", "dim"))
def _hutch_fused(
	A, criterion, key, init_cov=None, init_it=None, *, n: int, batch: int, pdf: str, maxiter: int, record: bool, dim: int = 1
):
	"""The fused adaptive Girard-Hutchinson program (see module docstring).

	``init_cov``/``init_it`` resume the loop from a prior Welford state: the
	probe stream is keyed by the batch index (``fold_in(key, it)``), so a
	resumed run continues the SAME sample sequence a longer fresh run would
	have drawn — checkpoint/resume is bitwise-faithful (SURVEY §5.4).
	"""
	dtype = A.dtype
	acc = jnp.promote_types(dtype, jnp.float32)
	if jnp.dtype(dtype).kind == "c":
		# Hermitian operator: estimator state is REAL (v†Av ∈ ℝ; quad_form
		# returns real). Probes are real too — unless pdf="phase", whose unit
		# phases are the complex rademacher analog (variance Σ|A_ij|²).
		acc = real_dtype(acc)
		if pdf != "phase":
			dtype = real_dtype(dtype)
	init = _HutchCarry(
		it=jnp.zeros((), jnp.int32) if init_it is None else jnp.asarray(init_it, jnp.int32),
		cov=make_cov_state(dim, acc) if init_cov is None else init_cov,
		delta=jnp.full(dim, jnp.inf, acc),
		values=jnp.full(maxiter * batch, jnp.nan, acc) if record else None,
	)

	def cond(c: _HutchCarry):
		return jnp.logical_and(c.it < maxiter, jnp.logical_not(criterion.check(_carry_snapshot(c))))

	def body(c: _HutchCarry):
		k = jax.random.fold_in(key, c.it)
		V = sample_isotropic(k, (n, batch), pdf=pdf, dtype=dtype)
		s = quad_form(A, V).astype(acc)  # (batch,) — or (nt..., batch) stacked
		new_cov = cov_update(c.cov, s.reshape(dim, batch).T if s.ndim > 1 else s[:, None])
		delta = new_cov.mu - c.cov.mu
		values = None
		if record:  # dim == 1 here (guarded in the driver); flatten any (1, batch) stack
			values = lax.dynamic_update_slice(c.values, s.reshape(-1), (c.it * batch,))
		return _HutchCarry(it=c.it + 1, cov=new_cov, delta=delta, values=values)

	final = lax.while_loop(cond, body, init)
	# Surface budget-capped stops: a run that exhausted `maxiter` with the
	# criterion still unmet must not masquerade as converged.
	capped = jnp.logical_and(final.it >= maxiter, jnp.logical_not(criterion.check(_carry_snapshot(final))))
	return final, capped


@partial(jax.jit, static_argnames=("n", "batch", "pdf"))
def _hutch_step(A, key, it, *, n: int, batch: int, pdf: str):
	"""One probe batch -> quadratic-form samples (host-stepped callback path)."""
	k = jax.random.fold_in(key, it)
	s_dtype = A.dtype if pdf == "phase" else real_dtype(A.dtype)
	V = sample_isotropic(k, (n, batch), pdf=pdf, dtype=s_dtype)
	return quad_form(A, V)


_quad_form_jit = jax.jit(quad_form)  # host-sampled probe blocks ("size"-style pdfs)


def hutch(
	A,
	batch: int = 32,
	pdf: Union[str, Callable] = "rademacher",
	converge: Union[str, ConvergenceCriterion] = "default",
	seed=None,
	full: bool = False,
	callback: Optional[Callable] = None,
	maxiter: int = 1024,
	resume=None,
	**kwargs,
) -> Union[float, tuple]:
	r"""Estimate ``tr(A)`` for symmetric ``A`` via the Girard-Hutchinson estimator.

	Monte-Carlo average of isotropic quadratic forms ``vᵀAv``; unbiased for any
	isotropic probe distribution. Composes with :class:`MatrixFunction` to give
	stochastic Lanczos quadrature for ``tr(f(A))`` (logdet, Estrada, ...), in
	which case the operator's batched ``quad`` is used directly.

	Parameters mirror the reference (`trace.py:34-116`): ``batch`` probes per
	iteration, ``pdf`` in {rademacher, normal, sphere}, ``converge`` a criterion
	name/instance (default: 200 samples OR 95% CI within ±1.0), ``seed`` any
	int / numpy Generator / JAX key, ``full`` to also return an
	:class:`EstimatorResult`, ``callback`` invoked per batch, ``maxiter`` an
	upper bound on TOTAL batches incl. resumed ones (needed for the
	statically-shaped record buffer).

	``differentiable=True`` (with ``converge='count'``) switches to a traced
	fixed-budget path that composes with ``jax.grad``/``jit`` — probes run in
	``batch``-sized chunks, ``maxiter`` caps the budget; see
	:mod:`primate_tpu.autodiff` and ``docs/guide_autodiff.md``.

	``resume`` continues a previous run exactly (SURVEY §5.4 checkpoint/resume):
	pass the :class:`EstimatorResult` (or its estimator) from an earlier
	``full=True`` call made with the SAME ``A``/``seed``/``batch``/``pdf`` — the
	probe stream is keyed by batch index, so resuming to a larger budget yields
	bit-identical estimates to one uninterrupted run. The Welford state is a
	tiny pytree; persist it across processes with
	:func:`primate_tpu.utils.checkpoint.save_pytree` on
	``result.estimator._moments._state``.
	"""
	is_valid_operator(A)
	op = A if hasattr(A, "quad") else aslinop(A)
	N = op.shape[0]
	record = kwargs.pop("record", False)
	differentiable = kwargs.pop("differentiable", False)
	assert batch >= 1, "Batch size must be positive."

	if differentiable:
		# Reverse-differentiable fixed-budget path (custom_vjp; see autodiff.py).
		# The adaptive while_loop is not reverse-differentiable, so this requires
		# a count criterion and draws the whole budget as ONE probe block (the
		# probe stream therefore differs from the batch-looped fused path).
		# Returns a traced 0-d array, composing with jax.grad/jit.
		grad_opts = {k: kwargs.pop(k) for k in ("grad_method", "fprime", "solver_rtol", "solver_maxiter") if k in kwargs}
		criterion = convergence_criterion("count", **kwargs) if converge in ("default", "count") else convergence_criterion(converge, **kwargs)
		assert isinstance(criterion, CountCriterion), (
			"differentiable=True needs a fixed probe budget: pass converge='count', count=m "
			"(adaptive criteria live inside a lax.while_loop, which is not reverse-differentiable)"
		)
		assert callback is None and resume is None and not record and not full, (
			"differentiable=True is a pure traced-scalar path: callback/resume/record/full are unavailable"
		)
		assert classify_pdf(pdf) != "size", "differentiable=True needs a named pdf (rademacher/normal/sphere)"
		# Honor batch and maxiter like the fused loop does: probes run in
		# batch-sized chunks (O(n·batch) memory via the chunked custom_vjp —
		# review r4: a single (n, count) block OOMs where the batched
		# non-differentiable path runs fine), and maxiter caps total batches.
		nv = min(int(criterion.count), int(maxiter) * int(batch))
		note_capped(nv < int(criterion.count), maxiter, name="hutch")
		from .operators.special_ops import MatrixFunction

		if isinstance(op, MatrixFunction):
			from .autodiff import spectral_sum

			return spectral_sum(op, nv=nv, pdf=pdf, seed=seed, chunk=int(batch), **grad_opts)
		# Plain trace: mean of quadratic forms — differentiable as-is through
		# the operator's matmat (d tr(A) = tr(dA), no Lanczos involved). Probes
		# run in batch-sized chunks inside a lax.map so this branch keeps the
		# same O(n·batch) memory bound as the MatrixFunction route.
		key = as_key(seed)
		nchunks = -(-nv // int(batch))

		def _one(i):
			Z = sample_isotropic(jax.random.fold_in(key, i), (N, int(batch)), pdf=pdf, dtype=real_dtype(op.dtype))
			return jnp.mean(quad_form(op, Z.astype(op.dtype)), axis=-1)

		return jnp.mean(jax.lax.map(_one, jnp.arange(nchunks)), axis=0)

	if converge == "default":
		criterion = default_trace_criterion()
		if kwargs:
			import warnings

			warnings.warn(
				f"Ignoring criterion kwargs {sorted(kwargs)} because converge='default'; "
				"pass converge='count'/'tolerance'/'confidence'/'knee' (or a criterion "
				"instance) for them to take effect.",
				stacklevel=2,
			)
	else:
		criterion = convergence_criterion(converge, **kwargs)
	# A knee criterion reads the recorded-samples buffer; without recording it
	# would silently never fire and the loop would run to maxiter.
	record = record or criterion_needs_values(criterion)

	if int(np.prod(op.shape)) == 0:
		return 0.0 if not full else (0.0, EstimatorResult(MeanEstimator(covariance=True), criterion))

	key = as_key(seed)
	pdf_kind = classify_pdf(pdf)  # "size"-style callables sample on host per batch

	# A STACKED spectral function (operator.quad returns (nt..., batch), see
	# special.stacked) estimates the whole family from the shared sweeps: the
	# Welford state becomes nt-dimensional and the estimate an (nt...,) array.
	# Operators that know their stack shape statically (MatrixFunction,
	# ChebyshevFunction, plain quadratic forms) skip the `eval_shape` probe —
	# tracing the whole quad program costs ~34 ms of host time PER CALL at
	# deg 20 / n = 500k, several times the device time of the estimate itself.
	stack_shape = getattr(op, "stack_shape", None)
	if stack_shape is None:
		s_aval = jax.eval_shape(quad_form, op, jax.ShapeDtypeStruct((N, int(batch)), op.dtype))
		stack_shape = s_aval.shape[:-1]
	stack_shape = tuple(stack_shape)
	dim = int(np.prod(stack_shape)) if stack_shape else 1
	if dim > 1 and record:
		raise NotImplementedError("record=True (and knee criteria) require a scalar-valued quad; got a stacked one.")

	init_cov = init_it = None
	resume_est = None
	if resume is not None:
		if record:
			raise NotImplementedError("resume does not carry a recorded-samples buffer; run with record=False.")
		resume_est = resume.estimator if isinstance(resume, EstimatorResult) else resume
		assert isinstance(resume_est, MeanEstimator), "resume expects an EstimatorResult or MeanEstimator"
		st = resume_est._moments._state
		assert isinstance(st, CovState), "resume needs a covariance-tracking estimator (hutch's full=True output)"
		assert st.mu.shape[0] == dim, f"resume state dim {st.mu.shape[0]} != quad dim {dim}"
		n_seen = int(st.n)
		assert n_seen % int(batch) == 0, (
			f"resume state has {n_seen} samples, not a multiple of batch={batch}; "
			"resume with the batch size the original run used"
		)
		acc = real_dtype(jnp.promote_types(op.dtype, jnp.float32))  # estimator state is real even for Hermitian ops
		init_cov = CovState(n=jnp.asarray(st.n, jnp.int32), mu=jnp.asarray(st.mu, acc), S=jnp.asarray(st.S, acc))
		init_it = n_seen // int(batch)

	if callback is None and is_jittable_criterion(criterion) and pdf_kind != "size":
		carry, capped = _hutch_fused(
			op, criterion, key, init_cov, init_it,
			n=N, batch=int(batch), pdf=pdf, maxiter=int(maxiter), record=record, dim=dim,
		)
		# ONE device→host transfer for the whole final carry: every later read
		# is host numpy (each separate pull is its own device→host sync).
		carry, capped = jax.device_get((carry, capped))
		estimator = MeanEstimator.from_state(carry.cov, delta=carry.delta, values=carry.values)
		if int(carry.cov.n) == 0:
			estimate = np.nan
		elif dim == 1 and not stack_shape:
			estimate = float(np.asarray(carry.cov.mu)[0])
		else:
			estimate = np.asarray(carry.cov.mu).reshape(stack_shape)
		if not full:
			note_capped(bool(capped), maxiter, name="hutch")
			return estimate
		result = EstimatorResult(
			estimator=estimator,
			criterion=criterion,
			estimate=estimate,
			message=getattr(criterion, "message", lambda e: "")(estimator),
			nit=int(carry.cov.n),
		)
		note_capped(bool(capped), maxiter, result, name="hutch")
		return estimate, result

	# Host-stepped path: jitted batch step + per-batch callback (also the
	# fallback for user criteria that are not registered pytrees).
	# Copy the resumed state: updating the caller's estimator in place would
	# corrupt a second resume from the same snapshot.
	estimator = (
		MeanEstimator.from_state(resume_est._moments._state, delta=resume_est.delta)
		if resume_est is not None
		else MeanEstimator(dim=dim, covariance=True, record=record)
	)
	result = EstimatorResult(estimator, criterion)
	it = 0 if init_it is None else int(init_it)
	while not bool(criterion(estimator)) and it < maxiter:
		if pdf_kind == "size":
			# Reference hot-loop semantics (`trace.py:114-115`): the stateful
			# closure draws on host; only the quadratic forms run on device.
			V = jnp.asarray(np.asarray(pdf(size=(N, int(batch)))), dtype=real_dtype(op.dtype))
			samples = np.asarray(_quad_form_jit(op, V.astype(op.dtype)))
		else:
			samples = np.asarray(_hutch_step(op, key, it, n=N, batch=int(batch), pdf=pdf))
		estimator.update(samples.reshape(dim, -1).T if samples.ndim > 1 else samples)
		result.estimate = estimator.estimate
		result.nit = estimator.n_samples
		if callback is not None:
			callback(result)
		it += 1
	result.message = getattr(criterion, "message", lambda e: "")(estimator)
	result.estimate = estimator.estimate
	# nit counts SAMPLES HELD (matches the fused path), not loop turns — a
	# resumed estimator that already satisfies the criterion reports its
	# accumulated count instead of 0.
	result.nit = estimator.n_samples
	note_capped(it >= maxiter and not bool(criterion(estimator)), maxiter, result if full else None, name="hutch")
	return (estimator.estimate, result) if full else estimator.estimate


@partial(jax.jit, static_argnames=("n", "nb", "pdf", "mode"))
@_hiprec_trace
def _hutchpp_program(A, key, *, n: int, nb: int, pdf: str, mode: str):
	"""Fused Hutch++: low-rank sketch trace + Girard-Hutchinson on the deflation.

	Hermitian (complex) operators: probes are sampled REAL, every bra is
	conjugated (``Q†AQ``, ``Q†G``, ``G†AG``), and all estimates come out real.
	"""
	dtype = A.dtype
	is_cplx = jnp.dtype(dtype).kind == "c"
	k1, k2 = jax.random.split(key)
	s_dtype = dtype if pdf == "phase" else real_dtype(dtype)  # phase probes ARE complex
	W = sample_isotropic(k1, (n, nb), pdf=pdf, dtype=s_dtype).astype(dtype)
	Y = A.matmat(W) if hasattr(A, "matmat") else A @ W
	Q, _ = tall_qr(Y)  # shifted CholeskyQR3 for the tall sketch
	if mode == "full":
		AQ = A.matmat(Q) if hasattr(A, "matmat") else A @ Q
		rng_ests = jnp.real(jnp.einsum("ij,ij->j", jnp.conj(AQ), Q)) if is_cplx else jnp.einsum("ij,ij->j", AQ, Q)
	else:
		rng_ests = quad_form(A, Q)
	G = sample_isotropic(k2, (n, nb), pdf=pdf, dtype=s_dtype).astype(dtype)
	G = G - Q @ ((jnp.conj(Q) if is_cplx else Q).T @ G)
	AG = A.matmat(G) if hasattr(A, "matmat") else A @ G
	defl_ests = jnp.real(jnp.einsum("ij,ij->j", jnp.conj(G), AG)) if is_cplx else jnp.einsum("ij,ij->j", AG, G)
	est = jnp.sum(rng_ests) + jnp.sum(defl_ests) / nb
	return est, rng_ests, defl_ests


def hutchpp(
	A,
	m: Optional[int] = None,
	batch: int = 32,
	mode: str = "reduced",
	pdf: Union[str, Callable] = "rademacher",
	seed=None,
	full: bool = False,
	converge: Union[str, ConvergenceCriterion, None] = None,
	**kwargs,
) -> Union[float, tuple]:
	"""Hutch++ trace estimator: rank-``nb`` deflation + residual Hutchinson.

	Uses ``3·nb`` operator applications — sketch ``A·W``, exact term ``A·Q``,
	deflated probes ``A·G`` — with ``nb = m`` (or ``N // 3``) rounded up to a
	multiple of 3 (reference `trace.py:119-182`; NOTE the reference documents
	and reports "2·nb" while performing the same three passes — an undercount
	consciously not replicated, and ``nit`` here is the honest 3·nb). O(1/m)
	error vs Hutchinson's O(1/√m) on PSD matrices. One fused device program.

	**Adaptive mode** (beyond reference — the reference's hutchpp is strictly
	non-adaptive): pass ``converge`` (+criterion kwargs) to replace the fixed
	``nb`` deflated probes with the full adaptive :func:`hutch` machinery on the
	projected remainder ``P A P`` (``P = I − QQᵀ``, a
	:class:`~primate_tpu.operators.DeflatedOperator`): the residual loop stops
	on-device exactly when the criterion is met — the A-Hutch++ pattern of
	spending the variable budget where the variance actually is. ``full=True``
	returns the residual loop's EstimatorResult with the estimate shifted by the
	exact sketch term (``result.info['sketch_trace']``).
	"""
	assert batch >= 1, "Batch size must be positive."
	differentiable = kwargs.pop("differentiable", False)
	is_valid_operator(A)
	op = A if hasattr(A, "quad") else aslinop(A)
	N = op.shape[0]
	if int(np.prod(op.shape)) == 0:
		return 0.0 if not full else (0.0, EstimatorResult())
	_reject_stacked(op, "hutchpp")
	if classify_pdf(pdf) == "size":
		raise NotImplementedError("hutchpp samples inside one fused program; pass a jax-style pdf(key, shape, dtype) callable.")
	nb = (N // 3) if m is None else int(m)
	nb = max(3, nb + (-nb) % 3)  # round UP to a multiple of 3; ≥3 so tiny N can't divide by zero
	if differentiable:
		# Guard BEFORE the adaptive branch, which would otherwise return first
		# and silently drop the flag (eager) or die in a ConcretizationTypeError
		# deep inside the sketch (under jax.grad).
		assert converge is None and not full, (
			"hutchpp(differentiable=True) is the fixed non-adaptive program only: "
			"drop converge=/full= (the adaptive A-Hutch++ loop is not reverse-differentiable)"
		)
	if converge is not None:
		from .operators import DeflatedOperator

		key = as_key(seed)
		k1, k2 = jax.random.split(key)
		W = sample_isotropic(k1, (N, nb), pdf=pdf, dtype=op.dtype if pdf == "phase" else real_dtype(op.dtype)).astype(op.dtype)
		Y = op.matmat(W) if hasattr(op, "matmat") else op @ W
		acc = jnp.promote_types(op.dtype, jnp.float32)
		Q, _ = tall_qr(Y.astype(acc))
		Q = Q.astype(op.dtype)
		AQ = op.matmat(Q) if hasattr(op, "matmat") else op @ Q
		sketch_trace = float(jnp.real(jnp.einsum("ij,ij->", jnp.conj(AQ.astype(acc)), Q.astype(acc))))
		defl = DeflatedOperator(op, Q, fill=0.0)
		rest = hutch(defl, batch=batch, pdf=pdf, converge=converge, seed=k2, full=full, **kwargs)
		if not full:
			return sketch_trace + rest
		rest_est, result = rest
		result.estimate = sketch_trace + rest_est
		result.info["sketch_trace"] = sketch_trace
		result.info["sketch_rank"] = nb
		result.nit += 2 * nb  # honest total: the sketch/deflate applications count too
		return result.estimate, result
	est, rng_ests, defl_ests = _hutchpp_program(op, as_key(seed), n=N, nb=nb, pdf=pdf, mode=mode)
	if differentiable:
		# Fixed fused program (sketch GEMMs + QR + deflated probes — no
		# while_loop): jax.grad through it is the EXACT derivative of the
		# estimator. Return the traced scalar (guards above).
		return est
	est = float(est)
	if not full:
		return est
	result = EstimatorResult()
	result.estimate = est
	result.nit = 3 * nb  # honest matvec count (see docstring)
	result.samples = np.concatenate([np.asarray(rng_ests), np.asarray(defl_ests)])
	return est, result


@partial(jax.jit, static_argnames=("n", "m", "pdf"))
@_hiprec_trace
def _xnystrace_program(A, key, *, n: int, m: int, pdf: str):
	"""Fused XNysTrace: all m leave-one-out Nyström estimates in one program.

	Let Ω be the n×m test matrix, Y = (A+νI)Ω (ν a tiny stabilizing shift),
	H = ΩᵀY, P = H⁻¹ and G = YᵀY. Leaving column i out, the Nyström trace and
	its single-probe Hutchinson correction collapse (via the Schur complement
	of P at entry i and PH = I) to

	    t_i = tr(PG) + (1 − (PGP)_{ii}) / P_{ii} − ν·n,

	evaluated stably through the Cholesky factor L of H: with B = Y·L⁻ᵀ,
	tr(PG) = ‖B‖²_F, (PGP)_{ii} = ‖(B·L⁻¹)_{:,i}‖², P_{ii} = ‖L⁻¹_{:,i}‖².
	Everything is dense GEMMs + two triangular solves — no per-probe loop.
	"""
	dtype = A.dtype
	acc = jnp.promote_types(dtype, jnp.float32)
	r_acc = real_dtype(acc)
	Om = sample_isotropic(key, (n, m), pdf=pdf, dtype=dtype if pdf == "phase" else real_dtype(dtype)).astype(dtype)
	Y = (A.matmat(Om) if hasattr(A, "matmat") else A @ Om).astype(acc)
	Om = Om.astype(acc)
	# Shift: makes H=Ω†Y safely PD when A is merely PSD (Epperly's ν·eps trick);
	# the bias ν·n is subtracted exactly at the end.
	nu = jnp.finfo(r_acc).eps * jnp.linalg.norm(Y) / jnp.sqrt(jnp.asarray(n, r_acc))
	Y = Y + nu * Om
	H = jnp.conj(Om).T @ Y
	L = jnp.linalg.cholesky(0.5 * (H + jnp.conj(H).T))
	# One small (m×m) triangular inverse, then GEMMs: a triangular solve with an
	# (m, n) right-hand side is sequential back-substitution — the worst shape
	# for a parallel device — while Y @ L⁻ᵀ is a plain GEMM. m ≪ n and H is
	# shift-stabilized, so the explicit inverse is numerically safe here.
	L_inv = jax.scipy.linalg.solve_triangular(L, jnp.eye(m, dtype=acc), lower=True)
	B = Y @ jnp.conj(L_inv).T  # = Y L^{-H}
	BL = B @ L_inv  # = B L^{-1}
	tr_pg = jnp.sum(jnp.abs(B) ** 2) if jnp.iscomplexobj(B) else jnp.sum(B * B)
	pgp = jnp.sum(jnp.abs(BL) ** 2, axis=0) if jnp.iscomplexobj(BL) else jnp.sum(BL * BL, axis=0)  # diag(PGP)
	p = jnp.sum(jnp.abs(L_inv) ** 2, axis=0) if jnp.iscomplexobj(L_inv) else jnp.sum(L_inv * L_inv, axis=0)
	t = tr_pg + (1.0 - pgp) / p - nu * n
	return t


def xnystrace(
	A,
	m: Optional[int] = None,
	pdf: Union[str, Callable] = "normal",
	seed=None,
	full: bool = False,
	differentiable: bool = False,
) -> Union[float, tuple]:
	"""XNysTrace: leave-one-out Nyström trace estimator for **PSD** operators.

	The Nyström-based sibling of :func:`xtrace` (Epperly-Tropp-Webber 2023,
	"XTrace: making the most of every sample", alg. for PSD matrices): each of
	the ``m`` probes doubles as a test vector for the Nyström sketch built from
	the *other* ``m−1`` probes, so an ``m``-matvec budget yields ``m``
	exchangeable unbiased samples — half the matvecs of XTrace per sample.
	Exact (to rounding) whenever ``rank(A) < m``. Requires ``A ⪰ 0``; a tiny
	spectral shift keeps the sketch Cholesky stable near singularity.

	No incremental-QR analog exists in the reference (`src/primate/trace.py`
	implements hutch/hutchpp/xtrace only) — this is a beyond-reference
	capability; the fused program is three GEMMs + two triangular solves.

	``m`` defaults to ``N // 3`` matvecs (comparable accuracy to the
	:func:`hutchpp` default at 2/3 its matvec budget on fast-decaying spectra).
	"""
	is_valid_operator(A)
	op = A if hasattr(A, "quad") else aslinop(A)
	N = op.shape[0]
	if int(np.prod(op.shape)) == 0:
		return 0.0 if not full else (0.0, EstimatorResult())
	_reject_stacked(op, "xnystrace")
	if N < 3:
		# The leave-one-out sketch needs m ≥ 2 AND m ≤ N; below that the
		# operator is tiny — N matvecs against the identity give the exact trace.
		est = float(jnp.sum(quad_form(op, jnp.eye(N, dtype=op.dtype))).real)
		if not full:
			return est
		result = EstimatorResult()
		result.estimate = est
		result.nit = N
		return est, result
	m_ = (N // 3) if m is None else int(m)
	m_ = min(max(2, m_), N)  # ≥2 so every leave-one-out sketch is nonempty, ≤N always
	if classify_pdf(pdf) == "size":
		raise NotImplementedError("xnystrace samples inside one fused program; pass a jax-style pdf(key, shape, dtype) callable.")
	if differentiable:
		# Fixed fused program (Nyström sketch + Cholesky/triangular algebra):
		# jax.grad through it is the EXACT derivative of the estimator.
		assert not full, "differentiable=True returns the traced estimate only"
		return jnp.mean(_xnystrace_program(op, as_key(seed), n=N, m=m_, pdf=pdf))
	t_samples = jax.device_get(_xnystrace_program(op, as_key(seed), n=N, m=m_, pdf=pdf))
	estimator = MeanEstimator(covariance=True)
	estimator.update(t_samples)
	est = float(estimator.estimate)
	if not full:
		return est
	result = EstimatorResult(estimator=estimator)
	result.estimate = est
	result.nit = m_
	result.samples = np.asarray(t_samples)
	return est, result



@jax.jit
@_hiprec_trace
def _xtrace_estimates(W, Z, Q, R, R_inv, sphere: jnp.ndarray):
	"""Epperly's leave-one-out trace identities, batched over all m probes.

	Mathematically identical to reference `trace.py:185-227`; evaluated as a
	fixed set of (m × m) GEMMs + column-wise reductions on-device.

	Complex-Hermitian generalization: every bra is conjugated (``W_proj = Q†W``,
	``S`` built from ``R⁻ᴴ``, conjugated columnwise dots), and the two cross
	terms carry ``conj(dSW)·dSRmHW`` / ``dTmHRS·dSW`` — derived by expanding
	``ω̂†Aω̂`` with ``ω̂ = (I − Q₋ᵢQ₋ᵢ†)ωᵢ`` and ``Aω̂ = Yeᵢ − Z(w − s·s†w)``;
	probes stay real and the estimates come out real. For real operators every
	``conj`` is an identity, so the lowering is unchanged.
	"""
	n, m = W.shape
	r_dtype = jnp.real(W).dtype
	cdot = colwise_dot  # diag(X†Y), (m, 1)
	W_proj = jnp.conj(Q).T @ W
	S = jnp.conj(R_inv).T / jnp.linalg.norm(R_inv, axis=1)[None, :]  # cols ∝ R⁻ᴴeᵢ (unit columns)

	dSW = cdot(S, W_proj)
	c = n - m + 1
	# (S's columns are unit-norm by construction — the reference's col_norm(S)
	# factor is identically 1 and is dropped here.)
	sphere_scale = c / (n - jnp.linalg.norm(W_proj, axis=0)[:, None] ** 2 + jnp.abs(dSW) ** 2)
	scale = jnp.where(sphere, sphere_scale, jnp.ones((m, 1), r_dtype))

	H = jnp.conj(Q).T @ Z
	HW = H @ W_proj
	T = jnp.conj(Z).T @ W
	dSHS = cdot(S, H @ S)
	dTW = cdot(T, W_proj)
	dWHW = cdot(W_proj, HW)
	dSRmHW = cdot(S, R - HW)
	dTmHRS = cdot(T - jnp.conj(H).T @ W_proj, S)

	tr_ests = jnp.trace(H) * jnp.ones((m, 1), H.dtype) - dSHS
	tr_ests += (-dTW + dWHW + jnp.conj(dSW) * dSRmHW + jnp.abs(dSW) ** 2 * dSHS + dTmHRS * dSW) * scale
	return jnp.real(tr_ests[:, 0])


def _count_only_target(criterion) -> Optional[int]:
	"""The effective stop count of a criterion that depends ONLY on the number
	of samples (CountCriterion and and/or compositions thereof), else None.

	Such criteria make the XTrace growth schedule fully predetermined, so the
	per-round leave-one-out recomputation + host sync can be skipped — only the
	final round's estimates matter (they are recomputed wholesale each round).
	"""
	from .estimators import AndCriterion, OrCriterion

	if isinstance(criterion, CountCriterion):
		return int(criterion.count)
	if isinstance(criterion, (OrCriterion, AndCriterion)):
		a, b = _count_only_target(criterion.left), _count_only_target(criterion.right)
		if a is None or b is None:
			return None
		return min(a, b) if isinstance(criterion, OrCriterion) else max(a, b)
	return None


@_hiprec_trace
def _xtrace_round_impl(op, W, Z, Q, R, R_inv, key, it, *, ns: int, pdf: str, with_estimates: bool):
	"""One XTrace growth round: sample → matmat → block QR append →
	triangular-inverse update (→ leave-one-out estimates).

	The single source of truth for a round — `_xtrace_round` is this body
	under `jax.jit` (used on accelerators, where eager dispatch of the ~15 ops
	costs a launch EACH); the CPU path calls it directly to avoid a compile per
	(m, ns) shape.
	"""
	n = op.shape[0]
	apply_op = op.matmat if hasattr(op, "matmat") else (lambda V: op @ V)
	# Hermitian operators: probes are sampled REAL (carried at op.dtype so the
	# grown state stays homogeneous); conj(W) = W in the leave-one-out identities.
	Nnew = sample_isotropic(
		jax.random.fold_in(key, it), (n, ns), pdf=pdf, dtype=op.dtype if pdf == "phase" else real_dtype(op.dtype)
	).astype(op.dtype)
	Ynew = apply_op(Nnew)
	m_cur = W.shape[1]
	if m_cur == 0:
		Q, R = qr_append(None, None, Ynew)
		R_inv = update_trinv_block(jnp.zeros((0, 0), R.dtype), jnp.zeros((0, ns), R.dtype), R)
		W, Z = Nnew, apply_op(Q)
	else:
		Q, R = qr_append(Q, R, Ynew)
		B, C = R[:m_cur, m_cur:], R[m_cur:, m_cur:]
		R_inv = update_trinv_block(R_inv, B, C)
		W = jnp.concatenate([W, Nnew], axis=1)
		Z = jnp.concatenate([Z, apply_op(Q[:, -ns:])], axis=1)
	# `pdf` is static, so the sphere-vs-isotropic scale choice compiles to a
	# constant branch (a traced sphere_flag array would cost one eager
	# host→device transfer per call).
	t = _xtrace_estimates(W, Z, Q, R, R_inv, pdf == "sphere") if with_estimates else jnp.zeros(0, W.dtype)
	return (W, Z, Q, R, R_inv), t


_xtrace_round = partial(jax.jit, static_argnames=("ns", "pdf", "with_estimates"))(_xtrace_round_impl)


@_hiprec_trace
def _xtrace_chain_impl(op, key, state, it0, *, schedule: tuple, pdf: str):
	"""ALL growth rounds of a predetermined (count-only) schedule as ONE
	program: a single dispatch and a single device→host sync, vs one jitted
	program per round (each dispatch and sync has its own latency).
	``state``/``it0``
	continue a prior run (probe rounds are keyed by iteration index)."""
	for i, ns in enumerate(schedule):
		state, _ = _xtrace_round_impl(op, *state, key, it0 + i, ns=ns, pdf=pdf, with_estimates=False)
	return state, _xtrace_estimates(*state, pdf == "sphere")


_xtrace_chain = partial(jax.jit, static_argnames=("schedule", "pdf"))(_xtrace_chain_impl)


@partial(jax.jit, static_argnames=("schedule", "pdf", "n", "dtype"))
def _xtrace_chain_fresh(op, key, *, schedule: tuple, pdf: str, n: int, dtype):
	"""Fresh-start chain: the empty subspace state is created INSIDE the
	program, so a cold `xtrace(A, converge='count')` call issues exactly one
	dispatch with no preparatory eager array creations (five zero-arrays +
	flag would each cost a host→device transfer)."""
	state = (
		jnp.zeros((n, 0), dtype),  # W
		jnp.zeros((n, 0), dtype),  # Z
		jnp.zeros((n, 0), dtype),  # Q
		jnp.zeros((0, 0), dtype),  # R
		jnp.zeros((0, 0), dtype),  # R_inv
	)
	return _xtrace_chain_impl(op, key, state, jnp.zeros((), jnp.int32), schedule=schedule, pdf=pdf)


def xtrace(
	A,
	batch: int = 32,
	pdf: Union[str, Callable] = "sphere",
	converge: Union[str, ConvergenceCriterion] = "default",
	seed=None,
	full: bool = False,
	callback: Optional[Callable] = None,
	resume=None,
	**kwargs,
) -> Union[float, tuple]:
	"""XTrace: exchangeable leave-one-out trace estimator (Epperly et al.).

	Grows an orthogonal test subspace in blocks of ``batch`` columns and
	recomputes the m leave-one-out estimates each round; exact (to rounding)
	once m == n. Default stop: m == n samples; a user criterion ORs with that
	bound. Parity: reference `trace.py:233-315`.

	``resume`` continues a previous run exactly (SURVEY §5.4): pass the
	``result.info["state"]`` dict of an earlier ``full=True`` call made with
	the SAME ``A``/``seed``/``batch``/``pdf`` — probe rounds are keyed by
	iteration index and the leave-one-out estimates are recomputed wholesale
	from the grown subspace, so resuming to a larger budget is bit-identical to
	one uninterrupted run. NOTE: the state holds the (n × m) test subspace —
	persisting it costs O(n·m) storage.
	"""
	is_valid_operator(A)
	op = A if hasattr(A, "quad") else aslinop(A)
	_reject_stacked(op, "xtrace")
	n = op.shape[0]
	assert batch >= 1, "Batch size must be positive."
	record = kwargs.pop("record", False)
	differentiable = kwargs.pop("differentiable", False)
	if differentiable:
		# The predetermined-schedule chain is a FIXED composition (sample →
		# matmat → block QR append → triangular-inverse update → leave-one-out
		# algebra), so jax.grad through it is the exact derivative of the
		# estimator. Requires a count-style budget; returns the traced mean.
		assert callback is None and resume is None and not record and not full, (
			"differentiable=True is a pure traced-scalar path: callback/resume/record/full are unavailable"
		)
		assert classify_pdf(pdf) != "size", "differentiable=True needs a named pdf"
		crit = CountCriterion(count=n) if converge == "default" else convergence_criterion(converge, **kwargs)
		target = _count_only_target(crit)
		assert target is not None, (
			"differentiable=True needs a fixed probe budget: pass converge='count', count=m"
		)
		schedule = []
		m_cur = 0
		while m_cur < min(int(target), n):
			ns = min(n - m_cur, int(batch))
			if ns <= 0:
				break
			schedule.append(ns)
			m_cur += ns
		_, t_samples = _xtrace_chain_fresh(op, as_key(seed), schedule=tuple(schedule), pdf=pdf, n=n, dtype=op.dtype)
		return jnp.mean(t_samples)
	user_callback = callback if callable(callback) else None

	criterion = CountCriterion(count=n)
	default_stop = converge == "default"
	if not default_stop:
		criterion = criterion | convergence_criterion(converge, **kwargs)
	elif kwargs:
		import warnings

		warnings.warn(
			f"Ignoring criterion kwargs {sorted(kwargs)} because converge='default'; "
			"pass a criterion name or instance for them to take effect.",
			stacklevel=2,
		)
	record = record or criterion_needs_values(criterion)

	if classify_pdf(pdf) == "size":
		raise NotImplementedError("xtrace samples inside fused growth rounds; pass a jax-style pdf(key, shape, dtype) callable.")
	key = as_key(seed)

	estimator = MeanEstimator(covariance=True, record=record)
	result = EstimatorResult()

	# On accelerators each round runs as ONE fused jitted program (see
	# _xtrace_round); on CPU eager dispatch is cheap and avoids a per-shape
	# compile for every distinct (m, ns) a growth schedule visits.
	fused_rounds = jax.default_backend() != "cpu"
	acc = op.dtype
	it0 = 0
	if resume is not None:
		st = resume.info["state"] if isinstance(resume, EstimatorResult) else resume
		state = tuple(jnp.asarray(st[k], acc) for k in ("W", "Z", "Q", "R", "R_inv"))
		assert state[0].shape[0] == n, f"resume state has {state[0].shape[0]} rows, operator has {n}"
		it0 = int(st["it"])
	else:
		# Fresh start: the fused fast path creates the empty state INSIDE its
		# program (_xtrace_chain_fresh); materialize host-side zeros lazily
		# only where a path actually needs them.
		state = None
	# Same round body either way (_xtrace_round_impl is the single source of
	# truth); accelerators jit it per (m, ns) shape, CPU runs it eagerly.
	round_fn = _xtrace_round if fused_rounds else _xtrace_round_impl
	step = lambda state, it, ns, with_est: round_fn(
		op, *state, key, it, ns=ns, pdf=pdf, with_estimates=with_est
	)

	def _zero_state():
		return (
			jnp.zeros((n, 0), acc),  # W
			jnp.zeros((n, 0), acc),  # Z
			jnp.zeros((n, 0), acc),  # Q
			jnp.zeros((0, 0), acc),  # R
			jnp.zeros((0, 0), acc),  # R_inv
		)

	target = n if default_stop else _count_only_target(criterion)
	if target is not None and user_callback is None:
		# Fast path: the stop depends only on the sample count (the default
		# m == n bound, or any count-only composition), so the growth schedule
		# is predetermined and the leave-one-out estimates — recomputed
		# wholesale every round — only matter for the FINAL round. Chain all
		# rounds asynchronously on device and synchronize exactly once at the
		# end (each per-round sync would stall the device).
		target = min(int(target), n)
		schedule = []
		m_cur = 0 if state is None else int(state[0].shape[1])
		while m_cur < target:
			ns = min(n - m_cur, int(batch))
			if ns <= 0:
				break
			schedule.append(ns)
			m_cur += ns
		if fused_rounds:
			# One program for the whole predetermined schedule: single
			# dispatch, single sync — and on a fresh start the empty state is
			# built inside the program, so NOTHING but the key crosses to the
			# device before the one dispatch.
			if state is None:
				state, t_samples = _xtrace_chain_fresh(op, key, schedule=tuple(schedule), pdf=pdf, n=n, dtype=acc)
			else:
				state, t_samples = _xtrace_chain(
					op, key, state, jnp.asarray(it0, jnp.int32), schedule=tuple(schedule), pdf=pdf
				)
		else:
			state = _zero_state() if state is None else state
			for i, ns in enumerate(schedule):
				state, _ = step(state, it0 + i, ns, False)
			t_samples = _xtrace_estimates(*state[:5], pdf == "sphere")
		it0 += len(schedule)
		# ONE device→host transfer for the samples; the host estimator then
		# works on numpy (feeding it the device array instead made estimate/
		# n_samples/update each pull separately — three syncs).
		estimator.update(jax.device_get(t_samples))
		result.estimate = estimator.estimate
		result.nit = estimator.n_samples
	else:
		state = _zero_state() if state is None else state
		it = it0
		prev_mean = None
		while not bool(criterion(estimator)):
			m_cur = state[0].shape[1]
			ns = min(n - m_cur, int(batch))
			if ns <= 0:
				break
			state, t_samples = step(state, it, ns, True)
			estimator = MeanEstimator(covariance=True, record=record)
			estimator.update(jax.device_get(t_samples))
			# The leave-one-out samples are recomputed WHOLESALE each round, so
			# the estimator is rebuilt — but delta must still be the round-over-
			# round movement of the estimate, not (estimate − 0). Without this,
			# ToleranceCriterion's rtol test compares ‖mean‖ against
			# rtol·‖mean‖ and can mathematically never fire.
			cur_mean = np.atleast_1d(np.asarray(estimator._moments.mu))
			estimator.delta = np.full_like(cur_mean, np.inf) if prev_mean is None else cur_mean - prev_mean
			prev_mean = cur_mean
			result.estimate = estimator.estimate
			result.nit = estimator.n_samples
			if user_callback is not None:
				user_callback(result)
			it += 1
		it0 = it
		if estimator.n_samples == 0 and int(state[0].shape[1]) > 0:
			# Resumed at (or past) the stop: recompute the leave-one-out
			# estimates from the grown subspace once (they are wholesale
			# functions of the state, never incremental).
			estimator.update(jax.device_get(_xtrace_estimates(*state[:5], pdf == "sphere")))
			result.estimate = estimator.estimate
			result.nit = estimator.n_samples

	result.estimator = estimator
	result.estimate = estimator.estimate
	result.criterion = criterion
	result.info["state"] = {
		"W": state[0], "Z": state[1], "Q": state[2], "R": state[3], "R_inv": state[4], "it": it0,
	}
	return (result.estimate, result) if full else result.estimate
