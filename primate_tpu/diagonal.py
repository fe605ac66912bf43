"""Stochastic diagonal estimators: Girard-Hutchinson `diag` and XDiag.

Parity: reference ``src/primate/diagonal.py`` (`diag`, `xdiag`).

Accelerator-first: `diag` runs as one fused `lax.while_loop` carrying the
ratio-normalization accumulators ``(Σ v∘Av, Σ v∘v)`` and a dim-N streaming-mean
state on-device; the tolerance criterion evaluates inside the loop condition.
`xdiag` is a single fused program of GEMMs + column-wise reductions (the
reference's MATLAB-derived identities, `diagonal.py:115-137`).
"""

from functools import partial
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .estimators import (
	ConvergenceCriterion,
	EstimatorResult,
	EstSnapshot,
	MeanEstimator,
	convergence_criterion,
	note_capped,
)
from .operators import aslinop, is_valid_operator
from .trace import _reject_stacked
from .random import as_key, classify_pdf, real_dtype, sample_isotropic
from .linalg import tall_qr
from .stats import MeanState, make_mean_state, mean_update

__all__ = ["diag", "diagpp", "xdiag"]

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



class _DiagCarry(NamedTuple):
	it: jnp.ndarray  # () int32
	numer: jnp.ndarray  # (d·N,) Σ v ∘ (Av), flattened over any stack axes
	denom: jnp.ndarray  # (N,) Σ v ∘ v (shared across the stack)
	mean: MeanState  # dim-(d·N) streaming mean of the ratio estimates
	delta: jnp.ndarray  # (d·N,)
	m2: jnp.ndarray  # (d·N,) per-dim Welford sum of squared deviations


def _diag_differentiable(op, *, pdf, converge, seed, full, callback, record, maxiter, resume, batch, **kwargs):
	"""Reverse-differentiable fixed-budget ``diag`` (the `differentiable=True`
	path): the PLAIN ratio estimator ``Σ v∘(Av) / Σ v∘v`` computed as one
	traced scan — the ratio is an ordinary composition of ``matmat``s, so
	``jax.grad``/``jax.jit`` flow through the operator's pytree leaves
	directly (no custom_vjp needed; the adaptive ``lax.while_loop`` is what
	blocks reverse mode). Probes run in ``batch``-sized chunks inside a
	``lax.scan`` (O(n·batch) memory); the criterion must be a count (its count
	× batch = the probe budget, matching the fused loop's semantics), capped
	by ``maxiter``. Returns a traced ``(…, n)`` array.

	Note: the non-differentiable default returns the MEAN of the running-ratio
	sequence (reference parity); this path returns the plain final ratio —
	deterministically relatable, and ~1.4× lower RMSE at equal probes (see the
	estimator note in :func:`diag`). A ``MatrixFunction`` operand
	differentiates through its Lanczos recurrence (no trace-identity shortcut
	exists for per-entry diagonals); prefer modest ``deg`` there.
	"""
	from .estimators import CountCriterion

	if converge in ("default", "count") or (converge == "tolerance" and not kwargs):
		# "tolerance" with no tolerance kwargs is just diag's signature
		# default — treat it as "no explicit criterion". An EXPLICIT adaptive
		# ask (rtol/atol present, or a non-count criterion) must raise, not be
		# silently replaced by a fixed budget.
		criterion = convergence_criterion("count", **kwargs)
	else:
		criterion = convergence_criterion(converge, **kwargs)
	assert isinstance(criterion, CountCriterion), (
		"differentiable=True needs a fixed probe budget: pass converge='count', count=m "
		"(adaptive criteria live inside a lax.while_loop, which is not reverse-differentiable)"
	)
	assert callback is None and resume is None and not record and not full, (
		"differentiable=True is a pure traced path: callback/resume/record/full are unavailable"
	)
	assert classify_pdf(pdf) != "size", "differentiable=True needs a named pdf (rademacher/normal/sphere)"
	if jnp.dtype(op.dtype).kind == "c":
		raise NotImplementedError("differentiable diag is real-symmetric only (mirrors autodiff.spectral_sum).")

	N = op.shape[0]
	batch = max(1, int(batch))
	iters = min(int(criterion.count), int(maxiter))
	note_capped(iters < int(criterion.count), maxiter, name="diag")
	key = as_key(seed)
	acc = jnp.promote_types(op.dtype, jnp.float32)

	stack_shape = tuple(getattr(op, "stack_shape", None) or ())

	def step(carry, i):
		numer, denom = carry
		V = sample_isotropic(jax.random.fold_in(key, i), (N, batch), pdf=pdf, dtype=real_dtype(op.dtype))
		Va = V.astype(op.dtype)
		U = op.matmat(Va) if hasattr(op, "matmat") else op @ Va  # (..., N, batch)
		numer = numer + (U.astype(acc) * V.astype(acc)).sum(-1).reshape(numer.shape)
		denom = denom + (V.astype(acc) * V.astype(acc)).sum(-1)
		return (numer, denom), None

	nout = int(np.prod(stack_shape)) if stack_shape else 1
	(numer, denom), _ = jax.lax.scan(
		step, (jnp.zeros(nout * N, acc), jnp.zeros(N, acc)), jnp.arange(iters)
	)
	est = (numer.reshape(nout, N) / jnp.where(denom == 0, 1.0, denom)).reshape(stack_shape + (N,))
	return est.astype(acc) if stack_shape else est.reshape(N)


_DIAG_BLOCK_BUDGET = 32 * 1024 * 1024  # max probe-block elements for the one-shot count path


@partial(jax.jit, static_argnames=("n", "pdf", "iters", "nout", "batch"))
def _diag_count_fused(A, key, init_carry=None, *, n: int, pdf: str, iters: int, nout: int = 1, batch: int = 1):
	"""Fixed-count ``diag``: the whole probe budget as ONE operator block.

	The adaptive while_loop pays a per-iteration cost even at small n (each
	iteration is its own sample + SpMM + dim-N update chain inside the loop
	body), which makes small-count runs loop-overhead-bound. A count
	criterion makes the schedule static, so all ``iters × batch`` probes are
	drawn at once, applied in ONE ``(n, iters·batch)`` matmat, and reduced to
	per-iteration increments; only the O(n)-per-iteration running-mean /
	Welford update stays sequential (a short on-device scan), preserving the
	while-loop path's estimator semantics — same probe stream (keyed by
	iteration index), same mean-of-running-ratios estimate, same m2 — so
	``resume`` states interoperate between the two paths.

	Engaged when ``n · iters · batch`` fits the block budget; larger runs keep
	the while_loop (whose per-iteration overhead is amortized by big matvecs).
	"""
	dtype = A.dtype
	acc = jnp.promote_types(dtype, jnp.float32)
	is_cplx = jnp.dtype(dtype).kind == "c"
	if is_cplx:
		acc = real_dtype(acc)
	sample_dtype = jnp.dtype(dtype) if pdf == "phase" else real_dtype(dtype)
	init = init_carry if init_carry is not None else _DiagCarry(
		it=jnp.zeros((), jnp.int32),
		numer=jnp.zeros(nout * n, acc),
		denom=jnp.zeros(n, acc),
		mean=make_mean_state(nout * n, acc),
		delta=jnp.full(nout * n, jnp.inf, acc),
		m2=jnp.zeros(nout * n, acc),
	)

	# Same stream as the while-loop body: iteration i draws (n, batch) from
	# fold_in(key, i); vmap stacks the per-iteration draws.
	its = init.it + jnp.arange(iters, dtype=jnp.int32)
	V = jax.vmap(lambda i: sample_isotropic(jax.random.fold_in(key, i), (n, batch), pdf=pdf, dtype=sample_dtype))(its)
	Vb = jnp.moveaxis(V, 0, 1).reshape(n, iters * batch)  # (n, iters·batch)
	Va = Vb.astype(dtype)
	U = A.matmat(Va) if hasattr(A, "matmat") else (A @ Va)  # (..., n, iters·batch)
	U = U.reshape(nout, n, iters, batch)
	Vb = Vb.reshape(1, n, iters, batch)
	if is_cplx:
		Va4 = Va.reshape(1, n, iters, batch)
		s_num = jnp.real(jnp.conj(Va4) * U).astype(acc).sum(-1)  # (nout, n, iters)
		s_den = jnp.real(jnp.conj(Va4) * Va4).astype(acc).sum(-1)[0]  # (n, iters)
	else:
		s_num = (U.astype(acc) * Vb.astype(acc)).sum(-1)
		s_den = (Vb.astype(acc) * Vb.astype(acc)).sum(-1)[0]
	s_num = jnp.moveaxis(s_num, -1, 0).reshape(iters, nout * n)
	s_den = jnp.moveaxis(s_den, -1, 0)  # (iters, n)

	def step(c: _DiagCarry, s):
		inc_num, inc_den = s
		numer = c.numer + inc_num
		denom = c.denom + inc_den
		safe = jnp.where(denom == 0, 1.0, denom)
		est = (numer.reshape(nout, n) / safe).reshape(-1)
		new_mean = mean_update(c.mean, est[None, :])
		m2 = c.m2 + (est - c.mean.mu) * (est - new_mean.mu)
		return _DiagCarry(it=c.it + 1, numer=numer, denom=denom, mean=new_mean, delta=new_mean.mu - c.mean.mu, m2=m2), None

	final, _ = lax.scan(step, init, (s_num, s_den))
	return final


def _diag_snapshot(c: _DiagCarry) -> EstSnapshot:
	# Scalar variance proxy for CLT-style criteria on a dim-N estimator: the
	# mean of the per-dim running variances (a full N×N covariance would be
	# prohibitive and is never needed for a stopping rule).
	nf = jnp.maximum(c.mean.n - 1, 1)
	var = jnp.mean(c.m2) / nf
	return EstSnapshot(n=c.mean.n, estimate=c.mean.mu, delta=c.delta, var=var, values=None)


@partial(jax.jit, static_argnames=("n", "pdf", "maxiter", "nout", "batch"))
def _diag_fused(A, criterion, key, init_carry=None, *, n: int, pdf: str, maxiter: int, nout: int = 1, batch: int = 1):
	"""Fused ratio-normalized diagonal loop; ``nout > 1`` when the operator's
	matvec is STACKED (e.g. a MatrixFunction with a `special.stacked` family —
	diag(f_t(A)) for every t from ONE Lanczos sweep per probe).

	``batch > 1`` merges that many probes per loop iteration: one ``(n, batch)``
	SpMM instead of ``batch`` bandwidth-starved single-column matvecs — the same
	probe-blocking `hutch(batch=...)` does (the reference's serial loop,
	`diagonal.py:71-78`, is the 1-probe special case). The ratio accumulators
	sum over the probe block before one mean update per iteration.

	``init_carry`` resumes from a prior run's final state: probes are keyed by
	iteration index, so a resumed run continues the same sample stream
	(bit-identical to one uninterrupted run — SURVEY §5.4)."""
	dtype = A.dtype
	acc = jnp.promote_types(dtype, jnp.float32)
	# Hermitian (complex) operators: the diagonal is REAL — sample real probes,
	# keep all estimator state real, and take Re(Av ∘ v) per sample.
	is_cplx = jnp.dtype(dtype).kind == "c"
	if is_cplx:
		acc = real_dtype(acc)
	sample_dtype = jnp.dtype(dtype) if pdf == "phase" else real_dtype(dtype)
	init = init_carry if init_carry is not None else _DiagCarry(
		it=jnp.zeros((), jnp.int32),
		numer=jnp.zeros(nout * n, acc),
		denom=jnp.zeros(n, acc),
		mean=make_mean_state(nout * n, acc),
		delta=jnp.full(nout * n, jnp.inf, acc),
		m2=jnp.zeros(nout * n, acc),
	)

	def cond(c):
		return jnp.logical_and(c.it < maxiter, jnp.logical_not(criterion.check(_diag_snapshot(c))))

	def body(c):
		k = jax.random.fold_in(key, c.it)
		if batch == 1:
			# Single-probe path: operators with a true 1-D apply (DIA stencils)
			# skip the (n, 1) block.
			v = sample_isotropic(k, (n, 1), pdf=pdf, dtype=sample_dtype)[:, 0]
			va = v.astype(dtype)
			u = A.matvec(va) if hasattr(A, "matvec") else (A @ va)  # (n,) or (nout, n)
			if is_cplx:
				# Per-entry Re(conj(v) ∘ Av): the ratio estimator of the (real)
				# Hermitian diagonal for real OR phase probes alike.
				u = jnp.real(jnp.conj(va) * u).astype(acc)
				numer = c.numer + u.reshape(-1)
				v = jnp.real(jnp.conj(va) * va).astype(acc)  # |v|² (≡ v∘v for real probes)
				denom = c.denom + v
			else:
				u = u.astype(acc)
				v = v.astype(acc)
				numer = c.numer + (u * v).reshape(-1)
				denom = c.denom + v * v
		else:
			V = sample_isotropic(k, (n, batch), pdf=pdf, dtype=sample_dtype)
			Va = V.astype(dtype)
			U = A.matmat(Va) if hasattr(A, "matmat") else (A @ Va)  # (..., n, batch)
			if is_cplx:
				numer = c.numer + jnp.real(jnp.conj(Va) * U).astype(acc).sum(-1).reshape(-1)
				denom = c.denom + jnp.real(jnp.conj(Va) * Va).astype(acc).sum(-1)
			else:
				U = U.astype(acc)
				V = V.astype(acc)
				numer = c.numer + (U * V).sum(-1).reshape(-1)
				denom = c.denom + (V * V).sum(-1)
		safe = jnp.where(denom == 0, 1.0, denom)
		est = (numer.reshape(nout, n) / safe).reshape(-1)
		new_mean = mean_update(c.mean, est[None, :])
		m2 = c.m2 + (est - c.mean.mu) * (est - new_mean.mu)  # elementwise Welford
		return _DiagCarry(
			it=c.it + 1, numer=numer, denom=denom, mean=new_mean, delta=new_mean.mu - c.mean.mu, m2=m2
		)

	final = lax.while_loop(cond, body, init)
	# Surface budget-capped stops: unmet criterion at maxiter.
	capped = jnp.logical_and(final.it >= maxiter, jnp.logical_not(criterion.check(_diag_snapshot(final))))
	return final, capped


def diag(
	A,
	pdf: Union[str, Callable] = "rademacher",
	converge: Union[str, ConvergenceCriterion] = "tolerance",
	seed=None,
	full: bool = False,
	callback: Optional[Callable] = None,
	record: bool = False,
	maxiter: int = 4096,
	resume=None,
	batch: int = 1,
	**kwargs,
) -> Union[np.ndarray, tuple]:
	r"""Estimate ``diag(A)`` via the ratio-normalized Girard-Hutchinson estimator.

	Accumulates ``Σ v∘(Av) / Σ v∘v`` over isotropic probes — unbiased for the
	diagonal, with the denominator normalization removing the probe-magnitude
	variance. Default stop: the dim-N tolerance criterion on the mean update.
	Parity: reference `diagonal.py:11-92`.

	Estimator note (reference parity, `diagonal.py:71-92`): the returned value
	is the MEAN of the running-ratio sequence, exactly as the reference's
	MeanEstimator-of-ratios computes it. The final ratio ``Σv∘Av / Σv∘v`` —
	available from a ``full=True`` result as
	``state["numer"].reshape(nout, N) / state["denom"]`` — is the plain
	ratio estimator and measures ~1.4× lower RMSE at equal probes; the mean-of-
	ratios is kept as the default for drop-in reference compatibility.

	``batch`` merges that many probes into ONE ``(n, batch)`` operator block per
	loop iteration (one SpMM using the device's bandwidth instead of ``batch``
	single-column matvecs — at 1M+ rows a lone column is bandwidth-starved).
	The default 1 keeps reference parity (the reference draws one probe per
	iteration, `diagonal.py:71-78`); ``maxiter`` and the criterion both count
	*iterations*, so the probe budget is ``batch × iterations``.

	``resume`` continues a previous run exactly (SURVEY §5.4): pass the
	``result.info["state"]`` dict of an earlier ``full=True`` call made with the
	SAME ``A``/``seed``/``pdf``/``batch`` — probes are keyed by iteration index,
	so resuming to a larger budget is bit-identical to one uninterrupted run.
	The state is a small pytree of arrays; persist it with
	:func:`primate_tpu.utils.checkpoint.save_pytree`.
	"""
	is_valid_operator(A)
	op = A if hasattr(A, "quad") else aslinop(A)
	N = op.shape[0]
	pdf_kind = classify_pdf(pdf)  # "size"-style callables sample on host per probe
	differentiable = kwargs.pop("differentiable", False)
	if differentiable:
		return _diag_differentiable(
			op, pdf=pdf, converge=converge, seed=seed, full=full, callback=callback,
			record=record, maxiter=maxiter, resume=resume, batch=batch, **kwargs,
		)
	criterion = convergence_criterion(converge, **kwargs)
	from .estimators import criterion_needs_values

	if criterion_needs_values(criterion):
		# Knee detection is defined on a SCALAR cumulative-mean curve; a dim-N
		# diagonal estimator has no such stream — fail fast instead of silently
		# never firing and burning maxiter batches.
		raise NotImplementedError("Knee-style criteria (recorded-sample based) are not defined for diag's dim-N estimator.")

	if int(np.prod(op.shape)) == 0:
		return np.zeros(0) if not full else (np.zeros(0), EstimatorResult())

	key = as_key(seed)

	# Stacked operators (matvec → (nt..., N), e.g. MatrixFunction with a
	# `special.stacked` family) estimate every member's diagonal from shared
	# Lanczos sweeps; the estimate comes back with the stack axes leading.
	# Statically-known stack shapes skip the per-call eval_shape host retrace.
	stack_shape = getattr(op, "stack_shape", None)
	if stack_shape is None:
		u_aval = jax.eval_shape(
			lambda a, v: a.matvec(v) if hasattr(a, "matvec") else a @ v, op, jax.ShapeDtypeStruct((N,), op.dtype)
		)
		stack_shape = u_aval.shape[:-1]
	stack_shape = tuple(stack_shape)
	nout = int(np.prod(stack_shape)) if stack_shape else 1

	from .estimators import is_jittable_criterion

	init_carry = None
	if resume is not None:
		st = resume.info["state"] if isinstance(resume, EstimatorResult) else resume
		if "batch" in st and int(st["batch"]) != max(1, int(batch)):
			raise ValueError(
				f"resume state was built with batch={st['batch']} but this call uses batch={batch}; "
				"probes are keyed by iteration index, so bit-identical resumption requires the same batch."
			)
		acc = real_dtype(jnp.promote_types(op.dtype, jnp.float32))  # estimator state is real even for Hermitian ops
		mean = MeanState(n=jnp.asarray(st["mean"].n, jnp.int32), mu=jnp.asarray(st["mean"].mu, acc))
		assert mean.mu.shape[0] == nout * N, f"resume state dim {mean.mu.shape[0]} != {nout * N}"
		init_carry = _DiagCarry(
			it=jnp.asarray(st["mean"].n, jnp.int32),  # one probe per iteration
			numer=jnp.asarray(st["numer"], acc),
			denom=jnp.asarray(st["denom"], acc),
			mean=mean,
			delta=jnp.full(nout * N, jnp.inf, acc),
			m2=jnp.asarray(st["m2"], acc),
		)

	batch = max(1, int(batch))
	if callback is None and not record and is_jittable_criterion(criterion) and pdf_kind != "size":
		# Count-only criteria make the schedule static: run the whole budget as
		# ONE batched program when it fits the block budget (see
		# _diag_count_fused); the adaptive while_loop handles everything else.
		from .trace import _count_only_target

		count_target = _count_only_target(criterion)
		done = 0 if init_carry is None else int(jax.device_get(init_carry.it))
		iters = 0 if count_target is None else min(int(count_target), int(maxiter)) - done
		if count_target is not None and iters > 0 and N * iters * batch * max(1, nout) <= _DIAG_BLOCK_BUDGET:
			carry = _diag_count_fused(op, key, init_carry, n=N, pdf=pdf, iters=iters, nout=nout, batch=batch)
			capped = int(count_target) > int(maxiter)  # static: no device pull needed
		else:
			carry, capped = _diag_fused(op, criterion, key, init_carry, n=N, pdf=pdf, maxiter=int(maxiter), nout=nout, batch=batch)
		if not full:
			# Pull ONLY the estimate (+ the capped flag where it is dynamic):
			# each dim-N carry leaf is a separate device→host transfer.
			mu, capped = jax.device_get((carry.mean.mu, capped))
			note_capped(bool(capped), maxiter, name="diag")
			return np.asarray(mu).reshape(stack_shape + (N,))
		carry, capped = jax.device_get((carry, capped))  # one transfer; later reads are host numpy
		estimator = MeanEstimator.from_state(carry.mean, delta=carry.delta)
		estimate = np.asarray(carry.mean.mu).reshape(stack_shape + (N,))
		state = {"numer": np.asarray(carry.numer), "denom": np.asarray(carry.denom), "mean": carry.mean, "m2": np.asarray(carry.m2), "batch": batch}
		result = EstimatorResult(
			estimator=estimator,
			criterion=criterion,
			estimate=estimate,
			message=getattr(criterion, "message", lambda e: "")(estimator),
			nit=int(carry.mean.n),
		)
		result.info["state"] = state
		note_capped(bool(capped), maxiter, result, name="diag")
		return estimate, result

	# Host-stepped path for callbacks / sample recording.
	if init_carry is not None:
		# Copy the resumed mean (in-place updates must not corrupt the caller's
		# snapshot). m2 IS tracked below — a host-path snapshot resumed into the
		# fused path with a confidence criterion must not report var=0.
		estimator = MeanEstimator.from_state(MeanState(n=init_carry.mean.n, mu=init_carry.mean.mu))
		if record:
			# Record FUTURE samples on a resumed run (the snapshot holds no
			# per-iteration history; from_state would otherwise drop the flag).
			estimator.values = []
		numer, denom, m2_res = init_carry.numer, init_carry.denom, np.asarray(init_carry.m2)
		it = int(init_carry.mean.n)
	else:
		estimator = MeanEstimator(dim=nout * N, covariance=False, record=record)
		numer = jnp.zeros(nout * N)
		denom = jnp.zeros(N)
		m2_res = np.zeros(nout * N)
		it = 0
	result = EstimatorResult(estimator, criterion)
	# Hermitian (complex) operators: mirror the fused path — real probes (unless
	# pdf="phase"), real accumulators, Re(conj(v)∘Av) / |v|² per sample.
	is_cplx = jnp.dtype(op.dtype).kind == "c"
	sample_dtype = op.dtype if (is_cplx and pdf == "phase") else real_dtype(op.dtype)
	while not bool(criterion(estimator)) and it < maxiter:
		if pdf_kind == "size":
			# Reference semantics (`diagonal.py:71-78`): stateful closure draws
			# on host; the matvec runs on device.
			draw = np.asarray(pdf(size=(N, batch) if batch > 1 else (N,)))
			V = jnp.asarray(draw.reshape(N, batch), dtype=sample_dtype)
		else:
			V = sample_isotropic(jax.random.fold_in(key, it), (N, batch), pdf=pdf, dtype=sample_dtype)
		if batch == 1:
			v, va = V[:, 0], V[:, 0].astype(op.dtype)
			u = op.matvec(va) if hasattr(op, "matvec") else op @ va
		else:
			v, va = V, V.astype(op.dtype)
			u = op.matmat(va) if hasattr(op, "matmat") else op @ va  # (..., N, batch)
		if is_cplx:
			nu, de = jnp.real(jnp.conj(va) * u), jnp.real(jnp.conj(va) * va)
		else:
			nu, de = u * v, v * v
		if batch > 1:
			nu, de = nu.sum(-1), de.sum(-1)
		numer = numer + nu.reshape(-1)
		denom = denom + de
		# Guarded divide, mirroring the fused path: a probe coordinate that has
		# only drawn zeros so far (possible with callable pdfs) must not inject
		# NaN into the running mean.
		safe = jnp.where(denom == 0, 1.0, denom)
		est_vec = (numer.reshape(nout, N) / safe).reshape(1, -1)
		# Elementwise Welford m2, matching the fused carry — kept current so a
		# host-path snapshot resumes into fused confidence checks correctly.
		old_mu = np.asarray(estimator._moments._state.mu)
		estimator.update(est_vec)
		new_mu = np.asarray(estimator._moments._state.mu)
		e = np.asarray(est_vec).ravel()
		m2_res = m2_res + (e - old_mu) * (e - new_mu)
		result.estimate = np.asarray(estimator.estimate).reshape(stack_shape + (N,))
		result.nit = estimator.n_samples
		if callback is not None:
			callback(result)
		it += 1
	estimate = np.asarray(estimator.estimate).reshape(stack_shape + (N,))
	result.estimate = estimate
	result.nit = estimator.n_samples
	result.message = getattr(criterion, "message", lambda e: "")(estimator)
	result.info["state"] = {
		"batch": batch,
		"numer": np.asarray(numer),
		"denom": np.asarray(denom),
		"mean": estimator._moments._state,
		"m2": m2_res,
	}
	note_capped(it >= maxiter and not bool(criterion(estimator)), maxiter, result if full else None, name="diag")
	return (estimate, result) if full else estimate


@partial(jax.jit, static_argnames=("n", "nb", "pdf"))
@_hiprec_trace
def _diagpp_program(A, key, *, n: int, nb: int, pdf: str):
	"""Fused Diag++: exact diagonal of the rank-``nb`` sketch + deflated rest.

	diag(A) = diag(QQᵀA) + diag((I − QQᵀ)A) with Q from a sketch of A's range
	(Baston-Nakatsukasa 2022, the diagonal analog of Hutch++). The first term
	is rowwise ⟨Q, AQ⟩ (A symmetric); the second is ratio-normalized
	Hutchinson with the residual applied as two GEMMs per probe block.
	"""
	dtype = A.dtype
	acc = jnp.promote_types(dtype, jnp.float32)
	apply_op = A.matmat if hasattr(A, "matmat") else (lambda V: A @ V)
	k1, k2 = jax.random.split(key)
	# Hermitian (complex) operators: REAL probes, conjugated bras (diag(QQ†A) =
	# rowwise ⟨Q, conj(AQ)⟩ since Q†A = (AQ)†), real final output — each conj
	# is an identity on the real path.
	S = sample_isotropic(k1, (n, nb), pdf=pdf, dtype=real_dtype(dtype)).astype(dtype)
	Q, _ = tall_qr(apply_op(S).astype(acc))
	AQ = apply_op(Q.astype(dtype)).astype(acc)
	d1 = jnp.einsum("ij,ij->i", Q, jnp.conj(AQ))  # diag(QQ†A)

	G = sample_isotropic(k2, (n, nb), pdf=pdf, dtype=real_dtype(dtype)).astype(dtype)
	W = apply_op(G).astype(acc)
	Rres = W - Q @ (jnp.conj(AQ).T @ G.astype(acc))  # (I − QQ†)A G, no extra matvecs
	G = jnp.real(G).astype(real_dtype(acc))
	numer = jnp.einsum("ij,ij->i", G, Rres)
	denom = jnp.einsum("ij,ij->i", G, G)
	d2 = numer / jnp.where(denom == 0, 1.0, denom)
	return jnp.real(d1 + d2)


def diagpp(A, m: Optional[int] = None, pdf: str = "rademacher", seed=None) -> np.ndarray:
	"""Estimate ``diag(A)`` with Diag++: low-rank deflation + residual Hutchinson.

	The diagonal analog of :func:`~primate_tpu.hutchpp` (Baston-Nakatsukasa
	2022): ``nb = m`` (or ``N // 3``) sketch columns capture the dominant range
	exactly — rowwise ⟨Q, AQ⟩, no probe noise — and ``nb`` ratio-normalized
	Hutchinson probes estimate only the deflated residual, whose variance
	scales with the *tail* singular values instead of ‖A‖²_F. ``3·nb``
	operator applications total. Exact (to rounding) when ``rank(A) ≤ nb``.

	Beyond-reference capability (the reference ships `diag`/`xdiag` only,
	`src/primate/diagonal.py`).
	"""
	is_valid_operator(A)
	op = A if hasattr(A, "quad") else aslinop(A)
	_reject_stacked(op, "diagpp")
	if classify_pdf(pdf) == "size":
		raise NotImplementedError("diagpp samples inside one fused program; pass a jax-style pdf(key, shape, dtype) callable.")
	n = op.shape[0]
	if int(np.prod(op.shape)) == 0:
		return np.zeros(0)
	nb = (n // 3) if m is None else int(m)
	nb = max(1, min(nb, n))
	return np.asarray(_diagpp_program(op, as_key(seed), n=n, nb=nb, pdf=pdf))



@partial(jax.jit, static_argnames=("n", "m", "pdf"))
@_hiprec_trace
def _xdiag_program(A, key, *, n: int, m: int, pdf: str):
	"""Fused XDiag (Epperly SM4.3): sketch + leave-one-out diagonal identities.

	Complex-Hermitian generalization: probes stay REAL; each rowwise diagonal
	``diag(X M†)`` conjugates its *right* factor (``Q†A = (AQ)† = Z†``, so e.g.
	``diag(QQ†A) = rowwise ⟨Q, conj(Z)⟩``), ``S`` is built from ``R⁻ᴴ``, and the
	estimate's real part is returned. Every conj is an identity on the real path.
	"""
	dtype = A.dtype
	apply_op = A.matmat if hasattr(A, "matmat") else (lambda V: A @ V)
	N = sample_isotropic(key, (n, m), pdf=pdf, dtype=real_dtype(dtype)).astype(dtype)
	Y = apply_op(N)
	Q, R = tall_qr(Y)
	dNY = jnp.einsum("ij,ij->i", N, jnp.conj(Y))[:, None]  # rowwise ⟨N, conj(Y)⟩ = diag(N Y†)

	Z = apply_op(Q)  # Hermitian A: Q†A = Z†
	T = jnp.conj(Z).T @ N
	R_inv = jax.scipy.linalg.solve_triangular(R, jnp.eye(m, dtype=R.dtype), lower=False)
	S = jnp.conj(R_inv).T / jnp.linalg.norm(R_inv, axis=1)[None, :]  # cols ∝ R⁻ᴴeᵢ
	QS = Q @ S

	dQZ = jnp.einsum("ij,ij->i", Q, jnp.conj(Z))[:, None]  # diag(Q Z†) = diag(QQ†A)
	dQSSZ = jnp.einsum("ij,ij->i", QS, jnp.conj(Z @ S))[:, None]
	dNTQ = jnp.einsum("ij,ij->i", N, jnp.conj(Q @ T))[:, None]
	dST = jnp.einsum("ij,ij->j", jnp.conj(S), T)[:, None]  # diag(S†T), (m, 1)
	dNQSST = jnp.einsum("ij,ij->i", N, jnp.conj(QS * dST[:, 0][None, :]))[:, None]

	d = dQZ + (-dQSSZ + dNY - dNTQ + dNQSST) / m
	return jnp.real(d[:, 0])


def xdiag(A, m: Optional[int] = None, pdf: str = "sphere", seed=None, differentiable: bool = False) -> np.ndarray:
	"""Estimate ``diag(A)`` with the XDiag leave-one-out estimator.

	Uses ``m / 2`` probe columns — ``m`` operator applications total (the
	sketch pass ``A·N`` plus the test pass ``A·Q``; the reference's "m/2
	matvecs" wording, `diagonal.py:102`, counts only the first). Parity:
	reference `diagonal.py:99-138`.

	``differentiable=True`` returns the traced device array instead of numpy:
	the fused program is a fixed composition (sketch GEMMs + QR + leave-one-
	out algebra — no adaptive while_loop), so ``jax.grad`` through it is the
	EXACT derivative of the estimator (QR reverse rule included).
	"""
	is_valid_operator(A)
	op = A if hasattr(A, "quad") else aslinop(A)
	_reject_stacked(op, "xdiag")
	if classify_pdf(pdf) == "size":
		raise NotImplementedError("xdiag samples inside one fused program; pass a jax-style pdf(key, shape, dtype) callable.")
	n = op.shape[0]
	m = 2 * n if m is None else min(int(m) + (int(m) % 2), 2 * n)
	m = m // 2
	out = _xdiag_program(op, as_key(seed), n=n, m=m, pdf=pdf)
	return out if differentiable else np.asarray(out)
