"""Differentiable spectral sums (autodiff.py): custom_vjp SLQ trace path.

``jax.grad`` must work through ``recipes.logdet`` /
``hutch ∘ MatrixFunction``, with the cotangent computed via the stochastic
identity tr(f'(A)·∂A) on shared probes (CG for log/inv) — and the GP
log-likelihood gradient must match central finite differences to rtol 1e-2.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import primate_tpu as pt
from primate_tpu.autodiff import logdet, spectral_sum, trace_inv

_X = np.random.default_rng(0).uniform(-2, 2, (48, 2))


def _make_K(theta):
	"""RBF kernel + noise on fixed inputs: θ = (log lengthscale, log noise)."""
	ell, noise = jnp.exp(theta[0]), jnp.exp(theta[1])
	sq = jnp.sum((_X[:, None, :] - _X[None, :, :]) ** 2, axis=-1)
	return jnp.exp(-0.5 * sq / ell**2) + (noise + 1e-3) * jnp.eye(_X.shape[0])


THETA = jnp.array([0.3, -1.0])


def _fd_grad(scalar_of_theta, theta, eps=1e-4):
	"""Central finite differences of a (deterministic) scalar function."""
	out = []
	for i in range(theta.shape[0]):
		e = np.zeros(theta.shape[0])
		e[i] = eps
		out.append((scalar_of_theta(theta + e) - scalar_of_theta(theta - e)) / (2 * eps))
	return np.array(out)


def test_logdet_value_and_grad_match_exact():
	f = lambda th: logdet(_make_K(th), deg=30, orth=-1, nv=400, seed=3)
	val, g = jax.value_and_grad(f)(THETA)
	exact_val = np.linalg.slogdet(np.asarray(_make_K(THETA), np.float64))[1]
	assert abs(float(val) - exact_val) / abs(exact_val) < 0.05
	# ∇ logdet = tr(K⁻¹ ∂K): FD of the exact logdet.
	exact_g = _fd_grad(lambda th: np.linalg.slogdet(np.asarray(_make_K(th), np.float64))[1], THETA)
	assert np.allclose(np.asarray(g), exact_g, rtol=0.08), (np.asarray(g), exact_g)


def test_trace_inv_grad_matches_exact():
	f = lambda th: trace_inv(_make_K(th), deg=30, orth=-1, nv=400, seed=5)
	val, g = jax.value_and_grad(f)(THETA)
	exact_val = np.trace(np.linalg.inv(np.asarray(_make_K(THETA), np.float64)))
	assert abs(float(val) - exact_val) / abs(exact_val) < 0.05
	exact_g = _fd_grad(lambda th: np.trace(np.linalg.inv(np.asarray(_make_K(th), np.float64))), THETA)
	assert np.allclose(np.asarray(g), exact_g, rtol=0.1), (np.asarray(g), exact_g)


def test_generic_callable_automatic_derivative():
	"""Arbitrary traceable f: f' derived with jax.grad, applied via a second
	Lanczos sweep (grad_method='slq')."""
	fun = lambda x: x * jnp.log(jnp.maximum(x, 1e-12))  # von Neumann entropy kernel
	f = lambda th: spectral_sum(_make_K(th), fun=fun, deg=30, orth=-1, nv=400, seed=7)
	g = jax.grad(f)(THETA)

	def exact(th):
		w = np.linalg.eigvalsh(np.asarray(_make_K(th), np.float64))
		return float(np.sum(w * np.log(w)))

	exact_g = _fd_grad(exact, THETA)
	assert np.allclose(np.asarray(g), exact_g, rtol=0.1), (np.asarray(g), exact_g)


def test_jit_grad_composes_and_is_deterministic():
	f = lambda th: logdet(_make_K(th), deg=20, orth=8, nv=64, seed=11)
	g1 = jax.jit(jax.grad(f))(THETA)
	g2 = jax.grad(f)(THETA)
	assert np.allclose(np.asarray(g1), np.asarray(g2), rtol=1e-6)


def test_hutch_differentiable_and_recipes_logdet_route():
	fh = lambda th: pt.hutch(
		pt.MatrixFunction(_make_K(th), fun="log", deg=30, orth=-1),
		differentiable=True, converge="count", count=300, seed=1,
	)
	fr = lambda th: pt.recipes.logdet(_make_K(th), deg=30, orth=-1, differentiable=True, converge="count", count=300, seed=1)
	vh, gh = jax.value_and_grad(fh)(THETA)
	vr, gr = jax.value_and_grad(fr)(THETA)
	assert np.allclose(float(vh), float(vr)) and np.allclose(np.asarray(gh), np.asarray(gr))
	exact_g = _fd_grad(lambda th: np.linalg.slogdet(np.asarray(_make_K(th), np.float64))[1], THETA)
	assert np.allclose(np.asarray(gh), exact_g, rtol=0.1)


def test_hutch_differentiable_plain_trace_is_exact_derivative():
	"""Without a MatrixFunction the estimator differentiates EXACTLY (quad_form
	chain rule — no surrogate), so grad matches FD of the estimator itself."""
	f = lambda th: pt.hutch(_make_K(th), differentiable=True, converge="count", count=128, seed=2)
	g = jax.grad(f)(THETA)
	fd = _fd_grad(lambda th: float(f(jnp.asarray(th, jnp.float64))), THETA)
	assert np.allclose(np.asarray(g), fd, rtol=1e-4, atol=1e-6)


def test_hutch_differentiable_rejects_adaptive_criteria():
	with pytest.raises(AssertionError, match="fixed probe budget"):
		pt.hutch(_make_K(THETA), differentiable=True, converge="confidence", seed=0)


def test_sparse_operator_gradient_flows_to_data():
	"""Cotangent lands on sparse-format data leaves (DIA bands here): the vjp of
	the operator's own matmat routes it — every format is differentiable."""
	import scipy.sparse as sps

	from primate_tpu.operators.sparse import DIAOperator

	n = 64
	main = 3.0 * np.ones(n)
	off = -1.0 * np.ones(n - 1)
	A = sps.diags([off, main, off], [-1, 0, 1]).tocsr()
	op0 = DIAOperator.from_scipy(A, dtype=jnp.float64)

	def f(data):
		op = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(op0), [data])
		return logdet(op, deg=30, orth=-1, nv=300, seed=13)

	(data0,) = jax.tree_util.tree_leaves(op0)
	g = jax.grad(f)(data0)
	assert g.shape == data0.shape and np.all(np.isfinite(np.asarray(g)))
	# Scaling the main diagonal band: d logdet(A + s·diag(main))/ds at s=0 is
	# tr(A⁻¹ diag(main)) — check the directional derivative against numpy.
	Ai = np.linalg.inv(A.toarray())
	direction = np.zeros_like(np.asarray(data0))
	mid = np.asarray(op0.offsets).tolist().index(0) if hasattr(op0, "offsets") else None
	if mid is not None:
		direction[mid] = np.asarray(data0)[mid]
		got = float(np.sum(np.asarray(g) * direction))
		want = float(np.trace(Ai @ np.diag(main)))
		assert abs(got - want) / abs(want) < 0.1, (got, want)


def test_gp_nll_gradient_matches_fd():
	"""jax.grad of the GP NLL matches central
	finite differences of the EXACT NLL to rtol 1e-2 (probe count high enough
	that estimator noise sits below that)."""
	n = _X.shape[0]
	rng = np.random.default_rng(1)
	y = jnp.asarray(np.sin(_X.sum(axis=1)) + 0.1 * rng.normal(size=n))

	def nll(th):
		K = _make_K(th)
		ld = logdet(K, deg=30, orth=-1, nv=2400, seed=21, solver_rtol=1e-10)
		alpha = pt.solve(K, y, rtol=1e-10)
		return 0.5 * (ld + y @ alpha + n * jnp.log(2 * jnp.pi))

	g = jax.grad(nll)(THETA)

	def exact_nll(th):
		K = np.asarray(_make_K(th), np.float64)
		return 0.5 * (np.linalg.slogdet(K)[1] + np.asarray(y) @ np.linalg.solve(K, np.asarray(y)) + n * np.log(2 * np.pi))

	fd = _fd_grad(exact_nll, THETA)
	rel = np.linalg.norm(np.asarray(g) - fd) / np.linalg.norm(fd)
	assert rel < 1e-2, (np.asarray(g), fd, rel)


def test_stacked_family_gradient_raises():
	fam = pt.stacked("exp", [0.5, 1.0], param="t")
	f = lambda th: jnp.sum(spectral_sum(_make_K(th), fun=fam, deg=20, orth=8, nv=32, seed=1))
	with pytest.raises(NotImplementedError, match="scalar spectral function"):
		jax.grad(f)(THETA)


def test_grad_method_cg_rejected_for_generic_fun():
	f = lambda th: spectral_sum(_make_K(th), fun=jnp.exp, deg=20, orth=8, nv=32, seed=1, grad_method="cg")
	with pytest.raises(ValueError, match="grad_method='cg'"):
		jax.grad(f)(THETA)


def test_chunked_matches_fd_and_jit():
	"""chunk= processes probes in O(n·chunk) blocks (review r4: a single
	(n, count) block OOMs at scale); value+grad still match exact FD."""
	f = lambda th: logdet(_make_K(th), deg=30, orth=-1, nv=400, seed=3, chunk=64)
	val, g = jax.value_and_grad(f)(THETA)
	exact_val = np.linalg.slogdet(np.asarray(_make_K(THETA), np.float64))[1]
	assert abs(float(val) - exact_val) / abs(exact_val) < 0.05
	exact_g = _fd_grad(lambda th: np.linalg.slogdet(np.asarray(_make_K(th), np.float64))[1], THETA)
	assert np.allclose(np.asarray(g), exact_g, rtol=0.1), (np.asarray(g), exact_g)
	jg = jax.jit(jax.grad(f))(THETA)
	assert np.allclose(np.asarray(jg), np.asarray(g))


def test_hutch_differentiable_honors_batch_and_maxiter():
	"""batch → chunked probes; maxiter caps total batches (with the capped
	warning), mirroring the fused loop's semantics."""
	M = lambda th: pt.MatrixFunction(_make_K(th), fun="log", deg=30, orth=-1)
	g = jax.grad(lambda th: pt.hutch(M(th), differentiable=True, converge="count", count=320, batch=32, seed=1))(THETA)
	exact_g = _fd_grad(lambda th: np.linalg.slogdet(np.asarray(_make_K(th), np.float64))[1], THETA)
	assert np.allclose(np.asarray(g), exact_g, rtol=0.15)
	with pytest.warns(UserWarning, match="maxiter"):
		v = pt.hutch(M(THETA), differentiable=True, converge="count", count=3200, batch=32, maxiter=4, seed=1)
	assert np.isfinite(float(v))


def test_diag_differentiable_exact_derivative_and_semantics():
	"""diag(differentiable=True): the plain-ratio estimator is an ordinary
	composition of matmats, so jax.grad gives the EXACT derivative of the
	estimator (matches FD of the estimator itself); adaptive criteria are
	rejected and maxiter caps with a warning."""
	f = lambda th: jnp.sum(pt.diag(_make_K(th), differentiable=True, converge="count", count=16, batch=16, seed=3))
	g = jax.grad(f)(THETA)
	fd = _fd_grad(lambda th: float(f(jnp.asarray(th, jnp.float64))), THETA, eps=1e-5)
	assert np.allclose(np.asarray(g), fd, rtol=1e-4, atol=1e-6)
	jg = jax.jit(jax.grad(f))(THETA)
	assert np.allclose(np.asarray(jg), np.asarray(g))
	with pytest.warns(UserWarning, match="maxiter"):
		pt.diag(_make_K(THETA), differentiable=True, converge="count", count=100, maxiter=4, batch=8, seed=1)
	with pytest.raises(AssertionError, match="fixed probe budget"):
		pt.diag(_make_K(THETA), differentiable=True, converge="confidence", seed=0)


def test_sharded_operator_gradient_distributed_logdet():
	"""Distributed differentiable logdet: the custom_vjp cotangent flows into
	a SHARDED operator's per-device block leaves (the CG backward pass runs
	through the halo shard_map) — no other spectral library differentiates a
	distributed stochastic logdet."""
	import scipy.sparse as sps

	from primate_tpu.parallel import make_mesh, shard_operator

	mesh = make_mesh((4, 2), ("op", "probe"))
	n = 64
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	op0 = shard_operator(L, mesh, probe_axis="probe", comm="halo", blocksize=(8, 8))
	children, treedef = jax.tree_util.tree_flatten(op0)

	def f(blocks):
		op = jax.tree_util.tree_unflatten(treedef, [blocks] + children[1:])
		return logdet(op, deg=24, orth=-1, nv=300, seed=5)

	v, g = jax.value_and_grad(f)(children[0])
	true = np.linalg.slogdet(L.toarray())[1]
	assert abs(float(v) - true) / abs(true) < 0.05
	# d/ds logdet((1+s)A)|₀ = tr(A⁻¹A) = n, exactly — probe noise cancels in
	# this direction because the CG cotangent solves against the same A.
	got = float(jnp.sum(g * children[0]))
	assert abs(got - n) / n < 0.05, (got, n)


def test_chunked_gradient_integer_pytree_leaves():
	"""The chunked custom_vjp's scan accumulator must handle operators with
	integer pytree leaves (CSR indices, ELL planes): float0 cotangents carry
	no arithmetic and are reattached after the loop."""
	import scipy.sparse as sps

	from primate_tpu.operators.sparse import CSROperator

	n = 64
	L = sps.diags([-np.ones(n - 1), 3.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1]).tocsr()
	op0 = CSROperator.from_scipy(L, dtype=jnp.float32)
	children, treedef = jax.tree_util.tree_flatten(op0)
	fidx = [i for i, c in enumerate(children) if jnp.issubdtype(jnp.asarray(c).dtype, jnp.inexact)]

	def f(floats):
		ch = list(children)
		for i, v in zip(fidx, floats):
			ch[i] = v
		return logdet(jax.tree_util.tree_unflatten(treedef, ch), deg=24, orth=-1, nv=256, seed=5, chunk=64)

	v, g = jax.value_and_grad(f)([children[i] for i in fidx])
	# d/ds logdet((1+s)A)|₀ = n exactly (cotangent over ALL float leaves —
	# this CSR has ELL planes, so the gradient lands on ell_data, not data).
	got = sum(float(jnp.sum(gl * children[i])) for gl, i in zip(g, fidx))
	assert abs(got - n) / n < 0.06, got


def test_sketch_estimators_differentiable_exactly():
	"""hutchpp/xnystrace/xdiag are FIXED fused programs (sketch GEMMs + QR /
	Cholesky — no while_loop), so differentiable=True exposes jax.grad as the
	EXACT derivative of each estimator (machine-precision FD match)."""
	fd = lambda f: _fd_grad(lambda th: float(f(th)), THETA, eps=1e-5)

	f1 = lambda th: pt.hutchpp(_make_K(th), m=12, seed=7, differentiable=True)
	assert np.allclose(np.asarray(jax.grad(f1)(THETA)), fd(f1), rtol=1e-4)
	f2 = lambda th: pt.xnystrace(_make_K(th), m=16, seed=7, differentiable=True)
	assert np.allclose(np.asarray(jax.grad(f2)(THETA)), fd(f2), rtol=1e-4)
	f3 = lambda th: jnp.sum(pt.xdiag(_make_K(th), m=16, seed=7, differentiable=True))
	assert np.allclose(np.asarray(jax.grad(f3)(THETA)), fd(f3), rtol=1e-4)
	# jit(grad) composes; the non-differentiable default is unchanged (host float).
	assert np.allclose(np.asarray(jax.jit(jax.grad(f1))(THETA)), np.asarray(jax.grad(f1)(THETA)))
	assert isinstance(pt.hutchpp(_make_K(THETA), m=12, seed=7), float)


def test_xtrace_differentiable_exact_and_exhaustive():
	"""xtrace(differentiable=True): the predetermined-schedule chain is a fixed
	composition (block QR append + leave-one-out algebra), so jax.grad is the
	exact estimator derivative — and at m=n the estimator itself equals tr(A)."""
	n = _X.shape[0]
	f = lambda th: pt.xtrace(_make_K(th), batch=16, converge="count", count=32, seed=9, differentiable=True)
	g = jax.grad(f)(THETA)
	fd = _fd_grad(lambda th: float(f(jnp.asarray(th, jnp.float64))), THETA, eps=1e-5)
	assert np.allclose(np.asarray(g), fd, rtol=1e-4), (np.asarray(g), fd)
	f_exact = lambda th: pt.xtrace(_make_K(th), batch=16, converge="count", count=n, seed=9, differentiable=True)
	assert np.isclose(float(f_exact(THETA)), float(jnp.trace(_make_K(THETA))), rtol=1e-10)
	with pytest.raises(AssertionError, match="fixed probe budget"):
		jax.grad(lambda th: pt.xtrace(_make_K(th), converge="confidence", differentiable=True, seed=1))(THETA)


def test_kpm_trace_differentiable():
	"""kpm_trace(differentiable=True): the Chebyshev moment scan is a fixed
	program; grad equals FD of the estimator exactly; explicit interval and
	fixed m required; jit composes (coefficients forced to compile-time eval)."""
	w = np.linalg.eigvalsh(np.asarray(_make_K(THETA), np.float64))
	iv = (0.0, float(w.max()) * 1.2)
	f = lambda th: pt.kpm_trace(
		_make_K(th), fun="smoothstep", a=0.5, b=3.0, m=96, nv=64, interval=iv, seed=5, differentiable=True
	)
	g = jax.grad(f)(THETA)
	fd = _fd_grad(lambda th: float(f(jnp.asarray(th, jnp.float64))), THETA, eps=1e-5)
	assert np.allclose(np.asarray(g), fd, rtol=1e-4), (np.asarray(g), fd)
	jg = jax.jit(jax.grad(f))(THETA)
	assert np.allclose(np.asarray(jg), np.asarray(g), rtol=1e-8)
	with pytest.raises(AssertionError, match="explicit interval"):
		jax.grad(lambda th: pt.kpm_trace(_make_K(th), fun="exp", m=32, seed=1, differentiable=True))(THETA)


def test_vmap_over_operator_batches():
	"""spectral_sum/logdet compose with jax.vmap over a BATCH of matrices —
	including vmap(grad(...)): multi-task GP workloads get per-task gradients
	from one vectorized program (directional derivative n-exact per task)."""
	n, B = 24, 4
	rng = np.random.default_rng(0)
	Ks = jnp.asarray(np.stack([np.asarray(pt.symmetric(n, pd=True, ew=rng.uniform(0.5, 2.0, n), seed=b)) for b in range(B)]))
	f = lambda K: logdet(K, deg=n, orth=-1, nv=200, seed=3)
	v = jax.vmap(f)(Ks)
	true = np.array([np.linalg.slogdet(np.asarray(K, np.float64))[1] for K in Ks])
	assert np.allclose(np.asarray(v), true, atol=0.15), (np.asarray(v), true)
	g = jax.vmap(jax.grad(f))(Ks)
	dirs = np.einsum("bij,bij->b", np.asarray(g), np.asarray(Ks))
	assert np.allclose(dirs, n, rtol=1e-6), dirs


def test_block_slq_trace_differentiable():
	"""block_slq_trace(differentiable=True): fixed block-Krylov program —
	exact estimator gradient (FD match)."""
	A = jnp.asarray(np.asarray(pt.symmetric(32, pd=True, seed=1)), jnp.float64)
	f = lambda s: pt.block_slq_trace(s * A, fun="log", b=4, deg=6, nblocks=4, seed=2, differentiable=True)
	g = float(jax.grad(f)(1.0))
	fd = (float(f(1.0 + 1e-6)) - float(f(1.0 - 1e-6))) / 2e-6
	assert np.isclose(g, fd, rtol=1e-5), (g, fd)
