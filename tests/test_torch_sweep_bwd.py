"""tpuvr_torch's backward sweep (the plain twin ``sweep_bwd_torch`` and
the autograd op ``sweep_op``) held against the JAX package: its scan twin
``sweep_bwd_xla``, ``jax.grad`` through its ``sweep_op``, and at a tiny
size its Pallas backward in interpret mode.

Tolerances: f64 1e-12 of max|grad| (the same formulas, matmul order
aside); f32 1e-5 of max|grad| (the JAX side's Cody-Waite exp differs
from torch.exp by 2-3 ulp, compounded over the slices). 'default' (bf16
resample operands) cannot be held against JAX on the CPU, whose DEFAULT
f32 dots run in full f32; it is held within 2e-2 of max|grad| of the
port's own 'highest' gradient (bf16 weights, samples and row partials,
about 2^-9 each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuvr.kernels import sweep_bwd as jsweep_bwd
from tpuvr.kernels.sweep_xla import sweep_bwd_xla, sweep_fwd_xla
from tpuvr.ops import vjp as jvjp
from tpuvr_torch.dist.init import DataMesh
from tpuvr_torch.kernels import sweep_bwd as tsweep_bwd
from tpuvr_torch.kernels import sweep_torch as st
from tpuvr_torch.ops import vjp as tvjp

TOL = {"float64": 1e-12, "float32": 1e-5}


def _setup(dtype, seed=0, s=7, n_y=11, n_x=12, n_v=9, n_u=10, raw=False):
    """A random slab and geometry as numpy: density raw parameters (both
    signs) when ``raw``, else non-negative; one disabled slice."""
    rng = np.random.default_rng(seed)
    grid = rng.random((s, 4, n_y, n_x)) * 0.6
    if raw:
        grid[:, 0] = rng.normal(-0.5, 1.5, (s, n_y, n_x))
    coeffs = (rng.uniform(0.6, 1.3, s), rng.uniform(-2.0, 3.0, s),
              rng.uniform(0.6, 1.3, s), rng.uniform(-2.0, 3.0, s))
    enables = np.ones(s)
    enables[rng.integers(1, s - 1)] = 0.0
    dt = rng.uniform(0.5, 1.5, (n_v, n_u))
    d_rgb = rng.normal(size=(3, n_v, n_u))
    d_t = rng.normal(size=(n_v, n_u))
    cast = lambda a: np.asarray(a, dtype)  # noqa: E731
    return (cast(grid), tuple(map(cast, coeffs)), cast(enables), cast(dt),
            cast(d_rgb), cast(d_t))


def _jax(a):
    return jax.tree.map(jnp.asarray, a)


def _torch(a):
    if isinstance(a, tuple):
        return tuple(map(torch.as_tensor, a))
    return torch.as_tensor(a)


def _bwd_both(dtype, precision="highest", **kw):
    grid, coeffs, en, dt, d_rgb, d_t = _setup(dtype,
                                              raw=kw.get("softplus", False))
    fkw = dict(kw, precision=precision)
    jr, jt = sweep_fwd_xla(*_jax((grid, coeffs, en, dt)), **fkw)
    ref = np.asarray(sweep_bwd_xla(*_jax((grid, coeffs, en, dt)), jr, jt,
                                   *_jax((d_rgb, d_t)), **fkw))
    out = st.sweep_bwd_torch(
        *map(_torch, (grid, coeffs, en, dt)),
        torch.as_tensor(np.array(jr)), torch.as_tensor(np.array(jt)),
        *map(_torch, (d_rgb, d_t)), **fkw).numpy()
    return out, ref


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("eps", [0.0, 1e-2])
@pytest.mark.parametrize("softplus", [False, True])
def test_bwd_twin_matches_xla(dtype, reverse, eps, softplus):
    out, ref = _bwd_both(dtype, reverse=reverse, sigma_scale=1.3,
                         early_stop_eps=eps, softplus=softplus)
    scale = np.abs(ref).max()
    assert scale > 1e-3
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype] * scale)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("reverse", [False, True])
def test_bwd_twin_matches_xla_f32_tiers(precision, reverse):
    """'high' (the three-product bf16 split, about 1e-6 relative per
    contraction) is held against the JAX package's 'highest' within 5e-5
    of max|grad|, a few such errors through the recompute and the two
    transposed stages: XLA:CPU cannot run the split's bf16 x bf16 -> f32
    dots in the backward's transposed contraction."""
    kw = dict(reverse=reverse, sigma_scale=0.9)
    _, ref = _bwd_both("float32", "highest", **kw)
    grid, coeffs, en, dt, d_rgb, d_t = map(_torch, _setup("float32"))
    rgb, t = st.sweep_fwd_torch(grid, coeffs, en, dt, precision=precision,
                                **kw)
    out = st.sweep_bwd_torch(grid, coeffs, en, dt, rgb, t, d_rgb, d_t,
                             precision=precision, **kw).numpy()
    tol = {"highest": 1e-5, "high": 5e-5}[precision]
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_bwd_twin_default_tier_within_bf16_bound():
    grid, coeffs, en, dt, d_rgb, d_t = map(_torch, _setup("float32"))
    grads = {}
    for prec in ("highest", "default"):
        rgb, t = st.sweep_fwd_torch(grid, coeffs, en, dt, precision=prec)
        grads[prec] = st.sweep_bwd_torch(grid, coeffs, en, dt, rgb, t,
                                         d_rgb, d_t, precision=prec)
    scale = float(grads["highest"].abs().max())
    err = float((grads["default"] - grads["highest"]).abs().max())
    assert 0 < err <= 2e-2 * scale


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("softplus", [False, True])
def test_bwd_twin_carry_over_two_slabs(reverse, softplus):
    """Two slabs threading the (trans, q) carry equal one call, and the
    port's chunked backward equals the JAX package's."""
    grid, coeffs, en, dt, d_rgb, d_t = _setup("float64", raw=softplus)
    grid, coeffs, en, dt = grid[:6], tuple(c[:6] for c in coeffs), en[:6], dt
    kw = dict(reverse=reverse, sigma_scale=1.1, early_stop_eps=0.0,
              precision="highest", softplus=softplus)
    args = tuple(map(_torch, (grid, coeffs, en, dt)))
    rgb, t = st.sweep_fwd_torch(*args, **kw)
    one = st.sweep_bwd_torch(*args, rgb, t, *map(_torch, (d_rgb, d_t)), **kw)
    two = tvjp._chunked_bwd(st.sweep_bwd_torch, 2, *args, rgb, t,
                            *map(_torch, (d_rgb, d_t)), kw)
    torch.testing.assert_close(two, one, rtol=0,
                               atol=1e-12 * float(one.abs().max()))
    ref = jvjp._chunked_bwd(
        sweep_bwd_xla, 2, None, reverse, *_jax((grid, coeffs, en, dt)),
        jnp.asarray(rgb.numpy()), jnp.asarray(t.numpy()),
        *_jax((d_rgb, d_t)), kw)
    np.testing.assert_allclose(two.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(ref)).max())


def _losses(dtype, seed=3):
    grid, coeffs, en, dt, d_rgb, d_t = _setup(dtype, seed=seed)

    def jloss(op):
        def f(g):
            rgb, t = op(g, _jax(coeffs), jnp.asarray(en), jnp.asarray(dt))
            return jnp.sum(rgb * d_rgb) + jnp.sum(t * d_t)
        return f

    def tgrad(op):
        g = torch.as_tensor(grid).requires_grad_(True)
        rgb, t = op(g, _torch(coeffs), torch.as_tensor(en),
                    torch.as_tensor(dt))
        ((rgb * torch.as_tensor(d_rgb)).sum()
         + (t * torch.as_tensor(d_t)).sum()).backward()
        return g.grad.numpy()

    return grid, jloss, tgrad


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("bwd_chunks", [1, 7])
@pytest.mark.parametrize("softplus", [False, True])
def test_sweep_op_grad_matches_jax_grad(dtype, bwd_chunks, softplus):
    grid, jloss, tgrad = _losses(dtype)
    kw = dict(reverse=True, sigma_scale=1.2, early_stop_eps=0.0,
              softplus=softplus)
    ref = np.asarray(jax.grad(jloss(jvjp.sweep_op(impl="xla", **kw)))(
        jnp.asarray(grid)))
    out = tgrad(tvjp.sweep_op(impl="torch", bwd_chunks=bwd_chunks, **kw))
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=TOL[dtype] * np.abs(ref).max())


def test_sweep_op_grad_matches_pallas_interpret():
    """The JAX package's Pallas backward in interpret mode, tiny size."""
    grid, coeffs, en, dt, d_rgb, d_t = _setup("float32", s=4, n_y=8, n_x=8,
                                              n_v=8, n_u=8)
    kw = dict(reverse=False, sigma_scale=1.0, early_stop_eps=0.0,
              precision="highest")
    jr, jt = sweep_fwd_xla(*_jax((grid, coeffs, en, dt)), **kw)
    ref = np.asarray(jsweep_bwd.sweep_bwd(
        *_jax((grid, coeffs, en, dt)), jr, jt, *_jax((d_rgb, d_t)),
        interpret=True, **kw))
    g = torch.as_tensor(grid).requires_grad_(True)
    rgb, t = tvjp.sweep_op(impl="torch", **kw)(
        g, _torch(coeffs), torch.as_tensor(en), torch.as_tensor(dt))
    ((rgb * torch.as_tensor(d_rgb)).sum()
     + (t * torch.as_tensor(d_t)).sum()).backward()
    np.testing.assert_allclose(g.grad.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("softplus", [False, True])
def test_sweep_op_gradcheck_f64(softplus):
    grid, coeffs, en, dt, _, _ = _setup("float64", s=4, n_y=6, n_x=7,
                                        n_v=5, n_u=6, raw=softplus)
    op = tvjp.sweep_op(False, 1.3, 0.0, "torch", softplus=softplus)
    args = (_torch(coeffs), torch.as_tensor(en), torch.as_tensor(dt))
    g = torch.as_tensor(grid).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: op(x, *args), (g,), eps=1e-6,
                                    atol=1e-7, rtol=1e-5)


def test_sweep_op_gives_no_geometry_gradients():
    grid, coeffs, en, dt, _, _ = _setup("float64")
    coeffs = tuple(torch.as_tensor(c).requires_grad_(True) for c in coeffs)
    dt = torch.as_tensor(dt).requires_grad_(True)
    g = torch.as_tensor(grid).requires_grad_(True)
    rgb, t = tvjp.sweep_op(False, 1.0, 0.0, "torch")(
        g, coeffs, torch.as_tensor(en), dt)
    (rgb.sum() + t.sum()).backward()
    assert g.grad is not None and float(g.grad.abs().max()) > 0
    assert all(c.grad is None for c in coeffs) and dt.grad is None


def test_bwd_wrapper_runs_twin_on_cpu():
    grid, coeffs, en, dt, d_rgb, d_t = map(_torch, _setup("float32"))
    rgb, t = st.sweep_fwd_torch(grid, coeffs, en, dt)
    before = tsweep_bwd.launches.copy()
    a = tsweep_bwd.sweep_bwd(grid, coeffs, en, dt, rgb, t, d_rgb, d_t,
                             softplus=True)
    b = st.sweep_bwd_torch(grid, coeffs, en, dt, rgb, t, d_rgb, d_t,
                           softplus=True)
    assert tsweep_bwd.launches == before
    assert torch.equal(a, b)


_ONE_RANK = DataMesh(None, 0, 1)
_TWO_RANKS = DataMesh(None, 0, 2)


@pytest.mark.parametrize("kw,match", [
    (dict(views=2, ring=(None, 2, 1)), "needs a mesh"),
    (dict(ring=(_ONE_RANK, 1, 1)), "ring_size >= 2"),
    (dict(ring=(_TWO_RANKS, 2, 1), bwd_chunks=2), "mutually exclusive"),
    (dict(ring=(_TWO_RANKS, 2, 1), mesh=_TWO_RANKS), "mutually exclusive"),
    (dict(ring=(_TWO_RANKS, 4, 1)), "not the mesh"),
], ids=[f"kw{i}" for i in range(5)])
def test_sweep_op_refuses_later_slices(kw, match):
    """What the ring backward (B11's port, tests/test_torch_dist.py)
    refuses when the op is built, as the JAX package does: a ring without
    a mesh, a ring of fewer than 2 ranks, a ring beside ``bwd_chunks`` or
    ``mesh``; and a ring size that is not the mesh's."""
    with pytest.raises(ValueError, match=match):
        tvjp.sweep_op(False, 1.0, 0.0, "torch", **kw)


def test_slab_slices_bounds_the_buffer():
    assert tsweep_bwd.slab_slices(256, 2048, 256) == 16  # c4 minibatch
    assert tsweep_bwd.slab_slices(256, 256, 256) == 128
    assert tsweep_bwd.slab_slices(256, 512, 512) == 32
    assert tsweep_bwd.slab_slices(8, 4, 4) == 8
    assert tsweep_bwd.slab_slices(256, 8192, 8192) == 1
