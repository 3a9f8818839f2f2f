"""Double-f32 arithmetic (ops/dd.py): error-free transforms and ~2^-48
accuracy of the compound ops, validated against numpy longdouble.

These primitives carry the mixed-precision constrained endgame of systems
stored in float32; they must agree with native f64 to dd roundoff.
``chip_smoke.py`` repeats the error-free-transform checks on the GPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from structurepreservingiterativesolvers_tpu.ops import dd


RNG = np.random.default_rng(42)


def _rand_f32(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def test_two_sum_error_free():
    a = jnp.asarray(_rand_f32(1000, 1e6))
    b = jnp.asarray(_rand_f32(1000, 1e-3))
    s, e = dd.two_sum(a, b)
    exact = a.astype(jnp.float64) + b.astype(jnp.float64)
    got = s.astype(jnp.float64) + e.astype(jnp.float64)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))


def test_two_prod_error_free():
    a = jnp.asarray(_rand_f32(1000))
    b = jnp.asarray(_rand_f32(1000))
    p, e = dd.two_prod(a, b)
    # product of two f32 fits exactly in f64
    exact = a.astype(jnp.float64) * b.astype(jnp.float64)
    got = p.astype(jnp.float64) + e.astype(jnp.float64)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(exact))


def test_roundtrip_f64():
    a = RNG.standard_normal(1000)
    x = dd.from_f64_np(a)
    np.testing.assert_array_equal(np.asarray(dd.to_f64(x)), a.astype(np.float32).astype(np.float64) + np.asarray(x.lo, np.float64))
    # split is exact to dd precision: |a - (hi+lo)| <= 2^-48 relative
    err = np.abs(np.asarray(dd.to_f64(x)) - a)
    assert err.max() <= np.abs(a).max() * 2.0**-45


def test_add_mul_vs_longdouble():
    a = RNG.standard_normal(4096)
    b = RNG.standard_normal(4096) * 1e3
    x, y = dd.from_f64_np(a), dd.from_f64_np(b)
    ref_a = np.asarray(dd.to_f64(x), np.longdouble)
    ref_b = np.asarray(dd.to_f64(y), np.longdouble)
    got_add = np.asarray(dd.to_f64(dd.add(x, y)), np.longdouble)
    got_mul = np.asarray(dd.to_f64(dd.mul(x, y)), np.longdouble)
    tol = 2.0**-44
    assert np.max(np.abs(got_add - (ref_a + ref_b)) / np.abs(ref_a + ref_b + 1e-300)) < tol
    assert np.max(np.abs(got_mul - (ref_a * ref_b)) / np.abs(ref_a * ref_b + 1e-300)) < tol


def test_dd_sum_cancellation():
    # adversarial: large cancelling entries; plain f32 sum loses everything
    n = 1 << 15
    a = RNG.standard_normal(n)
    a = np.concatenate([a, -a, np.array([1e-7])])
    x = dd.from_f64_np(a)
    s = float(dd.to_f64(dd.dd_sum(x)))
    truth = float(np.sum(np.asarray(dd.to_f64(x), np.longdouble)))
    assert abs(s - truth) < 1e-12
    # f32 reference for contrast: off by orders of magnitude more
    f32_err = abs(float(np.sum(a.astype(np.float32))) - truth)
    assert f32_err > abs(s - truth)


def test_dot_vs_longdouble():
    n = 4096
    a = RNG.standard_normal(n) * 10
    b = RNG.standard_normal(n)
    x, y = dd.from_f64_np(a), dd.from_f64_np(b)
    got = float(dd.to_f64(dd.dot(x, y)))
    truth = float(
        np.dot(np.asarray(dd.to_f64(x), np.longdouble),
               np.asarray(dd.to_f64(y), np.longdouble)))
    scale = float(np.dot(np.abs(a), np.abs(b)))
    assert abs(got - truth) < scale * 2.0**-44


def test_combine_f32_vs_f64():
    k, n = 17, 3000
    Z = _rand_f32((k, n))
    y = RNG.standard_normal(k)
    got = np.asarray(dd.to_f64(dd.combine_f32(jnp.asarray(y), jnp.asarray(Z))))
    truth = y @ Z.astype(np.float64)
    scale = np.abs(y) @ np.abs(Z.astype(np.float64))
    assert np.max(np.abs(got - truth) / (scale + 1e-300)) < 2.0**-40


def test_spmv_dia_vs_f64():
    from structurepreservingiterativesolvers_tpu.models import heat

    s = heat.linforms(M=24)
    A = s.A  # DIA
    data64 = np.asarray(A.data, np.float64)
    n = A.shape[0]
    xv = RNG.standard_normal(n)
    x = dd.from_f64_np(xv)
    Add = dd.from_f64_np(data64)
    got = np.asarray(dd.to_f64(dd.spmv_dia(Add, A.offsets, A.wrap, x)))
    # dense f64 truth
    dense = np.zeros((n, n))
    rows = np.arange(n)
    for d, off in enumerate(A.offsets):
        cols = rows + off
        valid = (cols >= 0) & (cols < n)
        dense[rows[valid], cols[valid]] += data64[d][valid]
    xr = np.asarray(dd.to_f64(x))
    truth = dense @ xr
    scale = np.abs(dense) @ np.abs(xr) + 1e-300
    assert np.max(np.abs(got - truth) / scale) < 2.0**-40


def test_quadratic_dd_value_matches_f64():
    """g(x) evaluated via dd primitives matches the f64 evaluation to ~1e-13
    relative on the heat system's energy constraint."""
    from structurepreservingiterativesolvers_tpu.models import heat

    s = heat.linforms(M=24)
    cons = [c for c in s.constraints() if c.M is not None]
    assert cons
    con = cons[0]
    n = s.b.shape[0]
    xv = RNG.standard_normal(n)
    x = dd.from_f64_np(xv)
    xr = np.asarray(dd.to_f64(x))

    Md = con.M.todense() if hasattr(con.M, "todense") else np.asarray(con.M)
    Md = np.asarray(Md, np.float64)
    truth = 0.5 * xr @ (Md @ xr) + float(np.asarray(con.c, np.float64))
    if con.v is not None:
        truth += np.asarray(con.v, np.float64) @ xr

    # dd evaluation path: Mx in dd, then 1/2 x·(Mx) + v·x + c
    from structurepreservingiterativesolvers_tpu.constraints.quadratic import (
        dd_constraint_value,
    )

    got = float(dd_constraint_value(con, x))
    scale = abs(0.5 * np.abs(xr) @ (np.abs(Md) @ np.abs(xr))) + abs(truth) + 1.0
    assert abs(got - truth) < scale * 1e-12


def test_dd_reduction_matches_f64():
    """catchup_buffers / update_buffers with dd_reduce=True (the mixed-mode
    path of f32 storage) agree with the native-f64 reduction to
    dd roundoff on an f32 system."""
    import jax.numpy as jnp

    from structurepreservingiterativesolvers_tpu.constraints.quadratic import (
        catchup_buffers, init_buffers, update_buffers,
    )
    from structurepreservingiterativesolvers_tpu.models import heat

    s32 = heat.linforms(M=24, dtype=jnp.float32)
    cons = tuple(s32.constraints())
    n = s32.b.shape[0]
    k = 9
    Z = jnp.asarray(RNG.standard_normal((k, n)), jnp.float32)
    Z = Z.at[k - 2 :].set(0.0)  # inactive suffix rows, as in the solver
    x0 = jnp.asarray(RNG.standard_normal(n), jnp.float32)

    for con in cons:
        for x0_zero, x0v in [(True, jnp.zeros_like(x0)), (False, x0)]:
            b0 = init_buffers(con, x0v, k, jnp.float64, x0_zero=x0_zero)
            ref = catchup_buffers(con, b0, Z, x0v, x0_zero=x0_zero)
            got = catchup_buffers(
                con, b0, Z, x0v, x0_zero=x0_zero, dd_reduce=True
            )
            scale1 = np.abs(np.asarray(ref.t1)).max() + 1.0
            scale2 = np.abs(np.asarray(ref.T2)).max() + 1.0
            assert np.max(np.abs(np.asarray(ref.t1 - got.t1))) < scale1 * 1e-12
            assert np.max(np.abs(np.asarray(ref.T2 - got.T2))) < scale2 * 1e-12

            j = jnp.int32(k - 2)
            Zj = Z.at[k - 2].set(
                jnp.asarray(RNG.standard_normal(n), jnp.float32)
            )
            ref_u = update_buffers(con, ref, Zj, x0v, j, x0_zero=x0_zero)
            got_u = update_buffers(
                con, got, Zj, x0v, j, x0_zero=x0_zero, dd_reduce=True
            )
            assert np.max(np.abs(np.asarray(ref_u.t1 - got_u.t1))) < scale1 * 1e-12
            assert np.max(np.abs(np.asarray(ref_u.T2 - got_u.T2))) < scale2 * 1e-12
