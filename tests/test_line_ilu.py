"""Line-ILU preconditioner (SparseBench precond 4) vs the loop-level oracle.

The reference never put precond 4 in its golden table (Validate's PRECS
stops at 3), so validation is oracle-based like validate_large: the device
wavefront/associative-scan implementation must match a direct numpy port
of the intended math of regular.f:816-989 exactly, and the transpose apply
must match the dense transpose of the oracle's inverse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lilac.generate import sparsebench_gen as gen
from lilac.solvers.line_ilu import (
    LineILU,
    _affine_scan,
    line_ssor_solve,
    reference_line_ilusolve,
)


def test_affine_scan_both_directions():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(2, 11))
    B = rng.normal(size=(2, 11))
    fwd = np.zeros_like(A)
    prev = np.zeros(2)
    for i in range(11):
        prev = A[:, i] * prev + B[:, i]
        fwd[:, i] = prev
    got = np.asarray(_affine_scan(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(got, fwd, rtol=1e-13)
    rev = np.zeros_like(A)
    nxt = np.zeros(2)
    for i in range(10, -1, -1):
        nxt = A[:, i] * nxt + B[:, i]
        rev[:, i] = nxt
    got = np.asarray(_affine_scan(jnp.asarray(A), jnp.asarray(B), reverse=True))
    np.testing.assert_allclose(got, rev, rtol=1e-13)


def test_line_ssor_solve_is_tridiagonal_ssor():
    """One line: y = (I + D^-1 U)^-1 (D+L)^-1 x against dense solves."""
    rng = np.random.default_rng(5)
    n = 16
    d = 4.0 + rng.random(n)
    am1 = np.concatenate([[0.0], rng.normal(size=n - 1)])
    ap1 = np.concatenate([rng.normal(size=n - 1), [0.0]])
    x = rng.normal(size=n)
    D = np.diag(d)
    L = np.diag(am1[1:], -1)
    U = np.diag(ap1[:-1], 1)
    want = np.linalg.solve(np.eye(n) + np.linalg.solve(D, U),
                           np.linalg.solve(D + L, x))
    got = np.asarray(
        line_ssor_solve(
            jnp.asarray(1.0 / d), jnp.asarray(am1), jnp.asarray(ap1),
            jnp.asarray(x),
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("sym", [True, False])
def test_apply_matches_reference_oracle(sym):
    s = gen.regular_system(5, sym)
    bands = s["bands"]
    n = 5**3
    rng = np.random.default_rng(7)
    x = rng.normal(size=n)
    want = reference_line_ilusolve(bands, x)
    got = np.asarray(jax.jit(LineILU.build(bands).apply)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("sym", [True, False])
def test_transpose_apply_matches_dense_transpose(sym):
    s = gen.regular_system(4, sym)
    bands = s["bands"]
    n = 4**3
    Minv = np.stack(
        [reference_line_ilusolve(bands, e) for e in np.eye(n)], axis=1
    )
    rng = np.random.default_rng(11)
    x = rng.normal(size=n)
    got = np.asarray(LineILU.build(bands, transpose=True).apply(jnp.asarray(x)))
    np.testing.assert_allclose(got, Minv.T @ x, rtol=1e-10, atol=1e-12)


def test_rectangular_grid():
    """Wavefront schedule on n2 != n3 grids (beyond the reference's cubes)."""
    rng = np.random.default_rng(13)
    n1, n2, n3 = 6, 4, 3
    bands = {0: 6.0 + rng.random((n1, n2, n3))}
    for p, ax in ((1, 0), (2, 1), (3, 2)):
        b = rng.normal(size=(n1, n2, n3))
        e = rng.normal(size=(n1, n2, n3))
        hi = [slice(None)] * 3
        hi[ax] = slice(-1, None)
        b[tuple(hi)] = 0.0
        lo = [slice(None)] * 3
        lo[ax] = slice(0, 1)
        e[tuple(lo)] = 0.0
        bands[p] = b
        bands[-p] = e
    x = rng.normal(size=n1 * n2 * n3)
    want = reference_line_ilusolve(bands, x)
    got = np.asarray(LineILU.build(bands).apply(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def test_precond4_beats_bjacobi_on_gmres_case():
    """u/10/1 at the validated maxit=10: golden residuals are 12.73 (none)
    and 3.89 (block-Jacobi); line-ILU must land well below both — it is
    block-Jacobi plus the inter-line coupling."""
    from lilac.workloads.sparsebench import run_case

    base = run_case("u", 10, 1, 0)
    lilu = run_case("u", 10, 1, 4)
    assert lilu.residual < 0.1 * base.residual
    assert lilu.residual < 1.0
