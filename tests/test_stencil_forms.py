"""Equivalence of the stencil-operator matvec formulations.

matvec (matmul form, the solvers' schedule), matvec_planes (fused
27/9-point component-planes stencil) and matvec_pairs (corner-pair slice
form) are three schedules of the same operator (m_local.F90:21-67
discretization on a box grid); they must agree to round-off.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.ops import structured
from fem_tpu.ops.stiffness import lame


@pytest.mark.parametrize(
    "shape,cells",
    [((9, 7, 6), (0.1, 0.2, 0.15)), ((8, 5), (0.3, 0.2))],
)
def test_matvec_forms_agree(shape, cells):
    lam, mu = lame(jnp.asarray(200e9), jnp.asarray(0.3))
    op = structured.build(cells, shape, lam, mu)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(op.ndof))
    f0 = structured.matvec(op, u)
    f1 = structured.matvec_planes(op, u)
    f2 = structured.matvec_pairs(op, u)
    nrm = float(jnp.linalg.norm(f0))
    assert float(jnp.linalg.norm(f1 - f0)) < 1e-12 * nrm
    assert float(jnp.linalg.norm(f2 - f0)) < 1e-12 * nrm


@pytest.mark.parametrize(
    "shape,cells",
    [((4, 4, 4), (0.1, 0.1, 0.1)),  # all-boundary cube: every node on a face
     ((9, 3, 5), (0.1, 0.2, 0.15)),  # thin slab: faces dominate
     ((3, 3), (0.5, 0.5)),
     ((12, 9), (0.3, 0.2))],
)
def test_matvec_planes_boundaries(shape, cells):
    """The planes form's per-corner cell masks must be exact on edges and
    corners (nodes on several faces at once) and on grids where no
    interior exists."""
    lam, mu = lame(jnp.asarray(70e9), jnp.asarray(0.25))
    op = structured.build(cells, shape, lam, mu)
    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.standard_normal(op.ndof))
    f0 = structured.matvec(op, u)
    f1 = structured.matvec_planes(op, u)
    nrm = float(jnp.linalg.norm(f0))
    assert float(jnp.linalg.norm(f1 - f0)) < 1e-12 * nrm


def test_matvec_pairs_heterogeneous():
    shape = (7, 6, 5)
    lam, mu = lame(jnp.asarray(1.0), jnp.asarray(0.3))
    op = structured.build((0.2, 0.3, 0.1), shape, lam, mu)
    rng = np.random.default_rng(1)
    cells = tuple(n - 1 for n in shape)
    oph = structured.StencilOperator(
        k_lam=op.k_lam, k_mu=op.k_mu,
        lam=jnp.asarray(rng.uniform(1.0, 2.0, cells)),
        mu=jnp.asarray(rng.uniform(0.5, 1.0, cells)),
        shape=shape,
    )
    u = jnp.asarray(rng.standard_normal(oph.ndof))
    f0 = structured.matvec(oph, u)
    f2 = structured.matvec_pairs(oph, u)
    nrm = float(jnp.linalg.norm(f0))
    assert float(jnp.linalg.norm(f2 - f0)) < 1e-12 * nrm


def test_matvec_planes_rejects_fields():
    shape = (4, 4)
    lam, mu = lame(jnp.asarray(1.0), jnp.asarray(0.3))
    op = structured.build((1.0, 1.0), shape, lam, mu)
    oph = structured.StencilOperator(
        k_lam=op.k_lam, k_mu=op.k_mu,
        lam=jnp.ones((3, 3)), mu=jnp.ones((3, 3)), shape=shape,
    )
    with pytest.raises(NotImplementedError):
        structured.matvec_planes(oph, jnp.zeros(oph.ndof))


def test_pcg_chunked_matches_pcg():
    from fem_tpu.solver import cg

    lam, mu = lame(jnp.asarray(200e9), jnp.asarray(0.3))
    shape = (9, 9, 9)
    op = structured.build((0.125,) * 3, shape, lam, mu)
    n = op.ndof
    rng = np.random.default_rng(2)
    bc = np.arange(0, n, 97)
    bc_mask = jnp.zeros(n, bool).at[bc].set(True)
    mf = jnp.asarray(bc_mask, jnp.float64)
    b = jnp.asarray(rng.standard_normal(n)) * (1.0 - mf)

    def mv(ops, v):
        keep = 1.0 - mf
        return structured.matvec(ops, v * keep) * keep + v * mf

    d = structured.diag(op) * (1.0 - mf) + mf

    def pc(ops, r):
        return r / d

    res_c = cg.pcg_chunked(mv, b, pc, op, rtol=1e-10, maxiter=3000, chunk=7)
    A = cg.masked_operator(lambda v: structured.matvec(op, v), bc_mask)
    res = cg.pcg(A, b, rtol=1e-10, maxiter=3000, diag=d)
    bn = float(jnp.linalg.norm(b))
    assert float(res_c.resnorm) <= 1e-10 * bn
    nrm = float(jnp.linalg.norm(res.x))
    assert float(jnp.linalg.norm(res_c.x - res.x)) < 1e-6 * nrm

    # the speculative 1-deep pipeline must produce the identical iterate
    # sequence (same programs, same chunk boundaries — only the dispatch
    # order changes), so x matches pcg_chunked bit-for-bit and convergence
    # is reported at the same chunk count
    res_p = cg.pcg_chunked(mv, b, pc, op, rtol=1e-10, maxiter=3000, chunk=7,
                           pipeline=True)
    assert int(res_p.iters) == int(res_c.iters)
    assert float(jnp.linalg.norm(res_p.x - res_c.x)) == 0.0
    assert float(res_p.resnorm) <= 1e-10 * bn


def test_pcg_chunked_midchunk_convergence_is_nan_safe():
    """CG that converges MID-CHUNK must not poison the remaining unrolled
    iterations: with an identity operator the exact solution lands after
    one iteration (r becomes exactly 0, rz -> 0), and the unguarded
    alpha = rz/pAp of iterations 2..chunk was 0/0 = NaN (observed as an
    all-NaN stepper solve on a prescribed-displacement lattice deck).
    The guarded scalar alpha/beta freeze the state instead."""
    from fem_tpu.solver import cg

    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(64), jnp.float32)

    def mv(ops, v):
        return v

    def pc(ops, r):
        return r

    res = cg.pcg_chunked(mv, b, pc, None, rtol=1e-7, maxiter=20, chunk=5)
    assert bool(jnp.all(jnp.isfinite(res.x)))
    assert float(jnp.linalg.norm(res.x - b)) == 0.0
    res_p = cg.pcg_chunked(mv, b, pc, None, rtol=1e-7, maxiter=20, chunk=5,
                           pipeline=True)
    assert bool(jnp.all(jnp.isfinite(res_p.x)))
    assert float(jnp.linalg.norm(res_p.x - b)) == 0.0
