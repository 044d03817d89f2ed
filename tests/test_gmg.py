"""Geometric lattice block multigrid (solver/gmg.py).

Covers the same MUMPS role as solver/amg.py
(main.F90:354-390) on lattice-TOPOLOGY meshes; these tests pin the
properties the device V-cycle relies on:

  - device prolong_g/restrict_g are EXACTLY the scipy P / P^T used for the
    host Galerkin RAP (adjoint pair, even and odd axis sizes);
  - every Galerkin coarse operator stays a 3^d lattice block stencil and
    matches the scipy RAP to round-off;
  - GMG-PCG converges in SA-AMG-class iteration counts on a jittered box
    AND on the cohesive strip's true initial tangent (zero-stiffness seam
    + penalty-like K_coh(0) coupling — the geometric coarsening crosses
    the seam via RAP);
  - the preconditioner is symmetric (valid for CG).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from fem_tpu.io import meshgen
from fem_tpu.models.system import System
from fem_tpu.ops import blockstencil as bs
from fem_tpu.ops import cohesive as coh_ops
from fem_tpu.ops import operator as op_mod
from fem_tpu.solver import amg, cg, gmg

pytestmark = pytest.mark.slow  # ~221s on this host (round-4 module timing); the fast gate runs -m 'not slow'



@pytest.mark.parametrize("dims,pdim", [((5, 4), 2), ((4, 4), 2),
                                       ((7, 6, 4), 3), ((2, 5), 2)])
def test_transfers_match_scipy_prolongation(dims, pdim):
    rng = np.random.default_rng(0)
    P = gmg._prolongation(dims, pdim)
    nc_dims = tuple((d + 1) // 2 for d in dims)
    nnds, nc = int(np.prod(dims)), int(np.prod(nc_dims))
    xc = rng.standard_normal(nc * pdim)
    rf = rng.standard_normal(nnds * pdim)
    xc_g = jnp.asarray(xc.reshape(nc, pdim).T.reshape((pdim,) + nc_dims))
    out = np.asarray(gmg.prolong_g(xc_g, dims)).reshape(pdim, -1).T.reshape(-1)
    np.testing.assert_allclose(out, P @ xc, atol=1e-12)
    rf_g = jnp.asarray(rf.reshape(nnds, pdim).T.reshape((pdim,) + dims))
    rc = np.asarray(gmg.restrict_g(rf_g)).reshape(pdim, -1).T.reshape(-1)
    np.testing.assert_allclose(rc, P.T @ rf, atol=1e-12)
    # adjointness <P xc, rf> == <xc, P^T rf>
    assert abs(float(out @ rf) - float(xc @ rc)) < 1e-9 * (
        np.linalg.norm(out) * np.linalg.norm(rf) + 1e-30)


def test_constant_in_range_of_p():
    # rigid translations must be exactly representable (elasticity
    # near-nullspace); the even-edge weight-1 row is what preserves this
    for dims in [(6, 5), (4, 4), (5, 7, 4)]:
        P = gmg._prolongation(dims, 2)
        ones_c = np.ones(P.shape[1])
        np.testing.assert_allclose(P @ ones_c, np.ones(P.shape[0]),
                                   atol=1e-14)


def _jittered(n):
    p = meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0,
                                E=200e9, nu=0.3, tip_load=-1e6, jitter=0.25)
    s = System(p, dtype=jnp.float64)
    A = amg.assemble_csr(s)
    dims = bs.detect(A, s.pdim, s.nnds)
    assert dims is not None
    return s, A, dims


def test_galerkin_level_stays_lattice_and_matches_scipy():
    s, A, dims = _jittered(8)
    h = gmg.build_lattice(A, s.pdim, dims, bc_dofs=s.bc_dofs,
                          coarse_max=300, dtype=jnp.float64)
    assert h is not None and len(h.levels) >= 2
    A_el = amg._eliminate_bcs(A.tocsr(), np.asarray(s.bc_dofs))
    P1 = gmg._prolongation(dims, s.pdim)
    A1 = (P1.T @ (A_el @ P1)).tocsr()
    assert gmg._axis_offsets_ok(A1, s.pdim, h.levels[1].dims)
    rng = np.random.default_rng(1)
    x1 = rng.standard_normal(A1.shape[0])
    x1g = jnp.asarray(x1.reshape(-1, s.pdim).T.reshape(
        (s.pdim,) + h.levels[1].dims))
    y1 = np.asarray(bs.matvec_g(h.levels[1].op, x1g)).reshape(
        s.pdim, -1).T.reshape(-1)
    ref = A1 @ x1
    assert np.linalg.norm(y1 - ref) / np.linalg.norm(ref) < 1e-12


def _pcg_counts(s, A, dims, jmv=None, rtol=1e-9):
    bc_mask = jnp.zeros(s.ndof, bool).at[s.bc_dofs].set(True)
    fop = op_mod.build(s)
    base = jmv or (lambda v: op_mod.matvec(fop, v))
    Amv = cg.masked_operator(base, bc_mask)
    b0 = np.asarray(s.rhs(0.0))
    if np.linalg.norm(b0) == 0.0:
        b0 = np.random.default_rng(0).standard_normal(s.ndof)
    b = jnp.where(bc_mask, 0.0, jnp.asarray(b0))
    h = gmg.build_lattice(A, s.pdim, dims, bc_dofs=s.bc_dofs,
                          dtype=jnp.float64)
    assert h is not None
    dims_t = tuple(dims)

    def mv_g(v):
        return Amv(v.reshape(s.pdim, -1).T.reshape(-1)).reshape(
            -1, s.pdim).T.reshape((s.pdim,) + dims_t)

    def pc(r):
        rg = r.reshape(-1, s.pdim).T.reshape((s.pdim,) + dims_t)
        return gmg.v_cycle_g(h, mv_g, rg).reshape(s.pdim, -1).T.reshape(-1)

    res = cg.pcg(Amv, b, rtol=rtol, maxiter=400, precond=pc)
    bn = float(jnp.linalg.norm(b))
    assert float(res.resnorm) <= rtol * bn
    return int(res.iters), Amv, b, pc


def test_gmg_converges_jittered_box():
    s, A, dims = _jittered(8)
    iters, _, _, _ = _pcg_counts(s, A, dims)
    # SA takes ~12 on this deck; geometric transfers measured 11 at n=10
    assert iters <= 25


def test_gmg_mesh_independence():
    counts = []
    for n in (6, 10):
        s, A, dims = _jittered(n)
        iters, _, _, _ = _pcg_counts(s, A, dims)
        counts.append(iters)
    assert counts[1] <= counts[0] + 6


def test_semi_coarsening_on_anisotropic_deck():
    """The default cantilever deck's 10:1:1 element aspect (lx=10) makes
    the long axis's same-component face couplings non-negative — M-matrix
    strength 0 — while plain |a_ij| sums stay deceptively isotropic
    (shear terms). Isotropic factor-2 coarsening under the point-Chebyshev
    smoother stalled at 42 PCG iterations on the 6^3 deck; strength-guided
    semi-coarsening (coarsen only axes within 4x of the strongest) keeps
    the weak axis fine and restores SA-class counts (measured 51 vs SA 49
    at 28k dofs)."""
    p = meshgen.hex_box_problem(8, 8, 8, jitter=0.25)  # default lx=10
    s = System(p, dtype=jnp.float64)
    A = amg.assemble_csr(s)
    dims = bs.detect(A, s.pdim, s.nnds)
    A_el = amg._eliminate_bcs(A.tocsr(), np.asarray(s.bc_dofs))
    st = gmg._axis_strengths(A_el, s.pdim, dims)
    assert st[0] < 0.25 * st.max()  # weak long axis detected
    h = gmg.build_lattice(A, s.pdim, dims, bc_dofs=s.bc_dofs,
                          dtype=jnp.float64)
    assert h.levels[0].coarsen == (False, True, True)
    # coarse grid keeps full x resolution
    assert h.coarse_dims[0] == dims[0]
    iters, _, _, _ = _pcg_counts(s, A, dims)
    assert iters <= 40  # isotropic coarsening needed 42 at rtol 1e-5 ALONE


def test_gmg_preconditioner_is_symmetric():
    s, A, dims = _jittered(6)
    _, Amv, b, pc = _pcg_counts(s, A, dims)
    rng = np.random.default_rng(2)
    u = jnp.asarray(rng.standard_normal(s.ndof))
    v = jnp.asarray(rng.standard_normal(s.ndof))
    left = float(jnp.dot(pc(u), v))
    right = float(jnp.dot(u, pc(v)))
    assert abs(left - right) < 1e-8 * (abs(left) + abs(right) + 1e-30)


def test_gmg_cohesive_true_tangent_beats_sa_class_counts():
    """The production cohesive shape: strip lattice with the zero-stiffness
    seam and the penalty-like zero-opening Xu-Needleman tangent added
    (mirrors newton._matfree_amg_cache). GMG must stay in SA's iteration
    class (measured: 6 vs SA 9 at the 3e-5 inner tolerance at 180x36)."""
    p = meshgen.cohesive_interface_problem(
        90, 18, lx=5.0, ly_half=1.0, E=3640.0, open_disp=0.015, t=1.0,
        dt=0.5, coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0))
    s = System(p, dtype=jnp.float64)
    A_el = amg.assemble_csr(s)
    dims = bs.detect(A_el, s.pdim, s.nnds)
    assert dims is not None
    e0 = s.blocks["coh"]
    ue0 = jnp.zeros(e0["edofs"].shape, dtype=jnp.float64)
    ke0 = np.asarray(coh_ops.element_stiffness(
        e0["ecoords"], e0["props"], ue0, s.dt))
    ed = np.asarray(e0["edofs"])
    nde = ed.shape[1]
    rows = np.repeat(ed, nde, axis=1).reshape(-1)
    cols = np.tile(ed, (1, nde)).reshape(-1)
    A_t = (A_el + sp.coo_matrix((ke0.reshape(-1), (rows, cols)),
                                shape=A_el.shape).tocsr())

    def jmv(v):
        out = op_mod.matvec(op_mod.build(s), v)
        fe = jnp.einsum("eab,eb->ea", jnp.asarray(ke0), v[jnp.asarray(ed)])
        return out.at[jnp.asarray(ed).reshape(-1)].add(fe.reshape(-1))

    iters, _, _, _ = _pcg_counts(s, A_t, dims, jmv=jmv, rtol=3e-5)
    assert iters <= 15


def test_v_cycle_cm_matches_v_cycle_g():
    s, A, dims = _jittered(6)
    h = gmg.build_lattice(A, s.pdim, dims, bc_dofs=s.bc_dofs,
                          dtype=jnp.float64)
    op_f = bs.build(amg._eliminate_bcs(A.tocsr(), np.asarray(s.bc_dofs)),
                    s.pdim, dims, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    r_cm = jnp.asarray(rng.standard_normal((s.pdim, s.nnds)))

    def mv_cm(v):
        return bs.matvec_cm(op_f, v)

    z_cm = gmg.v_cycle_cm(h, mv_cm, r_cm)
    dims_t = tuple(dims)

    def mv_g(v):
        return bs.matvec_g(op_f, v)

    z_g = gmg.v_cycle_g(h, mv_g, r_cm.reshape((s.pdim,) + dims_t))
    np.testing.assert_allclose(np.asarray(z_cm),
                               np.asarray(z_g).reshape(s.pdim, -1),
                               rtol=1e-12, atol=1e-14)


def test_stepper_linear_amg_branch_prefers_gmg():
    """The production stepper's LINEAR unstructured branch preconditions
    with the geometric lattice MG when the deck's assembled topology is a
    lattice (and falls back to SA-AMG when FEM_TPU_NO_GMG=1), matching the
    direct solve either way. Covers the same MUMPS role on `python -m
    fem_tpu` decks (main.F90:354-390)."""
    import os

    from fem_tpu.config import Config
    from fem_tpu.solver import stepper

    p = meshgen.hex_box_problem(5, 5, 5, jitter=0.25)
    # production gates GMG to >20k dofs (below that SA's dense coarse
    # inverse is a direct solve); drive the route on this tiny deck
    os.environ["FEM_TPU_GMG_MIN"] = "1"
    try:
        msgs = []
        r = stepper.run(p, Config(solver="cg", precond="amg"),
                        log=msgs.append)
        assert any("Geometric lattice-MG" in m for m in msgs)
        r_dir = stepper.run(p, Config(solver="direct"))
        nu = np.linalg.norm(r_dir.aggregate_u)
        assert np.linalg.norm(r.aggregate_u - r_dir.aggregate_u) < 1e-7 * nu
        # SA fallback stays available and exact
        os.environ["FEM_TPU_NO_GMG"] = "1"
        try:
            msgs2 = []
            r2 = stepper.run(p, Config(solver="cg", precond="amg"),
                             log=msgs2.append)
            assert not any("Geometric lattice-MG" in m for m in msgs2)
            assert np.linalg.norm(
                r2.aggregate_u - r_dir.aggregate_u) < 1e-7 * nu
        finally:
            del os.environ["FEM_TPU_NO_GMG"]
    finally:
        del os.environ["FEM_TPU_GMG_MIN"]


def test_stepper_demotes_poisoned_gmg(monkeypatch):
    """Production acceptance demotion (VERDICT r4 #3): a 2D lattice deck
    whose compiled grid V-cycle is corrupt (modeled by a NaN poison — the
    observed miscompile-#6 signature) must still converge through
    stepper.run via the SA-AMG demotion, matching the direct solve."""
    from fem_tpu.config import Config
    from fem_tpu.solver import stepper

    p = meshgen.quad_grid_problem(10, 6, E=100.0, nu=0.3,
                                  tip_force=(0.0, -1.0))
    # jitter interior nodes: keeps the LATTICE topology (block-stencil +
    # geometric MG route) but defeats the uniform-structured tier-1 path
    rng = np.random.default_rng(0)
    c = p.coords
    interior = ((c[:, 0] > 0) & (c[:, 0] < 1.0 - 1e-9)
                & (c[:, 1] > 0) & (c[:, 1] < 1.0 - 1e-9))
    c[interior] += 0.02 * (rng.random((int(interior.sum()), 2)) - 0.5)
    monkeypatch.setenv("FEM_TPU_GMG_MIN", "1")
    real_v = gmg.v_cycle_g
    monkeypatch.setattr(gmg, "v_cycle_g",
                        lambda h, mv, r: real_v(h, mv, r) * jnp.nan)
    msgs = []
    r = stepper.run(p, Config(solver="cg", precond="amg"), log=msgs.append)
    assert any("Geometric lattice-MG" in m for m in msgs)
    assert any("SA-AMG demotion" in m for m in msgs)
    r_dir = stepper.run(p, Config(solver="direct"))
    nu = np.linalg.norm(r_dir.aggregate_u)
    assert np.linalg.norm(r.aggregate_u - r_dir.aggregate_u) < 1e-7 * nu


def test_stepper_takes_sa_when_lattice_declines(monkeypatch):
    """When build_lattice gives no hierarchy the stepper preconditions with
    SA-AMG and still matches the direct solve."""
    from fem_tpu.config import Config
    from fem_tpu.solver import stepper

    p = meshgen.hex_box_problem(5, 5, 5, jitter=0.25)
    monkeypatch.setenv("FEM_TPU_GMG_MIN", "1")
    monkeypatch.setattr(gmg, "build_lattice", lambda *a, **k: None)
    msgs = []
    r = stepper.run(p, Config(solver="cg", precond="amg"), log=msgs.append)
    assert not any("Geometric lattice-MG" in m for m in msgs)
    assert any("AMG preconditioner" in m for m in msgs)
    r_dir = stepper.run(p, Config(solver="direct"))
    nu = np.linalg.norm(r_dir.aggregate_u)
    assert np.linalg.norm(r.aggregate_u - r_dir.aggregate_u) < 1e-7 * nu
