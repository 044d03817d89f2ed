"""Newton-with-line-search for the cohesive nonlinear step (SNES equivalent).

Replicates the reference's SNESNEWTONLS setup (main.F90:199-214, callbacks
CalcJacobian m_global.F90:98-158 and CalcResidual m_global.F90:161-235):

  residual  R(du) = J(du) @ du - F_ext - F_coh(aggregate_u + du)
            with the BC rows overridden (penalty: R_bc = p*du_bc - p*u_bc_step)
  jacobian  J(du) = K_elastic + K_coh(aggregate_u + du) + BC rows

Note the reference residual multiplies by the *Jacobian* (elastic + cohesive
tangent), not the plain elastic K (MatMultAdd(Jacobian, du, ...),
m_global.F90:226). `formulation="reference"` reproduces that;
`formulation="standard"` uses the textbook incremental residual
R = K_el @ du - F_ext - F_coh(aggregate_u + du), whose consistent Jacobian is
the same J. Both share fixed points when K_coh @ du ~ 0 (the shipped decks'
cohesive elements sit on initially-closed interfaces).

Newton controls mirror SNES defaults: rtol 1e-8 (relative to the first
residual of each solve), atol 1e-50, stol 1e-8, max 50 iterations, with a
backtracking line search.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fem_tpu.config import Config
from fem_tpu.models.system import PENALTY, System
from fem_tpu.solver import direct



# Host-sync instrumentation: every device->host scalar read in the dense
# Newton paths goes through _host() so tests can count syncs
# (tests/test_jit_newton.py asserts solve_step_jit uses >=5x fewer).
SYNC_COUNT = 0


def _host(x):
    global SYNC_COUNT
    SYNC_COUNT += 1
    return float(x)


def _norm_safe(x):
    """2-norm that survives a narrow exponent range: penalty-BC residual
    rows are ~1e30, whose squares overflow to inf/nan in any f64 emulated
    with an f32 exponent (and in f32) inside a plain jnp.linalg.norm — the
    golden cohesive deck then reports 'converged' at 0 iterations. Scale by
    max|x| before squaring; same cost class, jit- and eager-safe."""
    m = jnp.max(jnp.abs(x))
    m = jnp.where(m > 0, m, jnp.ones_like(m))
    y = x / m
    return m * jnp.sqrt(jnp.sum(y * y))


class NewtonResult(NamedTuple):
    du: jnp.ndarray
    iters: int
    resnorm: float
    converged: bool
    # number of inner solves that used the GMRES indefinite-tangent fallback
    # (matfree path only; see solve_step_matfree)
    gmres_fallbacks: int = 0
    # total inner Krylov iterations across all Newton iterations
    # (matfree path only; the reference's KSP iteration telemetry role)
    inner_iters: int = 0


def solve_step(
    system: System,
    config: Config,
    aggregate_u,
    du0,
    F_ext,
    bc_mode: str = "penalty",
):
    """One nonlinear load increment. du0 is the warm start (the reference
    never zeroes Vec_U between steps, main.F90:230)."""
    quirks = config.quirks
    reference_form = config.resolve_formulation(bc_mode) == "reference"
    bc_dofs = system.bc_dofs
    bc_vals = system.bc_step_vals()
    n = system.ndof
    bc_mask = jnp.zeros(n, dtype=bool).at[bc_dofs].set(True)
    ubc = jnp.zeros(n, dtype=F_ext.dtype).at[bc_dofs].set(bc_vals)

    K_el = system.dense_K()

    def jacobian_raw(du):
        """K_el + cohesive tangent, no BC treatment."""
        return K_el + system.coh_stiffness_dense(aggregate_u + du, quirks)

    def jacobian(du):
        """BC-treated Jacobian used for the linear solves."""
        J = jacobian_raw(du)
        if bc_mode == "penalty":
            J = J.at[bc_dofs, bc_dofs].set(PENALTY)
        else:
            J = jnp.where(bc_mask[:, None] | bc_mask[None, :], 0.0, J)
            J = J.at[bc_dofs, bc_dofs].set(1.0)
        return J

    def residual(du, J_solve):
        # F = F_ext + F_coh, then BC rows inserted, then R = J du - F
        # (m_global.F90:186-226). The multiply must use the RAW operator so
        # free equations see the K[free,bc] * u_bc coupling; only the bc ROWS
        # are overridden.
        del J_solve
        F = F_ext + system.coh_force(aggregate_u + du, quirks)
        if bc_mode == "penalty":
            F = F.at[bc_dofs].set(PENALTY * bc_vals)
            mul = jacobian_raw(du) if reference_form else K_el
            mul = mul.at[bc_dofs, bc_dofs].set(PENALTY)
            return mul @ du - F
        mul = jacobian_raw(du) if reference_form else K_el
        R = mul @ du - F
        return jnp.where(bc_mask, du - ubc, R)

    du = du0
    if bc_mode == "eliminate":
        du = jnp.where(bc_mask, ubc, du)

    J = jacobian(du)
    R = residual(du, J)
    r0 = _host(_norm_safe(R))
    rnorm = r0
    tol = max(config.newton_rtol * r0, config.newton_atol)

    iters = 0
    converged = rnorm <= tol
    kref = jnp.max(jnp.abs(K_el))  # physical scale for null-pivot detection
    while not converged and iters < config.newton_maxit:
        delta = _robust_solve(J, -R, ref=kref)
        # Backtracking line search (SNESNEWTONLS-style sufficient decrease).
        lam = 1.0
        best_lam, best_r = None, rnorm
        for _ in range(20):
            du_trial = du + lam * delta
            if bc_mode == "eliminate":
                du_trial = jnp.where(bc_mask, ubc, du_trial)
            R_trial = residual(du_trial, J)
            r_trial = _host(_norm_safe(R_trial))
            if jnp.isfinite(jnp.asarray(r_trial)) and r_trial < best_r:
                best_lam, best_r = lam, r_trial
                if r_trial <= (1.0 - 1e-4 * lam) * rnorm:
                    break
            lam *= 0.5
        if best_lam is None:
            # Line search failed to find any decrease: stagnation
            # (SNES would report a line-search failure and stop).
            break
        du_new = du + best_lam * delta
        if bc_mode == "eliminate":
            du_new = jnp.where(bc_mask, ubc, du_new)
        step_norm = _host(_norm_safe(du_new - du))
        du = du_new
        iters += 1
        J = jacobian(du)
        R = residual(du, J)
        rnorm = _host(_norm_safe(R))
        if rnorm <= tol:
            converged = True
            break
        if step_norm <= config.newton_stol * max(_host(_norm_safe(du)), 1e-300):
            converged = True
            break

    return NewtonResult(du=du, iters=iters, resnorm=rnorm, converged=converged)


def _coh_force_arrays(ecoords, props, edofs, dt, u_total, quirks: bool):
    """F_coh(u_total) from raw cohesive-block arrays (module-level so jitted
    callers key their trace cache on array shapes, not closure identity)."""
    from fem_tpu.ops import cohesive as coh_ops

    ue = u_total[edofs]
    fe = coh_ops.element_force(ecoords, props, ue, dt, quirks)
    out = jnp.zeros(u_total.shape[0], dtype=u_total.dtype)
    return out.at[edofs.reshape(-1)].add(fe.reshape(-1))


def _coh_stiffness_dense_arrays(ecoords, props, edofs, dt, u_total,
                                quirks: bool, ndof: int):
    from fem_tpu.ops import cohesive as coh_ops

    ue = u_total[edofs]
    ke = coh_ops.element_stiffness(ecoords, props, ue, dt, quirks)
    K = jnp.zeros((ndof, ndof), dtype=u_total.dtype)
    return K.at[edofs[:, :, None], edofs[:, None, :]].add(ke)


@functools.partial(
    jax.jit, static_argnames=("penalty", "reference_form", "quirks",
                              "eliminate")
)
def _dense_newton_iterate(
    K_el, ecoords, props, edofs, dt, F_ext, aggregate_u,
    bc_dofs, bc_vals, bc_mask, ubc, du, rnorm,
    *, penalty: bool, reference_form: bool, quirks: bool, eliminate: bool,
):
    """One dense Newton iteration (Jacobian, robust solve, backtracking line
    search, norms) as a single jitted program. Module-level with every array
    passed as an ARGUMENT: a per-call closure would embed K_el and the
    system arrays as HLO constants (bloating the program) and retrace every
    load step (ADVICE r2)."""
    n = du.shape[0]

    def jacobian_raw(du):
        return K_el + _coh_stiffness_dense_arrays(
            ecoords, props, edofs, dt, aggregate_u + du, quirks, n
        )

    def jacobian(du):
        J = jacobian_raw(du)
        if penalty:
            return J.at[bc_dofs, bc_dofs].set(PENALTY)
        J = jnp.where(bc_mask[:, None] | bc_mask[None, :], 0.0, J)
        return J.at[bc_dofs, bc_dofs].set(1.0)

    def residual(du):
        F = F_ext + _coh_force_arrays(
            ecoords, props, edofs, dt, aggregate_u + du, quirks
        )
        if penalty:
            F = F.at[bc_dofs].set(PENALTY * bc_vals)
            mul = jacobian_raw(du) if reference_form else K_el
            mul = mul.at[bc_dofs, bc_dofs].set(PENALTY)
            return mul @ du - F
        mul = jacobian_raw(du) if reference_form else K_el
        R = mul @ du - F
        return jnp.where(bc_mask, du - ubc, R)

    def pin(du):
        return jnp.where(bc_mask, ubc, du) if eliminate else du

    def robust_solve(J, rhs):
        # Null-pivot regularization (MUMPS icntl(24)=1 equivalent), jit-safe.
        # The null threshold is relative to the PHYSICAL stiffness scale
        # (max |K_el|), NOT max row of J: with penalty BCs the J diagonal
        # carries 1e30 rows, and a max-of-J reference flags every physical
        # row as null (delta ~ 0, Newton stalls — found live on the golden
        # cohesive deck; MUMPS detects null pivots AFTER equilibration, so
        # penalty rows never poison its scale either, main.F90:365-371).
        row_scale = jnp.max(jnp.abs(J), axis=1)
        ref = jnp.maximum(jnp.max(jnp.abs(K_el)), 1e-300)
        nullf = (row_scale <= 1e-12 * ref).astype(J.dtype)
        keep = 1.0 - nullf
        J2 = J * keep[:, None] * keep[None, :] + jnp.diag(nullf)
        rhs2 = rhs * keep
        x = jnp.linalg.solve(J2, rhs2)

        def fallback():
            return jnp.linalg.lstsq(J2, rhs2, rcond=None)[0]

        return jax.lax.cond(jnp.all(jnp.isfinite(x)), lambda: x, fallback)

    J = jacobian(du)
    R = residual(du)
    delta = robust_solve(J, -R)

    # backtracking line search, same policy as solve_step
    def trial_r(lam):
        return _norm_safe(residual(pin(du + lam * delta)))

    def cond(c):
        lam, best_lam, best_r, tries, done = c
        return jnp.logical_and(~done, tries < 20)

    def body(c):
        lam, best_lam, best_r, tries, done = c
        r_t = trial_r(lam)
        better = jnp.logical_and(jnp.isfinite(r_t), r_t < best_r)
        best_lam = jnp.where(better, lam, best_lam)
        best_r = jnp.where(better, r_t, best_r)
        done = jnp.logical_and(better, r_t <= (1.0 - 1e-4 * lam) * rnorm)
        return (lam * 0.5, best_lam, best_r, tries + 1, done)

    init = (
        jnp.asarray(1.0, du.dtype),
        jnp.asarray(jnp.nan, du.dtype),
        rnorm,
        0,
        jnp.asarray(False),
    )
    _, best_lam, best_r, _, _ = jax.lax.while_loop(cond, body, init)
    found = jnp.isfinite(best_lam)
    du_new = pin(du + jnp.where(found, best_lam, 0.0) * delta)
    step_norm = _norm_safe(du_new - du)
    r_new = _norm_safe(residual(du_new))
    return du_new, jnp.stack(
        [r_new, step_norm, _norm_safe(du_new),
         found.astype(du.dtype)]
    )


def solve_step_jit(
    system: System,
    config: Config,
    aggregate_u,
    du0,
    F_ext,
    bc_mode: str = "penalty",
):
    """solve_step with the ENTIRE Newton iteration (residual, Jacobian,
    robust solve, backtracking line search, convergence tests) inside one
    jitted function — exactly ONE host sync per Newton iteration (the
    convergence read), vs ~4-24 for the host-driven solve_step (per-trial
    line-search norms, step norms). Iterates are identical to solve_step up
    to fusion round-off (asserted in tests/test_jit_newton.py).

    The loop itself stays on the host (one dispatch per iteration) rather
    than in lax.while_loop: deep loop bodies carrying state miscompiled on
    an earlier accelerator backend (DESIGN.md #2), and a deck-scale
    dispatch is ~ms. SNES semantics follow m_global.F90:98-235.
    """
    global SYNC_COUNT
    quirks = config.quirks
    reference_form = config.resolve_formulation(bc_mode) == "reference"
    bc_dofs = system.bc_dofs
    bc_vals = system.bc_step_vals()
    n = system.ndof
    bc_mask = jnp.zeros(n, dtype=bool).at[bc_dofs].set(True)
    ubc = jnp.zeros(n, dtype=F_ext.dtype).at[bc_dofs].set(bc_vals)

    K_el = system.dense_K()
    penalty = bc_mode == "penalty"
    e = system.blocks["coh"]
    dt = jnp.asarray(system.dt, dtype=F_ext.dtype)

    def residual(du):
        F = F_ext + system.coh_force(aggregate_u + du, quirks)
        if penalty:
            F = F.at[bc_dofs].set(PENALTY * bc_vals)
            mul = K_el + (
                system.coh_stiffness_dense(aggregate_u + du, quirks)
                if reference_form else 0.0
            )
            mul = mul.at[bc_dofs, bc_dofs].set(PENALTY)
            return mul @ du - F
        mul = K_el + (
            system.coh_stiffness_dense(aggregate_u + du, quirks)
            if reference_form else 0.0
        )
        R = mul @ du - F
        return jnp.where(bc_mask, du - ubc, R)

    def pin(du):
        return jnp.where(bc_mask, ubc, du) if bc_mode == "eliminate" else du

    def iterate(du, rnorm):
        return _dense_newton_iterate(
            K_el, e["ecoords"], e["props"], e["edofs"], dt, F_ext,
            aggregate_u, bc_dofs, bc_vals, bc_mask, ubc, du, rnorm,
            penalty=penalty, reference_form=reference_form, quirks=quirks,
            eliminate=(bc_mode == "eliminate"),
        )

    du = pin(du0)
    R0 = residual(du)
    r0 = _host(_norm_safe(R0))
    rnorm = r0
    tol = max(config.newton_rtol * r0, config.newton_atol)
    iters = 0
    converged = rnorm <= tol
    while not converged and iters < config.newton_maxit:
        du_new, stats = iterate(du, jnp.asarray(rnorm, du.dtype))
        SYNC_COUNT += 1
        stats = np.asarray(stats)  # the ONE host sync of this iteration
        rnorm_new, step_norm, du_norm, found = (
            float(stats[0]), float(stats[1]), float(stats[2]), bool(stats[3]),
        )
        if not found:
            break
        du = du_new
        rnorm = rnorm_new
        iters += 1
        if rnorm <= tol:
            converged = True
            break
        if step_norm <= config.newton_stol * max(du_norm, 1e-300):
            converged = True
            break

    return NewtonResult(du=du, iters=iters, resnorm=rnorm, converged=converged)


def solve_step_total(
    system: System,
    config: Config,
    aggregate_u,
    du0,
    t_end,
):
    """True-equilibrium Newton for the cohesive step (formulation="total").

    The reference's incremental scheme re-applies the TOTAL cohesive force
    as a load every increment (CalcResidual copies Vec_F and adds
    F_coh(aggregate+du) each step, m_global.F90:186-206, while the elastic
    term only sees the increment), so over k steps it solves
    K u = F_ext + sum_j F_coh(u_j) — a drifting approximation, visible in
    its own captured log where u grows linearly under constant BCs. This
    solver instead converges the actual equilibrium at time t_end:

        R(u) = K_el u - F_ext_cumulative(t_end) - F_coh(u),   u = agg + du

    with consistent Jacobian K_el + K_coh(u), eliminated BCs pinned to the
    total ramp value. This is what matches the Abaqus UEL cross-validation.
    """
    quirks = config.quirks
    bc_dofs = system.bc_dofs
    bc_vals = system.bc_total_vals(t_end)
    n = system.ndof
    bc_mask = jnp.zeros(n, dtype=bool).at[bc_dofs].set(True)
    u_bc = jnp.zeros(n, dtype=system.dtype).at[bc_dofs].set(bc_vals)
    F_ext = system.rhs_cumulative(t_end)

    K_el = system.dense_K()

    def residual(u):
        F = F_ext + system.coh_force(u, quirks)
        R = K_el @ u - F
        return jnp.where(bc_mask, u - u_bc, R)

    def jacobian(u):
        J = K_el + system.coh_stiffness_dense(u, quirks)
        J = jnp.where(bc_mask[:, None] | bc_mask[None, :], 0.0, J)
        return J.at[bc_dofs, bc_dofs].set(1.0)

    def pin(u):
        mf = bc_mask.astype(u.dtype)
        return u * (1.0 - mf) + u_bc * mf

    u = pin(aggregate_u + du0)
    R = residual(u)
    r0 = float(_norm_safe(R))
    rnorm = r0
    tol = max(config.newton_rtol * r0, config.newton_atol)
    iters = 0
    converged = rnorm <= tol
    kref = jnp.max(jnp.abs(K_el))  # physical scale for null-pivot detection
    while not converged and iters < config.newton_maxit:
        J = jacobian(u)
        delta = _robust_solve(J, -R, ref=kref)
        lam = 1.0
        best_lam, best_r = None, rnorm
        for _ in range(25):
            r_trial = float(_norm_safe(residual(pin(u + lam * delta))))
            if jnp.isfinite(jnp.asarray(r_trial)) and r_trial < best_r:
                best_lam, best_r = lam, r_trial
                if r_trial <= (1.0 - 1e-4 * lam) * rnorm:
                    break
            lam *= 0.5
        if best_lam is None:
            break
        u_new = pin(u + best_lam * delta)
        step_norm = float(_norm_safe(u_new - u))
        u = u_new
        iters += 1
        R = residual(u)
        rnorm = float(_norm_safe(R))
        if rnorm <= tol:
            converged = True
            break
        if step_norm <= config.newton_stol * max(float(_norm_safe(u)), 1e-300):
            converged = True
            break

    return NewtonResult(du=u - aggregate_u, iters=iters, resnorm=rnorm,
                        converged=converged)


# ---------------- matrix-free inner-solve operators ----------------
#
# Module-level functions parameterized ENTIRELY by the `ops` pytree: the
# chunked-CG program cache (cg._chunk_programs) keys on function identity,
# so these must be stable objects — per-call closures would retrace the
# minutes-long chunk program every Newton solve (ADVICE r2).


def _el_mv_flat(fop, v):
    """Flat (ndof,) elastic K @ v for either fine-operator tier (fused
    gathers or lattice block stencil — the two-block cohesive strip's
    elastic graph embeds in one lattice, the seam rows carrying zero
    blocks). Pytree-type dispatch at trace time."""
    from fem_tpu.ops import blockstencil as bs_mod
    from fem_tpu.ops import operator as op_mod

    if isinstance(fop, bs_mod.BlockStencilOperator):
        return bs_mod.matvec(fop, v)
    return op_mod.matvec(fop, v)


def _mf_jac_mv(ops, v):
    """Masked J @ v = (K_el + K_coh(u)) @ v on flat (ndof,) state.

    The cohesive tangent ke (ne, nde, nde) is precomputed once per Newton
    ITERATION (it depends on u only), so each CG application pays one tiny
    einsum + scatter on top of the fused elastic matvec. Float-mask
    arithmetic throughout (bool selects on matvec outputs are miscompile
    #1, DESIGN.md). Flat-state fused combines are used at cohesive-deck
    sizes (miscompile #5 was seen at ~1.59M dofs on grid programs; the
    guard is the true-residual check in inner_solve)."""
    keep, mf = ops["keep"], ops["mf"]
    vk = v * keep
    out = _el_mv_flat(ops["fop"], vk)
    edofs = ops["edofs"]
    fe = jnp.einsum("eab,eb->ea", ops["ke"], vk[edofs])
    out = out.at[edofs.reshape(-1)].add(fe.reshape(-1))
    return out * keep + v * mf


def _mf_amg_pc(ops, r):
    """Elastic SA-AMG V-cycle preconditioner; the fine smoother sees the
    full J matvec (K_coh only perturbs interface rows)."""
    from fem_tpu.solver import amg as amg_mod

    return amg_mod.v_cycle(ops["hier"], lambda v: _mf_jac_mv(ops, v), r)


def _mf_jac_mv_cm(ops, v_cm):
    """Masked J @ v in COMPONENT-MAJOR (pdim, nnds) — the lattice tier.

    When the elastic graph embeds in a lattice (the cohesive strip's two
    blocks in one lattice with zero seam blocks), cm state makes the
    elastic matvec a gather-free block stencil (bs.matvec_cm). A flat
    tier would pay bs.matvec's two in-program transposes per apply;
    carrying cm state end-to-end
    through the inner CG removes them (one eager transpose per SOLVE at
    the boundary instead of two per MATVEC). The cohesive tangent term
    gathers/scatters via (comp, node)-decomposed edofs."""
    from fem_tpu.ops import blockstencil as bs_mod

    keep, mf = ops["keep_cm"], ops["mf_cm"]
    vk = v_cm * keep
    out = bs_mod.matvec_cm(ops["fop_cm"], vk)
    ec, en = ops["ed_comp"], ops["ed_node"]
    ue = vk[ec, en]  # (ne, nde)
    fe = jnp.einsum("eab,eb->ea", ops["ke"], ue)
    out = out.at[ec.reshape(-1), en.reshape(-1)].add(fe.reshape(-1))
    return out * keep + v_cm * mf


def _mf_amg_pc_cm(ops, r_cm):
    from fem_tpu.solver import amg as amg_mod

    return amg_mod.v_cycle_cm(ops["hier"],
                              lambda v: _mf_jac_mv_cm(ops, v), r_cm)


def _mf_gmg_pc_cm(ops, r_cm):
    """Geometric lattice-multigrid V-cycle on cm state (solver/gmg.py):
    every level a gather-free block stencil. Replaces the SA V-cycle on
    lattice decks, whose first coarse level's ELL gather matvec dominates
    it; see gmg.py's module docstring."""
    from fem_tpu.solver import gmg as gmg_mod

    return gmg_mod.v_cycle_cm(ops["hier_g"],
                              lambda v: _mf_jac_mv_cm(ops, v), r_cm)


@functools.partial(jax.jit, static_argnames=("quirks",))
def _coh_ke(ecoords, props, edofs, dt, u_total, *, quirks: bool):
    """Cohesive element tangent blocks at the current iterate."""
    from fem_tpu.ops import cohesive as coh_ops

    return coh_ops.element_stiffness(ecoords, props, u_total[edofs], dt,
                                     quirks)


def _sharded_blocks32(sharded_op):
    """f32 copies of a ShardedOperator's element blocks (cached on the
    operator; sharding is preserved by elementwise astype)."""
    cached = getattr(sharded_op, "_blocks32", None)
    if cached is None:
        from fem_tpu.ops import operator as op_mod

        cached = [
            op_mod.FusedBlock(
                edofs_t=b.edofs_t, conn_t=b.conn_t,
                dNx=b.dNx.astype(jnp.float32),
                scale=b.scale.astype(jnp.float32),
                lam=b.lam.astype(jnp.float32),
                mu=b.mu.astype(jnp.float32),
            )
            for b in sharded_op.blocks
        ]
        sharded_op._blocks32 = cached
    return cached


def _sharded_mv_pc(sharded_op):
    """Masked J matvec + AMG V-cycle over an element-SHARDED elastic
    operator (the distributed-SNES role, m_global.F90:161-235): smoother
    matvecs run sharded with psum shared-dof reduction; coarse ELL levels
    replicated. Closures are cached ON the ShardedOperator so the chunked
    program cache keys stay stable across Newton iterations/load steps."""
    cached = getattr(sharded_op, "_mf_fns", None)
    if cached is not None:
        return cached

    def smv(ops, v):
        keep, mf = ops["keep"], ops["mf"]
        vk = v * keep
        out = sharded_op.matvec(vk, blocks=ops["blocks"])
        edofs = ops["edofs"]
        fe = jnp.einsum("eab,eb->ea", ops["ke"], vk[edofs])
        out = out.at[edofs.reshape(-1)].add(fe.reshape(-1))
        return out * keep + v * mf

    def spc(ops, r):
        from fem_tpu.solver import amg as amg_mod

        return amg_mod.v_cycle(ops["hier"], lambda v: smv(ops, v), r)

    sharded_op._mf_fns = (smv, spc)
    return smv, spc


@functools.partial(
    jax.jit, static_argnames=("quirks", "reference_form")
)
def _mf_residual_jit(fop, ecoords, props, edofs, dt, F_ext, aggregate_u,
                     keep, mf, ubc, du, *, quirks: bool,
                     reference_form: bool):
    """Matrix-free Newton residual as ONE jitted program (the eager form
    costs dozens of dispatches per evaluation, and line searches evaluate
    it many times per load step)."""
    from fem_tpu.ops import operator as op_mod

    u_total = aggregate_u + du
    F = F_ext + _coh_force_arrays(ecoords, props, edofs, dt, u_total, quirks)
    R = op_mod.matvec(fop, du)
    if reference_form:
        from fem_tpu.ops import cohesive as coh_ops

        ke = coh_ops.element_stiffness(ecoords, props, u_total[edofs], dt,
                                       quirks)
        fe = jnp.einsum("eab,eb->ea", ke, du[edofs])
        R = R.at[edofs.reshape(-1)].add(fe.reshape(-1))
    R = R - F
    return R * keep + (du - ubc) * mf


@functools.partial(
    jax.jit, static_argnames=("quirks", "reference_form")
)
def _mf_trial_full_jit(fop, ecoords, props, edofs, dt, F_ext, aggregate_u,
                       keep, mf, ubc, du, delta, lam, *, quirks: bool,
                       reference_form: bool):
    """One line-search trial returning everything the Newton loop tail
    needs: the pinned trial iterate, its residual ARRAY, and one stacked
    (3,) stats vector [trial rnorm, step norm, trial norm].

    Replaces the former 4 blocking host pulls per accepted Newton
    iteration (trial norm, then a fresh residual dispatch + rnorm pull,
    step-norm pull, du-norm pull) with ONE."""
    trial = (du + lam * delta) * keep + ubc * mf
    R = _mf_residual_jit.__wrapped__(
        fop, ecoords, props, edofs, dt, F_ext, aggregate_u,
        keep, mf, ubc, trial, quirks=quirks, reference_form=reference_form,
    )
    step = trial - du
    stats = jnp.stack([
        jnp.sqrt(jnp.sum(R * R)),
        jnp.sqrt(jnp.sum(step * step)),
        jnp.sqrt(jnp.sum(trial * trial)),
    ])
    return trial, R, stats


@functools.partial(jax.jit, static_argnames=("quirks",))
def _mf_true_resid_jit(fop, ecoords, props, edofs, dt, aggregate_u,
                       keep, mf, du, rhs, delta, *, quirks: bool):
    """rhs - J' delta (and its norm) with the masked full Jacobian, one
    dispatch — the inner-direction accuracy check, and the residual the
    f32 refinement passes re-solve."""
    from fem_tpu.ops import cohesive as coh_ops
    from fem_tpu.ops import operator as op_mod

    vk = delta * keep
    out = op_mod.matvec(fop, vk)
    ke = coh_ops.element_stiffness(
        ecoords, props, (aggregate_u + du)[edofs], dt, quirks
    )
    fe = jnp.einsum("eab,eb->ea", ke, vk[edofs])
    out = out.at[edofs.reshape(-1)].add(fe.reshape(-1))
    r = rhs - (out * keep + delta * mf)
    return r, jnp.sqrt(jnp.sum(r * r))


def _matfree_amg_cache(system: System, need_sa: bool = False):
    """f32 fused operator + elastic SA-AMG hierarchy + eager float masks for
    the matrix-free Newton inner solves. Built ONCE per System and cached:
    K_el never changes across load steps, so rebuilding the hierarchy every
    step (tens of host seconds at 527k dofs) was pure waste (VERDICT r2
    weak #7; the reference instead refactorizes J with MUMPS every Newton
    iteration, main.F90:365-371).

    The cache is also seeded on the PROBLEM: the hierarchy depends only on
    the mesh/materials/BCs (K_el) plus dt (the zero-opening cohesive
    tangent's viscous term), so a second System over the same Problem —
    repeated runs, parameter sweeps over load amplitude, warm/steady bench
    pairs — reuses the hierarchy AND the already-device-resident arrays
    instead of repaying the full host setup + push."""
    cache = getattr(system, "_mf_amg32", None)
    if cache is not None and need_sa and "hier" not in cache:
        cache = None  # sharded caller needs the SA hierarchy: rebuild
    if cache is None:
        pkey = (float(system.dt), str(system.dtype))
        pc = getattr(system.problem, "_mf_amg32_pc", None)
        if (pc is not None and pc[0] == pkey
                and not (need_sa and "hier" not in pc[1])):
            cache, fop64 = pc[1], pc[2]
            system._mf_amg32 = cache
            if getattr(system, "_fused_op", None) is None:
                system._fused_op = fop64
            return cache
    if cache is None:
        from fem_tpu.ops import operator as op_mod
        from fem_tpu.solver import amg as amg_mod

        # ALL setup compute runs on the HOST (CPU backend) and the results
        # are device_put once: building the fused operator eagerly on the
        # device would compile every small set-up op. system.blocks hold
        # committed device arrays, so a host VIEW with CPU copies is built
        # first — jax.default_device alone cannot move committed operands.
        cpu = jax.devices("cpu")[0]
        target = None
        try:
            target = list(system.coords.devices())[0]
        except Exception:
            pass

        class _HostView:
            pass

        hv = _HostView()
        hv.dtype = system.dtype
        hv.ndof = system.ndof
        hv.nnds = system.nnds
        hv.pdim = system.pdim
        hv.problem = system.problem
        hv.blocks = {}
        for name, e in system.blocks.items():
            he = dict(e)
            for k in ("ecoords", "E", "nu", "props", "edofs", "conn"):
                if k in he and hasattr(he[k], "devices"):
                    he[k] = jax.device_put(np.asarray(he[k]), cpu)
            hv.blocks[name] = he

        with jax.default_device(cpu):
            fop64 = op_mod.build(hv)
            A_csr = amg_mod.assemble_csr(hv)
            # elastic-only snapshot for the lattice probe below: the
            # cohesive seam couplings added next join node ids that are
            # NOT lattice neighbors, which would defeat detection
            A_el = A_csr
            # Hierarchy on the TRUE initial tangent K_el + K_coh(0): the
            # zero-opening Xu-Needleman tangent is a huge penalty-like
            # interface stiffness, and an elastic-only preconditioner is
            # weakest exactly on the FIRST (hardest, rtol-1e-4) Newton
            # solve. The reference refactorizes the true tangent every
            # SNES iteration (MUMPS); one frozen true-initial-tangent
            # hierarchy is the cheap analogue.
            # DEFAULT coarse_max (deep hierarchy): coarse_max=20000 (the
            # elastic-bench 2-level aggressive tuning) collapsed it0's
            # inner CG on the 105k strip (far more iterations than any
            # other inner solve).
            e0 = hv.blocks.get("coh")
            if e0 is not None:
                from fem_tpu.ops import cohesive as coh_ops
                from scipy import sparse as _sp

                ue0 = jnp.zeros(
                    (e0["edofs"].shape[0], e0["edofs"].shape[1]),
                    dtype=jnp.float64)
                ke0 = np.asarray(coh_ops.element_stiffness(
                    e0["ecoords"], e0["props"], ue0, system.dt))
                ed = np.asarray(e0["edofs"])
                ne_, nde = ed.shape
                rows = np.repeat(ed, nde, axis=1).reshape(-1)
                cols = np.tile(ed, (1, nde)).reshape(-1)
                A_csr = (A_csr + _sp.coo_matrix(
                    (ke0.reshape(-1), (rows, cols)),
                    shape=A_csr.shape).tocsr())
            # Hierarchy choice (both on the true initial tangent):
            # lattice topology -> GEOMETRIC block multigrid (solver/gmg.py,
            # every level a gather-free stencil, measured 6 vs 9 inner CG
            # iterations AND ~10x cheaper V-cycle vs SA at 1M dofs);
            # general topology (or FEM_TPU_NO_GMG=1) -> SA-AMG. The SA
            # build (aggregation + RBM QR + smoothed RAP) is also the
            # dominant host-setup cost at scale, so it is SKIPPED when the
            # geometric hierarchy exists; sharded callers that still need
            # it pass need_sa=True.
            from fem_tpu.ops import blockstencil as bs_mod

            pdim = system.pdim
            dims = bs_mod.detect(A_el, pdim, system.ndof // pdim)
            hier_g32 = None
            if dims is not None and os.environ.get(
                    "FEM_TPU_NO_GMG", "0") != "1":
                from fem_tpu.solver import gmg as gmg_mod

                hier_g32 = gmg_mod.build_lattice(
                    A_csr, pdim, dims,
                    bc_dofs=np.asarray(system.bc_dofs),
                    dtype=jnp.float32)
            hier32 = None
            if hier_g32 is None or need_sa:
                hier32 = amg_mod.build(hv, np.asarray(system.bc_dofs),
                                       dtype=jnp.float32, A=A_csr)
            # The flat-state inner solve keeps the fused gather operator:
            # routing it through bs.matvec's FLAT wrapper adds two
            # in-program transposes per apply. The lattice tier
            # only wins with COMPONENT-MAJOR state end-to-end — built
            # below as the cm cache when the topology allows, and used by
            # inner_solve via _mf_jac_mv_cm.
            fop_i = fop64.astype(jnp.float32)
            bc_np = np.zeros(system.ndof, dtype=bool)
            bc_np[np.asarray(system.bc_dofs)] = True
            mf32 = jnp.asarray(bc_np, dtype=jnp.float32)
            e = hv.blocks["coh"]
            cache = dict(
                fop=fop_i,
                keep=1.0 - mf32,
                mf=mf32,
                edofs=e["edofs"],
                ecoords32=e["ecoords"].astype(jnp.float32),
                props32=e["props"].astype(jnp.float32),
            )
            if hier32 is not None:
                cache["hier"] = hier32
            if hier_g32 is not None:
                cache["hier_g"] = hier_g32
            if dims is not None:
                ed = np.asarray(e["edofs"])
                mf_cm32 = jnp.asarray(
                    bc_np.reshape(-1, pdim).T.astype(np.float32))
                cache.update(
                    fop_cm=bs_mod.build(A_el, pdim, dims,
                                        dtype=jnp.float32),
                    mf_cm=mf_cm32,
                    keep_cm=1.0 - mf_cm32,
                    ed_node=jnp.asarray((ed // pdim).astype(np.int32)),
                    ed_comp=jnp.asarray((ed % pdim).astype(np.int32)),
                )
            del A_csr
        if target is not None and target.platform != "cpu":
            cache = jax.device_put(cache, target)
            fop64 = jax.device_put(fop64, target)
        # the f64 residual/true-residual programs use the same operator —
        # seed the System cache so it is never rebuilt eagerly on device
        if getattr(system, "_fused_op", None) is None:
            system._fused_op = fop64
        system._mf_amg32 = cache
        try:
            system.problem._mf_amg32_pc = (pkey, cache, fop64)
        except (AttributeError, TypeError):
            pass  # frozen/slotted Problem variants: System-level cache only
    return cache


def solve_step_matfree(
    system: System,
    config: Config,
    aggregate_u,
    du0,
    F_ext,
    sharded_op=None,
    log=None,
):
    """Matrix-free Newton-Krylov for large cohesive problems.

    Same residual/Jacobian semantics as solve_step (eliminate BC mode), but
    J delta = -R is solved matrix-free with
    J v = K_el v + K_coh(u) v — no dense assembly, so it scales to meshes
    where the dense SNES path cannot. At scale (config.resolve_precond ->
    "amg") the inner solve is f32 chunked AMG-CG with the cached elastic
    hierarchy (see _matfree_amg_cache / _mf_jac_mv); below the AMG
    threshold it is Jacobi-PCG in the config dtype.

    Robustness past the Xu–Needleman traction peak, where the cohesive
    tangent goes INDEFINITE (the reference leans on MUMPS pivoting there,
    main.F90:365-371, and its commented-out alternative is literally
    gmres+asm, main.F90:392-394): if the CG inner solve stalls (indefinite
    systems break CG's minimization property) or its direction fails the
    line search, the step falls back to restarted GMRES (solver/gmres.py),
    which only needs J nonsingular.

    Inner tolerance uses Eisenstat–Walker forcing (choice 2:
    eta_k = 0.9 (||R_k||/||R_{k-1}||)^2, clipped to [1e-6, 0.5]) — loose
    early inner solves, tight near convergence — unless
    config.forcing == "fixed".
    """
    quirks = config.quirks
    reference_form = config.resolve_formulation("eliminate") == "reference"
    bc_dofs = system.bc_dofs
    bc_vals = system.bc_step_vals()
    n = system.ndof
    bc_mask = jnp.zeros(n, dtype=bool).at[bc_dofs].set(True)
    ubc = jnp.zeros(n, dtype=F_ext.dtype).at[bc_dofs].set(bc_vals)

    from fem_tpu.solver import cg as cg_mod


    # Inner preconditioner: Jacobi at deck scale; the ELASTIC smoothed-
    # aggregation AMG at scale (config.resolve_precond). The cohesive
    # tangent perturbs K_el only on the interface dofs, so the elastic
    # hierarchy — built ONCE per System, cached across load steps — stays
    # an effective preconditioner for J = K_el + K_coh throughout (the
    # reference's MUMPS refactorizes J every iteration instead). The AMG
    # inner solve runs in f32 through CHUNKED dispatches (cg.pcg_chunked):
    # a lax.while_loop around a V-cycle body was miscompile class #2
    # (DESIGN.md), and f32 moves half the bytes of f64. Inexact-Newton forcing tolerances (>=1e-6)
    # sit comfortably above f32 round-off, and the f64 outer residual /
    # line search makes Newton itself the iterative-refinement loop.
    amg_ops = None
    if config.resolve_precond(n) == "amg":
        amg_ops = _matfree_amg_cache(system,
                                     need_sa=sharded_op is not None)
    dt_arr = jnp.asarray(system.dt, dtype=jnp.float32)

    # `sharded_op` (a parallel.ShardedOperator) distributes the elastic
    # matvec over the device mesh — the reference's SNES on distributed
    # Mat/Vec with ghost scatter per iteration (m_global.F90:161-235,
    # 549-564). The cohesive interface block stays replicated (it is
    # O(surface), tiny next to the O(volume) bulk).
    if sharded_op is not None:
        el_mv = sharded_op.matvec
    else:
        el_mv = system.matvec_fused

    def jac_matvec(du, v):
        out = el_mv(v) + system.coh_matvec(
            aggregate_u + du, v, quirks
        )
        return out

    mf = bc_mask.astype(F_ext.dtype)
    keep = 1.0 - mf

    # Single-dispatch jitted residual/line-search on the replicated path:
    # the eager form costs dozens of dispatches per evaluation. The
    # sharded path keeps the eager composition (its matvec closures carry
    # the mesh).
    e_coh = system.blocks["coh"]
    dtc = jnp.asarray(system.dt, dtype=F_ext.dtype)
    use_jit_res = sharded_op is None
    fop = system.fused_operator() if use_jit_res else None

    def residual(du):
        # float-mask arithmetic: bool selects on matvec outputs (see
        # cg.masked_operator)
        if use_jit_res:
            return _mf_residual_jit(
                fop, e_coh["ecoords"], e_coh["props"], e_coh["edofs"], dtc,
                F_ext, aggregate_u, keep, mf, ubc, du,
                quirks=quirks, reference_form=reference_form,
            )
        F = F_ext + system.coh_force(aggregate_u + du, quirks)
        if reference_form:
            R = jac_matvec(du, du) - F
        else:
            R = el_mv(du) - F
        return R * keep + (du - ubc) * mf

    def pin(du):
        return du * keep + ubc * mf

    du = pin(du0)
    R = residual(du)
    r0 = float(jnp.linalg.norm(R))
    rnorm = r0
    tol = max(config.newton_rtol * r0, config.newton_atol)

    from fem_tpu.solver import gmres as gmres_mod

    def jacobi_diag(du):
        """Lazy: only the Jacobi-PCG path and the GMRES fallback need it."""
        diag = system.diag_fused() + _coh_diag(system, aggregate_u + du,
                                                quirks)
        diag = jnp.where(bc_mask, 1.0, diag)
        return jnp.where(jnp.abs(diag) < 1e-30, 1.0, diag)

    def inner_solve(du, R, inner_rtol):
        """CG first; GMRES(30) fallback on stall (indefinite tangent)."""
        mv = cg_mod.masked_operator(lambda v: jac_matvec(du, v), bc_mask)
        rhs = jnp.where(bc_mask, 0.0, -R)
        indefinite = False
        gate_rtol = inner_rtol
        if amg_ops is not None:
            # f32 chunked AMG-CG (one jitted dispatch per `chunk` complete
            # iterations) — the production shape, mirroring the
            # stepper's linear AMG branch.
            ops_src = amg_ops
            if sharded_op is not None:
                # The cache arrays were built host-side and are committed
                # to cpu:0 (_matfree_amg_cache); the element blocks are
                # sharded over the device mesh. One jit cannot mix a
                # committed single-device operand with a mesh-sharded one —
                # replicate the cache over the same mesh (once, cached on
                # the operator).
                ops_src = getattr(sharded_op, "_mf_cache_rep", None)
                if ops_src is None:
                    from jax.sharding import NamedSharding
                    from jax.sharding import PartitionSpec as _P

                    rep = NamedSharding(sharded_op.mesh, _P())
                    ops_src = {
                        k: jax.device_put(v, rep)
                        for k, v in amg_ops.items()
                        if k not in ("fop", "fop_cm", "mf_cm", "keep_cm",
                                     "ed_node", "ed_comp", "hier_g")
                    }
                    sharded_op._mf_cache_rep = ops_src
            ke32 = _coh_ke(
                ops_src["ecoords32"], ops_src["props32"], ops_src["edofs"],
                dt_arr, (aggregate_u + du).astype(jnp.float32),
                quirks=quirks,
            )
            ops = dict(ops_src, ke=ke32)
            ops.pop("ecoords32")
            ops.pop("props32")
            use_cm = sharded_op is None and "fop_cm" in ops
            if sharded_op is not None:
                ops.pop("fop", None)
                ops.pop("hier_g", None)
                ops["blocks"] = _sharded_blocks32(sharded_op)
                mv_fn, pc_fn = _sharded_mv_pc(sharded_op)
            elif use_cm:
                # lattice tier: component-major state end-to-end through
                # the chunked CG (gather-free elastic block stencil); one
                # eager transpose per solve at the boundary. Preconditioner:
                # geometric lattice MG when the hierarchy exists (gather-
                # free at EVERY level — ~10x cheaper V-cycle and fewer
                # iterations than SA at 1M dofs), else the SA V-cycle.
                ops.pop("fop", None)
                if "hier_g" in ops:
                    ops.pop("hier", None)
                    mv_fn, pc_fn = _mf_jac_mv_cm, _mf_gmg_pc_cm
                else:
                    mv_fn, pc_fn = _mf_jac_mv_cm, _mf_amg_pc_cm
            else:
                for k in ("fop_cm", "mf_cm", "keep_cm", "ed_node",
                          "ed_comp", "hier_g"):
                    ops.pop(k, None)
                mv_fn, pc_fn = _mf_jac_mv, _mf_amg_pc
            # Clamp the Eisenstat–Walker tolerance to what the f32 inner
            # solve can actually deliver (recurrence drift floors the true
            # relative residual around ~1e-5 at 1e5 dofs; chasing 1e-6
            # spins CG to maxiter and then trips the GMRES fallback for
            # nothing).
            # Inexact Newton with eta ~ 3e-5 still converges superlinearly;
            # the f64 outer residual keeps the final accuracy.
            inner_eff = max(inner_rtol, 3e-5)
            gate_rtol = inner_eff
            nnds_cm = n // system.pdim
            # Size-adaptive chunk: per-iteration compute (matvec + V-cycle)
            # scales ~linearly with ndof, while the per-chunk convergence
            # pull is a fixed host round trip. Small systems take bigger
            # chunks to amortize it; large ones take small chunks, since
            # larger chunks only add overshoot (convergence quantizes to
            # chunk multiples). The 256k-dof switch is not yet measured on
            # a GPU (ROADMAP).
            inner_chunk = 6 if n < 256_000 else 2

            def _solve32(rflat, cap, bn=None):
                """One f32 chunked AMG-CG solve of J delta = rflat, flat
                in/out; cm conversions at the boundary on the lattice
                tier. `bn` = ||rflat|| when the caller already pulled it
                (saves the blocking bnorm pull inside pcg_chunked)."""
                if use_cm:
                    rcm = rflat.astype(jnp.float32).reshape(
                        nnds_cm, system.pdim).T
                    res_ = cg_mod.pcg_chunked(
                        mv_fn, rcm, pc_fn, ops,
                        rtol=inner_eff, maxiter=cap, chunk=inner_chunk,
                        pipeline=True, bnorm=bn)
                    return res_.x.T.reshape(-1), res_
                res_ = cg_mod.pcg_chunked(
                    mv_fn, rflat.astype(jnp.float32), pc_fn, ops,
                    rtol=inner_eff, maxiter=cap, chunk=inner_chunk,
                    pipeline=True, bnorm=bn)
                return res_.x, res_

            rhs_norm = float(jnp.linalg.norm(rhs))
            x32, res = _solve32(rhs, 200, bn=rhs_norm)
            delta = x32.astype(rhs.dtype)
            inner_iters = int(res.iters)
        else:
            res = cg_mod.pcg(
                mv, rhs, diag=jnp.abs(jacobi_diag(du)),
                rtol=inner_rtol, maxiter=max(200, int(jnp.sqrt(n)) * 4),
            )
            indefinite = bool(res.indefinite)
            delta = res.x
            inner_iters = int(res.iters)
            rhs_norm = float(jnp.linalg.norm(rhs))
        delta = jnp.where(bc_mask, 0.0, delta)
        # Trust nothing CG claims on an indefinite system: check negative
        # curvature AND the TRUE residual of the direction (one matvec) —
        # the recurrence residual can look converged while x is garbage.

        def true_resid(delta):
            if use_jit_res:
                r2, tr = _mf_true_resid_jit(
                    fop, e_coh["ecoords"], e_coh["props"], e_coh["edofs"],
                    dtc, aggregate_u, keep, mf, du, rhs, delta,
                    quirks=quirks,
                )
                return r2, float(tr)
            r2 = rhs - mv(delta)
            return r2, float(jnp.linalg.norm(r2))

        r2, true_res = true_resid(delta)
        rel = true_res / max(rhs_norm, 1e-300)
        # f64/f32 ITERATIVE REFINEMENT on the inner direction: when the f32
        # solve's true accuracy misses a tight forcing tolerance (its
        # relative floor worsens near the softening instability), re-solving
        # the f64 true residual in f32 costs ~one more short chunked solve,
        # far less than the f64 GMRES fallback this used to trigger. GMRES
        # remains the genuine-indefiniteness rescue below.
        if amg_ops is not None:
            for _ in range(2):
                if not np.isfinite(rel) or rel <= 10.0 * gate_rtol:
                    break
                corr32, corr_res = _solve32(r2, 100, bn=true_res)
                inner_iters += int(corr_res.iters)
                delta = jnp.where(bc_mask, 0.0,
                                  delta + corr32.astype(rhs.dtype))
                r2, true_res = true_resid(delta)
                rel = true_res / max(rhs_norm, 1e-300)
        used_gmres = False
        allow_gmres = getattr(config, "inner_krylov", "auto") != "cg"
        if allow_gmres and (
            not np.isfinite(rel)
            or rel > 10.0 * gate_rtol
            or indefinite
        ):
            minv = 1.0 / jnp.abs(jacobi_diag(du))
            gres = gmres_mod.gmres(
                mv, rhs, precond=lambda v: minv * v,
                rtol=inner_rtol, restart=30,
                maxiter=max(200, int(jnp.sqrt(n)) * 4),
            )
            grel = float(gres.resnorm) / max(rhs_norm, 1e-300)
            if np.isfinite(grel) and grel < rel:
                delta = jnp.where(bc_mask, 0.0, gres.x)
                used_gmres = True
                inner_iters += int(gres.iters)
        return delta, used_gmres, inner_iters

    def line_search(du, delta, rnorm):
        """Backtracking search; returns the full accepted-trial bundle
        (lam, rnorm, trial du, trial residual array, step/du norms) so the
        loop tail never re-dispatches the residual or re-pulls norms."""
        lam = 1.0
        best, best_r = None, rnorm
        for _ in range(20):
            if use_jit_res:
                trial, R_t, stats = _mf_trial_full_jit(
                    fop, e_coh["ecoords"], e_coh["props"], e_coh["edofs"],
                    dtc, F_ext, aggregate_u, keep, mf, ubc, du, delta,
                    jnp.asarray(lam, dtype=F_ext.dtype),
                    quirks=quirks, reference_form=reference_form,
                )
                stats = np.asarray(stats)  # ONE blocking pull per trial
                r_trial = float(stats[0])
                step_n, du_n = float(stats[1]), float(stats[2])
            else:
                trial = pin(du + lam * delta)
                R_t = residual(trial)
                r_trial = float(jnp.linalg.norm(R_t))
                step_n = du_n = None
            if np.isfinite(r_trial) and r_trial < best_r:
                best = (lam, r_trial, trial, R_t, step_n, du_n)
                best_r = r_trial
                if r_trial <= (1.0 - 1e-4 * lam) * rnorm:
                    break
            lam *= 0.5
        return best

    ew = getattr(config, "forcing", "ew") == "ew"
    log = log or (lambda m: None)
    log(f"newton: r0={r0:.3e} tol={tol:.3e}")
    prev_rnorm = None
    iters = 0
    fallbacks = 0
    inner_total = 0
    # wall decomposition (host perf_counter; every phase below ends on a
    # host float pull, so the boundaries are real device syncs): where a
    # cohesive solve's wall goes — inner Krylov vs line search vs f64
    # outer residuals
    import time as _time

    tw = {"inner": 0.0, "linesearch": 0.0, "residual": 0.0}
    converged = rnorm <= tol
    while not converged and iters < config.newton_maxit:
        if ew and prev_rnorm is not None and prev_rnorm > 0.0:
            inner_rtol = min(0.5, max(1e-6, 0.9 * (rnorm / prev_rnorm) ** 2))
        else:
            inner_rtol = 1e-4 if ew else 1e-6
        _t0 = _time.perf_counter()
        delta, used_gmres, n_inner = inner_solve(du, R, inner_rtol)
        tw["inner"] += _time.perf_counter() - _t0
        inner_total += n_inner
        log(f"newton it {iters}: inner done (rtol {inner_rtol:.1e}, "
            f"cg_iters={n_inner}, gmres={used_gmres})")
        _t0 = _time.perf_counter()
        best = line_search(du, delta, rnorm)
        tw["linesearch"] += _time.perf_counter() - _t0
        if (
            best is None
            and not used_gmres
            and getattr(config, "inner_krylov", "auto") != "cg"
        ):
            # CG direction useless (indefinite tangent past the traction
            # peak): retry with a tight GMRES direction before stagnating.
            mv = cg_mod.masked_operator(lambda v: jac_matvec(du, v), bc_mask)
            minv = 1.0 / jnp.abs(jacobi_diag(du))
            gres = gmres_mod.gmres(
                mv, jnp.where(bc_mask, 0.0, -R),
                precond=lambda v: minv * v, rtol=1e-8, restart=30,
                maxiter=max(200, int(jnp.sqrt(n)) * 4),
            )
            delta = jnp.where(bc_mask, 0.0, gres.x)
            used_gmres = True
            best = line_search(du, delta, rnorm)
        if best is None:
            break
        if used_gmres:
            fallbacks += 1
        best_lam, r_new, du_new, R_new, step_norm, du_norm = best
        _t0 = _time.perf_counter()
        if step_norm is None:
            # eager (sharded) tier: norms were not fused into the trial
            step_norm = float(jnp.linalg.norm(du_new - du))
            du_norm = float(jnp.linalg.norm(du_new))
        du = du_new
        iters += 1
        # the accepted trial's residual IS the new Newton residual — reuse
        # the array and its already-pulled norm instead of re-dispatching
        R = R_new
        prev_rnorm = rnorm
        rnorm = r_new
        tw["residual"] += _time.perf_counter() - _t0
        log(f"newton it {iters}: rnorm={rnorm:.3e} lam={best_lam}")
        if rnorm <= tol:
            converged = True
            break
        if step_norm <= config.newton_stol * max(du_norm, 1e-300):
            converged = True
            break

    log("newton wall: inner %.2fs, linesearch %.2fs, residual %.2fs"
        % (tw["inner"], tw["linesearch"], tw["residual"]))
    return NewtonResult(du=du, iters=iters, resnorm=rnorm, converged=converged,
                        gmres_fallbacks=fallbacks, inner_iters=inner_total)


def _coh_diag(system: System, u_total, quirks: bool):
    """Diagonal of the cohesive tangent contribution (for Jacobi)."""
    from fem_tpu.ops import cohesive as coh_ops

    e = system.blocks["coh"]
    ue = u_total[e["edofs"]]
    ke = coh_ops.element_stiffness(e["ecoords"], e["props"], ue, system.dt, quirks)
    d = jnp.diagonal(ke, axis1=1, axis2=2)
    out = jnp.zeros(system.ndof, dtype=u_total.dtype)
    return out.at[e["edofs"].reshape(-1)].add(d.reshape(-1))


def _robust_solve(J, rhs, ref=None):
    """Dense solve with null-pivot regularization.

    The reference relies on MUMPS null-pivot detection (icntl(24)=1 with
    cntl(3)=1e-6, main.F90:365-371) so that fully-separated cohesive
    interfaces — which leave dofs with ~zero stiffness — still factorize.
    Equivalent here: dofs whose Jacobian row is numerically null are pinned
    (unit diagonal, zero rhs), i.e. they receive no Newton correction; if the
    solve still fails, fall back to a least-squares solution.

    `ref` is the PHYSICAL stiffness scale (max |K_el|). Callers with penalty
    BCs must pass it: the 1e30 penalty diagonal otherwise dominates
    max(row_scale) and flags every physical row as null (MUMPS equilibrates
    before detecting null pivots, so its scale is never penalty-poisoned).
    """
    row_scale = jnp.max(jnp.abs(J), axis=1)
    if ref is None:
        ref = jnp.max(row_scale)
    null = row_scale <= 1e-12 * ref
    if bool(jnp.any(null)):
        Jr = jnp.where(null[:, None] | null[None, :], 0.0, J)
        dofs = jnp.nonzero(null)[0]
        Jr = Jr.at[dofs, dofs].set(1.0)
        rhs = jnp.where(null, 0.0, rhs)
        J = Jr
    x = direct.solve(J, rhs)
    if not bool(jnp.all(jnp.isfinite(x))):
        x = jnp.linalg.lstsq(J, rhs, rcond=None)[0]
    return x
