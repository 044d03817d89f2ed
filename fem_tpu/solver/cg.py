"""Matrix-free preconditioned conjugate gradient inside jit.

Replaces the MUMPS direct factorization (main.F90:354-390) for large SPD
elastic systems: the assembled elastic K is symmetric positive definite once
constrained dofs are eliminated, so Jacobi-preconditioned CG with the
matrix-free gather/batched-k_e/scatter operator (System.matvec) is the
accelerator solve. Everything is a lax.while_loop — one compiled kernel,
no host round-trips per iteration.

BC handling uses the elimination form (fem_tpu/solver/direct.eliminate_bcs
semantics, expressed operator-side): the operator maps constrained dofs
through the identity and masks their coupling, keeping the system SPD and
well-conditioned (the 1e30 penalty would destroy CG convergence —
SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class CGResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    resnorm: jnp.ndarray
    # True when a non-positive curvature p^T A p was encountered — the
    # operator is indefinite and CG's minimization property (and its
    # recurrence residual) are void. Callers should fall back to GMRES
    # (newton.solve_step_matfree does). Only pcg() sets this. (Plain bool
    # default: a jnp default would initialize the backend at import time.)
    indefinite: bool = False


def masked_operator(matvec: Callable, bc_mask):
    """Wrap an SPD operator so constrained dofs (bc_mask True) act as
    identity rows/cols: A' = P A P + (I - P), with P the free-dof projector.

    Implemented with FLOAT mask arithmetic, not jnp.where: a bool select
    applied to the output of the stencil/fused matvec miscompiled on an
    earlier accelerator backend at ~1M-dof sizes (miscompile #1,
    DESIGN.md); multiplying by exact 0.0/1.0 masks is mathematically
    identical and lowers correctly everywhere.
    """

    # Pre-cast float masks EAGERLY for both precisions: in-jit bool->float
    # casts themselves miscompiled at large sizes on that backend.
    mf_by_dtype = {
        jnp.dtype(jnp.float32): jnp.asarray(bc_mask, dtype=jnp.float32),
        jnp.dtype(jnp.float64): jnp.asarray(bc_mask, dtype=jnp.float64),
    }

    def op(v):
        mf = mf_by_dtype.get(jnp.dtype(v.dtype))
        if mf is None:
            mf = bc_mask.astype(v.dtype)
        keep = 1.0 - mf
        return matvec(v * keep) * keep + v * mf

    return op


def constrained_rhs(matvec: Callable, F, bc_mask, ubc):
    """RHS for the masked operator: b = P(F - A ubc) + ubc on constrained.
    Float-mask arithmetic for the same reason as masked_operator."""
    mf = jnp.asarray(bc_mask, dtype=F.dtype)  # eager when called outside jit
    return (F - matvec(ubc)) * (1.0 - mf) + ubc * mf


def pcg(
    matvec: Callable,
    b,
    x0=None,
    diag=None,
    rtol: float = 1e-9,
    atol: float = 0.0,
    maxiter: int = 0,
    precond: Callable = None,
) -> CGResult:
    """Preconditioned CG as a lax.while_loop.

    Preconditioner: `precond(r)` if given (e.g. a multigrid V-cycle), else
    Jacobi from `diag`, else identity. Convergence:
    ||r|| <= max(rtol * ||b||, atol) (PETSc KSP default test with the
    reference's rtol=1e-9, main.F90:349-351).
    """
    n = b.shape[0]
    if maxiter <= 0:
        maxiter = 10 * n
    x0 = jnp.zeros_like(b) if x0 is None else x0
    if precond is None:
        minv_d = 1.0 / diag if diag is not None else jnp.ones_like(b)
        precond = lambda r: minv_d * r  # noqa: E731

    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = b - matvec(x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)

    def cond(state):
        x, r, p, rz, k, indef = state
        return jnp.logical_and(jnp.linalg.norm(r) > tol, k < maxiter)

    def body(state):
        x, r, p, rz, k, indef = state
        ap = matvec(p)
        pap = jnp.vdot(p, ap)
        indef = jnp.logical_or(indef, pap <= 0.0)
        alpha = rz / pap
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, p, rz_new, k + 1, indef)

    x, r, p, rz, k, indef = jax.lax.while_loop(
        cond, body, (x0, r0, p0, rz0, 0, jnp.asarray(False))
    )
    return CGResult(x=x, iters=k, resnorm=jnp.linalg.norm(r), indefinite=indef)


def pcg_host_split(matvec, b, precond_host, operands, rtol: float = 1e-9,
                   atol: float = 0.0, maxiter: int = 200) -> CGResult:
    """pcg_host variant whose preconditioner runs OUTSIDE jit — for
    host-driven preconditioners like multigrid.v_cycle_host (each level its
    own small program; avoids one giant fused V-cycle compile). matvec(operands, v) is jitted; precond_host(operands,
    r) is called as plain Python."""

    @jax.jit
    def advance(operands, x, r, p, rz):
        ap = matvec(operands, p)
        alpha = rz / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        return x, r, jnp.linalg.norm(r)

    @jax.jit
    def direction(z, r, p, rz):
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return p, rz_new

    bnorm = float(jnp.linalg.norm(b))
    tol = max(rtol * bnorm, atol)
    x = jnp.zeros_like(b)
    r = b
    z = precond_host(operands, r)
    p = z
    rz = jnp.vdot(r, z)
    rnorm = bnorm
    k = 0
    while rnorm > tol and k < maxiter:
        x, r, rn = advance(operands, x, r, p, rz)
        rnorm = float(rn)
        k += 1
        if rnorm <= tol:
            break
        z = precond_host(operands, r)
        p, rz = direction(z, r, p, rz)
    return CGResult(x=x, iters=jnp.asarray(k), resnorm=jnp.asarray(rnorm))


_CHUNK_PROGRAMS = {}
_CHUNK_PROGRAMS_MAX = 32


def _chunk_programs(matvec, precond, chunk):
    """Build (or fetch) the jitted first/advance programs for pcg_chunked.
    Keyed on the function objects + chunk so the expensive trace+compile
    happens once per operator pair, not once per solve. Production callers
    pass MODULE-LEVEL functions (stable identity -> cross-run reuse);
    per-run closures still work but re-trace. The cache is bounded with
    LRU eviction (a hit refreshes the key) so closure-keyed entries cannot
    pin compiled executables and their closed-over hierarchies forever
    (ADVICE r2), while hot module-level programs survive accumulated
    per-run closure keys."""
    key = (matvec, precond, chunk)
    cached = _CHUNK_PROGRAMS.get(key)
    if cached is not None:
        _CHUNK_PROGRAMS[key] = _CHUNK_PROGRAMS.pop(key)  # LRU refresh
        return cached
    while len(_CHUNK_PROGRAMS) >= _CHUNK_PROGRAMS_MAX:
        _CHUNK_PROGRAMS.pop(next(iter(_CHUNK_PROGRAMS)))

    def _dot(a, c):
        return jnp.sum(a * c)

    @jax.jit
    def first(operands, b):
        r = b
        z = precond(operands, r)
        return r, z, _dot(r, z)

    @jax.jit
    def resid(operands, b, x0):
        r = b - matvec(operands, x0)
        return r, jnp.sqrt(_dot(r, r))

    def one(operands, state):
        # Breakdown-safe unrolled iteration: when the solve converges
        # MID-CHUNK, r ~ 0 makes rz/pAp underflow to 0/0 = NaN and the
        # remaining unrolled iterations poison the state (observed: a
        # prescribed-displacement deck converging in 2 iterations under
        # chunk=4 returned all-NaN). Guarded alpha/beta turn post-
        # convergence iterations into no-ops (alpha=beta=0 freezes x,r).
        # The guards are SCALAR selects on dot results — not the vector
        # bool-where-on-matvec-output miscompile class (#1, DESIGN.md).
        x, r, p, rz = state
        ap = matvec(operands, p)
        pap = _dot(p, ap)
        eps = jnp.asarray(jnp.finfo(rz.dtype).tiny, rz.dtype)
        ok_a = pap > eps
        alpha = jnp.where(ok_a, rz / jnp.where(ok_a, pap, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(operands, r)
        rz_new = _dot(r, z)
        ok_b = rz > eps
        beta = jnp.where(ok_b, rz_new / jnp.where(ok_b, rz, 1.0), 0.0)
        p = z + beta * p
        return (x, r, p, rz_new)

    @jax.jit
    def advance(operands, x, r, p, rz):
        state = (x, r, p, rz)
        for _ in range(chunk):
            state = one(operands, state)
        x, r, p, rz = state
        return x, r, p, rz, jnp.sqrt(_dot(r, r))

    _CHUNK_PROGRAMS[key] = (first, advance, resid)
    return first, advance, resid


def pcg_chunked(matvec, b, precond, operands, rtol: float = 1e-9,
                atol: float = 0.0, maxiter: int = 400,
                chunk: int = 5, x0=None,
                pipeline: bool = False, bnorm: float | None = None) -> CGResult:
    """PCG with `chunk` iterations UNROLLED inside one jitted dispatch.

    The production large-solve shape: lax while/fori loops whose body
    contains a V-cycle lost carried state on an earlier accelerator
    backend (miscompile #2, DESIGN.md), and fully host-driven CG
    (pcg_host_split) pays ~25 dispatches + a host sync per iteration. This
    fuses `chunk` complete PCG iterations (matvec + V-cycle + vector
    updates) into ONE program and syncs the residual norm once per chunk.
    The costs are up to chunk-1 extra iterations past convergence and a
    one-time trace+compile that grows with chunk (amortized by the
    per-(matvec,precond,chunk) program cache below plus the persistent
    compilation cache).

    matvec(operands, v) and precond(operands, r) must be jit-traceable.
    Pass the SAME function objects across calls — the traced/compiled chunk
    program is cached per (matvec, precond, chunk), so repeated solves (the
    iterative-refinement outer loop) skip the minutes-long retrace.

    Shape-agnostic: b (and the operators) may be GRID-shaped — e.g.
    (*node_shape, pdim) for the stencil/multigrid path. All reductions are
    sum-based (no ravels), so no flat elementwise op ever fuses onto a
    matvec output (miscompile #5, see structured.matvec_g).

    With `x0`, CG solves for the CORRECTION against x0's residual (one extra
    jitted matvec) — the warm-start form for multi-step linear decks; the
    convergence test still targets rtol * ||b|| (the PETSc KSP default),
    not the smaller correction norm.

    With `pipeline=True`, chunk k+1 is speculatively dispatched before
    chunk k's residual norm is pulled to the host, hiding the host
    round-trip latency behind device execution (at most one wasted chunk
    at convergence; see the pipeline branch below).
    """
    first, advance, resid = _chunk_programs(matvec, precond, chunk)

    # callers that already pulled ||b|| to the host (e.g. an iterative-
    # refinement outer loop whose true-residual program returns the norm)
    # pass it in — each avoided blocking pull is one host round trip
    if bnorm is None:
        bnorm = float(jnp.sqrt(jnp.sum(b * b)))
    tol = max(rtol * bnorm, atol)
    rnorm = bnorm
    if x0 is not None:
        b, rn0 = resid(operands, b, x0)
        rnorm = float(rn0)
        if rnorm <= tol:
            return CGResult(x=x0, iters=jnp.asarray(0),
                            resnorm=jnp.asarray(rnorm))
    x = jnp.zeros_like(b)
    r, z, rz = first(operands, b)
    p = z
    k = 0
    if pipeline and rnorm > tol and maxiter > 0:
        # Speculative 1-deep pipeline: dispatch chunk k+1 on chunk k's
        # (still in-flight) outputs BEFORE blocking on chunk k's residual
        # norm, so the host pull latency overlaps chunk k+1's execution.
        # Costs at most one discarded chunk of device work at convergence.
        nxt = advance(operands, x, r, p, rz)
        k = chunk
        while True:
            spec = (advance(operands, nxt[0], nxt[1], nxt[2], nxt[3])
                    if k < maxiter else None)
            rnorm = float(nxt[4])
            if rnorm <= tol or spec is None:
                x, r, p, rz = nxt[0], nxt[1], nxt[2], nxt[3]
                break
            nxt = spec
            k += chunk
    else:
        while rnorm > tol and k < maxiter:
            x, r, p, rz, rn = advance(operands, x, r, p, rz)
            rnorm = float(rn)
            k += chunk
    if x0 is not None:
        x = x0 + x
    return CGResult(x=x, iters=jnp.asarray(k), resnorm=jnp.asarray(rnorm))


def ir_pcg_chunked(true_resid, combine, matvec, precond, operands, x,
                   rtol: float = 1e-9, maxcycles: int = 8,
                   maxiter: int = 120, chunk: int = 4,
                   adapt: bool = True):
    """f64/f32 iterative refinement with SPECULATION ACROSS the cycle
    boundary: without it, each cycle pays a blocking true-residual pull
    plus the pipeline drain at its end.

    Per cycle, the f64 true-residual program, the preconditioned first CG
    step, and the FIRST chunk are all dispatched back-to-back BEFORE the
    residual norm is pulled, so the blocking pull overlaps chunk
    execution instead of serializing with it.
    The inner loop then runs pcg_chunked's speculative 1-deep pipeline.
    Cost: up to first+chunk dispatched wastefully at final convergence —
    once per solve, against one blocking pull saved per cycle.

    Interface (all device-side, shape-agnostic):
      true_resid(x) -> (r32, rn_dev): f64 residual of the CURRENT iterate,
        cast to the inner dtype, plus its f64 norm (computed in-program so
        the norm rides the same dispatch).
      combine(x, dx32) -> x: apply the f32 correction in f64 (masked/BC
        semantics live here).
      matvec/precond(operands, v): the f32 chunk programs (same contract
        and program cache as pcg_chunked).

    Returns (x, inner_total, rel_residual_estimate) where the estimate is
    rn/r0 from the LAST true-residual pull (callers wanting a final
    verified residual run true_resid once more)."""
    import numpy as np

    first, advance, _ = _chunk_programs(matvec, precond, chunk)
    inner_total = 0
    r0n = None
    rn = 0.0
    for _cyc in range(maxcycles):
        r32, rn_dev = true_resid(x)
        # speculative: preconditioned first step + chunk 1 queue behind
        # the true-residual program; the rn pull below overlaps them
        r, z, rz = first(operands, r32)
        nxt = advance(operands, jnp.zeros_like(r32), r, z, rz)
        rn = float(rn_dev)
        if r0n is None:
            r0n = max(rn, 1e-300)
        if rn <= rtol * r0n or not np.isfinite(rn):
            break  # first+chunk dispatched wastefully — once per solve
        if adapt:
            # ask only for the remaining reduction (x0.5 safety), floored
            # at 1e-5 (f32 CG's reliable single-cycle reach)
            cyc_rtol = float(np.clip(0.5 * rtol * r0n / rn, 1e-5, 0.5))
        else:
            cyc_rtol = 1e-5
        tol_c = cyc_rtol * rn
        k = chunk
        while True:
            spec = (advance(operands, nxt[0], nxt[1], nxt[2], nxt[3])
                    if k < maxiter else None)
            rnorm = float(nxt[4])
            if rnorm <= tol_c or spec is None:
                xc = nxt[0]
                break
            nxt = spec
            k += chunk
        inner_total += k
        x = combine(x, xc)
    return x, inner_total, (rn / r0n if r0n else 0.0)


def pcg_host(matvec, b, precond, operands, rtol: float = 1e-9,
             atol: float = 0.0, maxiter: int = 200) -> CGResult:
    """Host-driven PCG: one jitted CG iteration per dispatch.

    Exists because lax loops whose body contains a deep program (e.g. a
    multigrid V-cycle) lost their carried-state updates on an earlier
    accelerator backend (miscompile #2, DESIGN.md). The per-dispatch
    overhead is far below a V-cycle's cost, so this is also a good
    production shape. `operands` is a pytree passed through jit;
    matvec(operands, v) / precond(operands, r).
    """
    import functools

    @functools.partial(jax.jit, donate_argnums=())
    def first(operands, b):
        r = b - 0.0 * b  # x0 = 0
        z = precond(operands, r)
        return r, z, jnp.vdot(r, z)

    @jax.jit
    def step(operands, x, r, p, rz):
        ap = matvec(operands, p)
        alpha = rz / jnp.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(operands, r)
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new, jnp.linalg.norm(r)

    bnorm = float(jnp.linalg.norm(b))
    tol = max(rtol * bnorm, atol)
    x = jnp.zeros_like(b)
    r, z, rz = first(operands, b)
    p = z
    rnorm = bnorm
    k = 0
    while rnorm > tol and k < maxiter:
        x, r, p, rz, rn = step(operands, x, r, p, rz)
        rnorm = float(rn)
        k += 1
    return CGResult(x=x, iters=jnp.asarray(k), resnorm=jnp.asarray(rnorm))


def solve_eliminated(matvec, F, diag, bc_dofs, bc_step_vals, x0=None,
                     rtol=1e-9, atol=0.0, maxiter=0) -> CGResult:
    """One elastic solve with eliminated BCs, fully matrix-free."""
    n = F.shape[0]
    bc_mask = jnp.zeros(n, dtype=bool).at[bc_dofs].set(True)
    ubc = jnp.zeros(n, dtype=F.dtype).at[bc_dofs].set(bc_step_vals)
    op = masked_operator(matvec, bc_mask)
    b = constrained_rhs(matvec, F, bc_mask, ubc)
    d = jnp.where(bc_mask, 1.0, diag)
    if x0 is not None:
        x0 = jnp.where(bc_mask, ubc, x0)
    return pcg(op, b, x0=x0, diag=d, rtol=rtol, atol=atol, maxiter=maxiter)
