"""Mixed-precision iterative refinement: f64 accuracy at f32 speed.

f32 arithmetic moves half the bytes of f64 and runs at a higher rate. A plain
f32 CG stagnates around 1e-6 relative residual, short of the
reference's 1e-9 KSP tolerance (main.F90:349-351). The classical fix is
iterative refinement:

  outer (f64): r_k = b - A x_k          one f64 matvec per cycle
  inner (f32): solve A d = r_k approximately (Jacobi-PCG, ~1e-4 reduction)
  update:      x_{k+1} = x_k + d

Each cycle multiplies the true residual by the inner reduction factor, so
~3-4 cycles reach 1e-9 while >95% of the work runs in f32. This replaces
MUMPS's double-precision factorization for large systems.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fem_tpu.ops import operator as op_mod
from fem_tpu.solver import cg


class IRResult(NamedTuple):
    x: jnp.ndarray  # float64 solution
    outer_iters: jnp.ndarray
    inner_iters: jnp.ndarray  # total f32 CG iterations
    resnorm: jnp.ndarray  # true f64 residual norm


def ir_solve(
    op64,
    op32,
    F,
    diag32,
    bc_dofs,
    bc_vals,
    rtol: float = 1e-9,
    atol: float = 0.0,
    inner_rtol: float = 1e-4,
    inner_maxiter: int = 2000,
    outer_maxiter: int = 40,
    apply=op_mod.matvec,
    precond32=None,
) -> IRResult:
    """Solve K x = F with eliminated Dirichlet BCs to f64 accuracy.

    op64/op32: the same operator in both precisions (FusedOperator.astype or
    any pytree accepted by `apply`). `apply(op, v)` is the raw K @ v — pass
    ops.structured.matvec for the stencil operator. F: f64 load vector.
    diag32: f32 Jacobi diagonal (bc rows arbitrary). precond32: optional
    f32 preconditioner callable (e.g. a multigrid V-cycle) overriding Jacobi.

    NOTE: the production solvers use the chunked refinement loop
    (cg.ir_pcg_chunked, stepper._ir_outer) with eagerly pre-cast float
    masks instead — see DESIGN.md for the miscompile catalogue those
    shapes avoid.
    """
    n = op64.ndof
    bc_mask = jnp.zeros(n, dtype=bool).at[bc_dofs].set(True)
    ubc = jnp.zeros(n, dtype=F.dtype).at[bc_dofs].set(bc_vals)

    A64 = cg.masked_operator(lambda v: apply(op64, v), bc_mask)
    b = cg.constrained_rhs(lambda v: apply(op64, v), F, bc_mask, ubc)

    A32 = cg.masked_operator(lambda v: apply(op32, v), bc_mask)
    d32 = jnp.where(bc_mask, 1.0, diag32).astype(jnp.float32)

    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    def outer_cond(state):
        x, r, k, inner_total = state
        return jnp.logical_and(jnp.linalg.norm(r) > tol, k < outer_maxiter)

    def outer_body(state):
        x, r, k, inner_total = state
        res = cg.pcg(
            A32,
            r.astype(jnp.float32),
            diag=d32,
            rtol=inner_rtol,
            maxiter=inner_maxiter,
            precond=precond32,
        )
        x = x + res.x.astype(x.dtype)
        # pinned dofs must stay exact (the correction is ~0 there by
        # construction of the masked operator, but enforce against drift);
        # float-mask arithmetic (see cg.masked_operator)
        mf = bc_mask.astype(x.dtype)
        x = x * (1.0 - mf) + ubc * mf
        r = b - A64(x)
        return (x, r, k + 1, inner_total + res.iters)

    x0 = ubc
    r0 = b - A64(x0)
    x, r, k, inner_total = jax.lax.while_loop(
        outer_cond, outer_body, (x0, r0, 0, 0)
    )
    return IRResult(
        x=x, outer_iters=k, inner_iters=inner_total,
        resnorm=jnp.linalg.norm(r),
    )
