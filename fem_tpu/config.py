"""Run configuration for fem_tpu solves.

Mirrors the reference's two config layers (SURVEY.md §5): the .inp deck header
(`stype pdim nodal_bw` / counts / `t dt`, m_io.F90:16-18) carries the problem
definition, while this Config carries solver/runtime knobs that the reference
exposed through PETSc runtime options (main.F90:206,377).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Config:
    """Solver/runtime options.

    Attributes:
      dtype: numpy-style dtype string for device arrays ("float64" for parity
        with the reference's real(8); "float32"/"bfloat16" for speed).
      solver: "direct" (dense factorization; the MUMPS-equivalent for small n),
        "cg" (matrix-free Jacobi-preconditioned CG; SPD elastic path), or
        "auto" (direct below `direct_threshold` DOFs, else cg).
      rtol: Krylov relative tolerance (reference: 1e-9, main.F90:349-351).
      atol: Krylov absolute tolerance.
      maxiter: Krylov max iterations (0 -> heuristic n-based cap).
      bc_mode: "penalty" replicates the reference penalty method (diag<-1e30,
        rhs<-1e30*u_bc*dt/t, m_global.F90:296,451); "eliminate" pins the
        constrained DOFs exactly and moves their coupling to the RHS - the
        iterative-solver-friendly formulation with the same solution in the
        penalty->inf limit. Direct solves default to penalty, iterative to
        eliminate (resolved by `resolve_bc_mode`).
      newton_rtol/newton_atol/newton_stol/newton_maxit: SNES-equivalent Newton
        controls (PETSc defaults: rtol 1e-8, atol 1e-50, stol 1e-8, maxit 50).
      formulation: "reference" reproduces the shipped residual
        R(du) = J(du)*du - F_ext - F_coh(aggregate_u + du) (m_global.F90:226)
        - note this converges as a slow fixed-point iteration; the reference
        effectively takes ONE Newton step per increment because its penalty-
        dominated initial residual makes the relative tolerance trivially
        satisfiable. "standard" is the textbook incremental residual
        R(du) = K_el*du - F_ext - F_coh(aggregate_u + du) with consistent
        Jacobian (quadratic convergence). "total" solves the TRUE equilibrium
        K u = F_ext_cumulative(t) + F_coh(u) at each time - the reference's
        incremental scheme re-applies the total cohesive force as a load
        every step (sum_j F_coh(u_j) instead of F_coh(u_final)), which
        drifts over multiple increments; "total" is what reproduces the
        Abaqus UEL cross-validation. "auto" (default): "reference" when
        the penalty BC path is active (deck parity), "standard" otherwise
        (production large-scale path); both fixed points agree to <1% on the
        shipped-deck class.
      viscoelastic: enable the power-law creep correction (the live version
        of the reference's dead ReformElRHS path): per-step RHS term
        B^T D_eff dt beta(sigma) and backward-Euler ip-stress updates, using
        material columns 3-4 (viscosity, exponent) that the reference parses
        but never uses.
      quirks: replicate two latent reference bugs bit-for-bit (see
        fem_tpu/ops/cohesive.py): the dense cohesive traction overwriting
        instead of accumulating over integration points (m_global.F90:669) and
        the operator-precedence bug in the dense cohesive stiffness
        (m_global.F90:829-831). Default False: correct physics.
      direct_threshold: max DOF count for the dense direct path under "auto".
      n_devices: number of devices to shard elements over (None = all local).
    """

    dtype: str = "float64"
    solver: str = "auto"
    rtol: float = 1e-9
    atol: float = 0.0
    maxiter: int = 0
    bc_mode: str = "auto"
    newton_rtol: float = 1e-8
    newton_atol: float = 1e-50
    newton_stol: float = 1e-8
    newton_maxit: int = 50
    formulation: str = "auto"
    # Preconditioner for the iterative (cg) elastic path on UNSTRUCTURED
    # meshes: "jacobi", "amg" (smoothed aggregation, solver/amg.py), or
    # "auto" (amg at/above amg_threshold DOFs — the scalable replacement for
    # MUMPS' mesh-agnostic direct solve, main.F90:354-390). Structured box
    # decks use geometric multigrid regardless.
    precond: str = "auto"
    amg_threshold: int = 20000
    # Structured decks below this DOF count use the per-level host-driven
    # V-cycle (cheap traces); at/above it, the fused chunked MG-CG with
    # f64/f32 iterative refinement (the production large-solve shape).
    structured_big_threshold: int = 100000
    # Inner-tolerance strategy for the matrix-free Newton-Krylov path:
    # "ew" = Eisenstat-Walker choice 2 (loose early, tight late), "fixed" =
    # constant 1e-6 (the round-1 behavior).
    forcing: str = "ew"
    # Inner Krylov method for the matfree Newton path: "auto" = CG with a
    # GMRES fallback when the cohesive tangent goes indefinite (the MUMPS-
    # pivoting/gmres+asm role, main.F90:365-371,392-394); "cg" = plain CG
    # (no fallback).
    inner_krylov: str = "auto"
    # Dense SNES path: run each Newton iteration (residual/Jacobian/line
    # search) as ONE jitted dispatch with a single host sync per iteration
    # (newton.solve_step_jit) instead of the host-driven loop.
    jit_newton: bool = True
    quirks: bool = False
    viscoelastic: bool = False
    plane_stress: bool = False
    direct_threshold: int = 4096
    n_devices: Optional[int] = None
    # Checkpoint/resume (SURVEY.md §5: the reference has none; restartable
    # state is aggregate_u/aggregate_stress/du/step).
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    resume: bool = True
    # Profiling: device-trace directory for jax.profiler (TensorBoard format).
    profile_dir: Optional[str] = None
    # Log per-phase wall-clock totals (setup/rhs/solve/newton/stress) at the
    # end of the run.
    timing: bool = False

    def resolve_solver(self, ndof: int) -> str:
        if self.solver != "auto":
            return self.solver
        return "direct" if ndof <= self.direct_threshold else "cg"

    def resolve_bc_mode(self, solver: str) -> str:
        if self.bc_mode != "auto":
            return self.bc_mode
        return "penalty" if solver == "direct" else "eliminate"

    def resolve_formulation(self, bc_mode: str) -> str:
        if self.formulation != "auto":
            return self.formulation
        return "reference" if bc_mode == "penalty" else "standard"

    def resolve_precond(self, ndof: int) -> str:
        if self.precond != "auto":
            return self.precond
        return "amg" if ndof >= self.amg_threshold else "jacobi"
