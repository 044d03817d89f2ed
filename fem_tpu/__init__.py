"""fem_tpu — a finite-element framework built on JAX/XLA.

Re-implements the capabilities of the Fortran+PETSc reference solver
(srinath-chakravarthy/FEM, see SURVEY.md) for an accelerator: struct-of-arrays
meshes, type-batched vmapped element kernels, device-side segment-sum
assembly, matrix-free preconditioned Krylov solvers inside jit,
Newton-with-line-search for cohesive nonlinearity, and SPMD element sharding
over a `jax.sharding.Mesh` with collectives.

The reference's external native stack (PETSc/MUMPS/METIS/MPI/LAPACK) maps to:
  - PETSc Vec/Mat/VecScatter  -> sharded jnp arrays + segment_sum assembly
  - MUMPS direct LU           -> dense Cholesky/LU for small n, matrix-free
                                 Jacobi-PCG / GMRES for large n
  - PETSc SNES Newton-LS      -> fem_tpu.solver.newton (lax.while_loop)
  - METIS partitioning        -> fem_tpu.parallel.partition (block/SFC) and a
                                 native C++ mesh engine (native/)
  - MPI collectives           -> jax.lax.psum / shard_map over a device mesh

Float64 is the FEM default (parity with the reference's real(8)); performance
paths pass explicit float32/bfloat16 dtypes.
"""

import jax

# FEM requires double precision for parity with the reference (real(8)
# everywhere, KSP rtol 1e-9, displacement parity target 1e-8). Performance
# kernels opt into float32/bfloat16 explicitly.
jax.config.update("jax_enable_x64", True)
# f32 contractions run at full f32 precision: a GPU otherwise may run them in
# TF32 (10-bit mantissa), which silently weakens every f32 inner solve.
jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

from fem_tpu.config import Config  # noqa: E402,F401
