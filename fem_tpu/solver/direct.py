"""Dense direct solve — the small-problem stand-in for MUMPS.

The reference always factorizes with a distributed sparse direct LU
(MUMPS via PETSc PCLU, main.F90:354-390). For the small shipped examples we
use a dense f64 factorization on the device (LU with partial pivoting via
jax.scipy), and large problems take the matrix-free Krylov path
(fem_tpu/solver/cg.py) instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl


def factorize(K):
    """LU-factorize once; reuse across time steps (the reference sets up the
    KSP once, main.F90:199-214)."""
    lu, piv = jsl.lu_factor(K)
    return (lu, piv)


def det_report(fac, null_rtol: float = 1e-12, ref_scale=None):
    """MUMPS-style determinant/pivot telemetry from an LU factorization.

    The reference prints, after every MUMPS factorization, the determinant
    of the (penalized) stiffness as mantissa * 2^exponent together with its
    null-pivot settings (icntl(33)=1 determinant, icntl(24)=1 null-pivot
    detection; print code main.F90:379-390 — e.g. "0.971 x 2^k" on the
    shipped cohesive run). Returns (mantissa, exponent, n_null) computed
    host-side from the U diagonal: mantissa carries the sign (permutation
    parity x product of diagonal signs) and lies in +-[0.5, 1); n_null
    counts pivots below null_rtol x the PHYSICAL stiffness scale
    (`ref_scale` = max|K| before penalization, the same rule as
    newton._robust_solve; MUMPS equilibrates before its cntl(3) test, so
    its scale is never dominated by 1e30 penalty-BC diagonals — on the
    shipped decks most rows are penalized, so no U-diagonal statistic can
    recover the physical scale). Falls back to median|U_ii| when
    ref_scale is None. A zero pivot returns (0.0, 0, n_null).
    """
    import numpy as np

    lu, piv = (np.asarray(jax.device_get(fac[0])),
               np.asarray(jax.device_get(fac[1])))
    d = np.diagonal(lu)
    ad = np.abs(d)
    if ref_scale is None:
        ref_scale = float(np.median(ad)) if ad.size else 0.0
    n_null = int(np.sum(ad <= null_rtol * float(ref_scale)))
    sign = -1.0 if (np.sum(piv != np.arange(piv.shape[0])) % 2) else 1.0
    sign *= float(np.prod(np.where(d < 0.0, -1.0, 1.0)))
    if np.any(d == 0.0):
        return 0.0, 0, n_null
    log2_total = float(np.sum(np.log2(ad)))
    # floor+1, not ceil: for an exact-integer log2 (det = 2^k) ceil would
    # return mantissa +-1.0, outside the documented +-[0.5, 1) (ADVICE r4)
    exp = int(np.floor(log2_total)) + 1
    mant = sign * 2.0 ** (log2_total - exp)  # |mant| in [0.5, 1)
    return mant, exp, n_null


def solve_factorized(fac, F):
    return jsl.lu_solve(fac, F)


def solve(K, F):
    return jnp.linalg.solve(K, F)


def apply_penalty_bcs(K, F, bc_dofs, bc_step_vals, penalty):
    """Reference penalty BC application (ApplyKBC m_global.F90:264-299 +
    EnforceBCForce m_global.F90:439-455): diag <- penalty (insert),
    F[bc] <- penalty * u_bc_step (insert)."""
    K = K.at[bc_dofs, bc_dofs].set(penalty)
    F = F.at[bc_dofs].set(penalty * bc_step_vals)
    return K, F


def eliminate_bcs(K, F, bc_dofs, bc_step_vals):
    """Exact-constraint variant: zero the bc rows/cols, unit diagonal,
    F_free -= K[:, bc] @ u_bc, F[bc] = u_bc. Identical solution to the
    penalty method in the penalty->inf limit, but well-conditioned for
    iterative solvers."""
    n = K.shape[0]
    ubc = jnp.zeros(n, dtype=K.dtype).at[bc_dofs].set(bc_step_vals)
    F = F - K @ ubc
    mask = jnp.zeros(n, dtype=bool).at[bc_dofs].set(True)
    K = jnp.where(mask[:, None] | mask[None, :], 0.0, K)
    K = K.at[bc_dofs, bc_dofs].set(1.0)
    F = jnp.where(mask, ubc, F)
    return K, F
