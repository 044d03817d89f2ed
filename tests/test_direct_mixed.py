"""Dense f64 solves with penalty rows, and penalty-robust null pivots.

robust_solve's null-pivot threshold once used max(row_scale), which the 1e30
penalty-BC diagonal dominates, flagging every PHYSICAL row as null
(delta ~ 0, Newton stalls). MUMPS equilibrates before null-pivot detection
(main.F90:365-371), so the reference never sees that failure. These tests
pin the f64 dense solves and the penalty/eliminate physics agreement.
"""

import jax.numpy as jnp
import numpy as np

from fem_tpu.config import Config
from fem_tpu.io import meshgen
from fem_tpu.models.system import PENALTY, System
from fem_tpu.solver import direct, newton


def _penalty_system(n=40, nbc=6, seed=0):
    """SPD system with penalty-style 1e30 diagonal rows inserted."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    K = A @ A.T + n * np.eye(n)  # SPD, well conditioned
    K *= 1e4  # physical stiffness scale
    x_true = rng.standard_normal(n)
    bc = rng.choice(n, size=nbc, replace=False)
    Kp = K.copy()
    Kp[bc, bc] = float(PENALTY)
    rhs = K @ x_true
    rhs[bc] = float(PENALTY) * x_true[bc]
    return Kp, rhs, x_true


def test_dense_solve_with_penalty_rows_is_f64_exact():
    """The f64 dense solve keeps f64 accuracy with 1e30 penalty rows."""
    Kp, rhs, x_true = _penalty_system()
    x = direct.solve(jnp.asarray(Kp, dtype=jnp.float64),
                     jnp.asarray(rhs, dtype=jnp.float64))
    rel = np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(x_true)
    assert rel < 1e-12


def test_factorized_solve_matches_dense_solve():
    Kp, rhs, _ = _penalty_system(seed=2)
    K, F = jnp.asarray(Kp), jnp.asarray(rhs)
    a = direct.solve_factorized(direct.factorize(K), F)
    b = direct.solve(K, F)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12)


def test_robust_solve_penalty_rows_not_flagged_null():
    Kp, rhs, x_true = _penalty_system()
    ref = float(np.max(np.abs(Kp[np.abs(Kp) < 1e20])))  # physical scale
    x = newton._robust_solve(
        jnp.asarray(Kp, dtype=jnp.float64),
        jnp.asarray(rhs, dtype=jnp.float64),
        ref=ref,
    )
    rel = np.linalg.norm(np.asarray(x) - x_true) / np.linalg.norm(x_true)
    assert rel < 1e-10


def test_norm_safe_overflow_and_agreement():
    """_norm_safe must survive entries whose square overflows the dtype's
    exponent range. An f64 emulated with an f32 exponent (~1e38) overflows
    a plain jnp.linalg.norm on penalty-row residuals ~1e30; native f64
    reproduces the effect at 1e300."""
    x = jnp.asarray([1e300, -3e300, 2e299], dtype=jnp.float64)
    plain = jnp.linalg.norm(x)
    assert not bool(jnp.isfinite(plain))  # the failure mode being fixed
    safe = newton._norm_safe(x)
    expect = 3e300 * float(np.linalg.norm([1e300 / 3e300, -1.0, 2e299 / 3e300]))
    assert bool(jnp.isfinite(safe))
    assert abs(float(safe) - expect) < 1e-12 * expect
    # agreement with the plain norm in the normal range
    rng = np.random.default_rng(3)
    y = jnp.asarray(rng.standard_normal(101))
    assert abs(float(newton._norm_safe(y)) - float(jnp.linalg.norm(y))) < 1e-13
    # all-zero vector: no division by zero, returns 0
    assert float(newton._norm_safe(jnp.zeros(7))) == 0.0


def test_penalty_newton_matches_eliminate_physics():
    """Regression for the null-pivot poisoning: with penalty BCs the dense
    Newton solve must reach the same displacement field as eliminate-mode
    (penalty 1e30 pins Dirichlet dofs to ~machine precision)."""
    p = meshgen.cohesive_interface_problem(
        6, 3, open_disp=0.004, t=1.0, dt=0.25, E=3640.0, nu=0.3,
        coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0),
    )
    s = System(p, dtype=jnp.float64)
    cfg = Config()
    agg = jnp.zeros(s.ndof)
    du0 = jnp.zeros(s.ndof)
    F = s.rhs(0.0)
    r_pen = newton.solve_step(s, cfg, agg, du0, F, bc_mode="penalty")
    r_eli = newton.solve_step(s, cfg, agg, du0, F, bc_mode="eliminate")
    assert r_pen.converged and r_eli.converged
    nd = max(float(jnp.linalg.norm(r_eli.du)), 1e-30)
    # Penalty mode's rtol test is measured against a 1e30-inflated r0 (the
    # reference's SNES sees the same penalty-row residual, SNES defaults,
    # main.F90:206), so it legitimately stops at a looser physical residual
    # than eliminate mode. The regression guarded here is the null-pivot
    # poisoning, which produced rel err ~0.99 (garbage), not ~1e-4.
    assert float(jnp.linalg.norm(r_pen.du - r_eli.du)) < 1e-3 * nd


def test_penalty_newton_jit_matches_eliminate_physics():
    p = meshgen.cohesive_interface_problem(
        6, 3, open_disp=0.004, t=1.0, dt=0.25, E=3640.0, nu=0.3,
        coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0),
    )
    s = System(p, dtype=jnp.float64)
    cfg = Config()
    agg = jnp.zeros(s.ndof)
    du0 = jnp.zeros(s.ndof)
    F = s.rhs(0.0)
    r_pen = newton.solve_step_jit(s, cfg, agg, du0, F, bc_mode="penalty")
    r_eli = newton.solve_step_jit(s, cfg, agg, du0, F, bc_mode="eliminate")
    assert r_pen.converged and r_eli.converged
    nd = max(float(jnp.linalg.norm(r_eli.du)), 1e-30)
    assert float(jnp.linalg.norm(r_pen.du - r_eli.du)) < 1e-3 * nd


def test_det_report_matches_numpy_det():
    """MUMPS-style determinant telemetry (main.F90:379-390): mantissa*2^exp
    from the LU factors must equal det(K), sign included, with |mant| in
    [0.5, 1)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((12, 12))
    K = A @ A.T + 12 * np.eye(12)  # SPD -> positive det
    m, e, nn = direct.det_report(direct.factorize(jnp.asarray(K)))
    assert 0.5 <= abs(m) < 1.0
    assert nn == 0
    np.testing.assert_allclose(m * 2.0 ** e, np.linalg.det(K), rtol=1e-10)

    Kneg = K.copy()
    Kneg[0] *= -1.0  # flip one row -> negative determinant
    m2, e2, _ = direct.det_report(direct.factorize(jnp.asarray(Kneg)))
    assert m2 < 0.0
    np.testing.assert_allclose(m2 * 2.0 ** e2, np.linalg.det(Kneg),
                               rtol=1e-10)


def test_det_report_counts_null_pivots():
    """A numerically-null row (fully separated cohesive dof) must be
    reported, mirroring MUMPS icntl(24)=1 null-pivot detection."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((10, 10))
    K = A @ A.T + 10 * np.eye(10)
    K[7, :] = 0.0
    K[:, 7] = 0.0
    K[7, 7] = 1e-30  # null relative to the physical scale
    m, e, nn = direct.det_report(direct.factorize(jnp.asarray(K)))
    assert nn >= 1
