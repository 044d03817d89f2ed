"""chip_smoke.py's checks on the CPU: the device gate refuses a CPU, the
golden-deck phase, the independent true-residual check and the Newton log
reader. Its solve phases at tiny sizes are in test_chip_smoke_phases.py; the
run on the card itself carries the `gpu` marker."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from fem_tpu.config import Config  # noqa: E402
from fem_tpu.io import meshgen  # noqa: E402
from fem_tpu.solver import stepper  # noqa: E402


def test_require_gpu_raises_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.require_gpu()


def test_main_exits_before_any_output_without_gpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert capsys.readouterr().out == ""


def test_bench_refuses_cpu(capsys):
    import bench

    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_phase_golden_matches_reference_vtk(tmp_path):
    rec = chip_smoke.phase_golden(str(tmp_path))
    assert rec["u_y"] == [0.0, 0.05, 0.1]
    np.testing.assert_allclose(rec["stress_top"], [105.0, 245.0, 0.0],
                               atol=1e-6)


def test_relative_true_residual_matches_dense_eliminated_system():
    """The host-CSR residual equals the dense eliminated-system residual
    and is not fooled by a wrong displacement."""
    from fem_tpu.models.system import System
    from fem_tpu.solver import direct

    p = meshgen.hex_box_problem(3, 2, 2, jitter=0.2, t=1.0, dt=0.5)
    s = System(p, dtype=jnp.float64)
    Ke, Fe = direct.eliminate_bcs(s.dense_K(), s.rhs_cumulative(s.t_total),
                                  s.bc_dofs, s.bc_total_vals(s.t_total))
    u = np.asarray(direct.solve(Ke, Fe))
    assert chip_smoke.relative_true_residual(p, u) < 1e-10
    rng = np.random.default_rng(0)
    u_bad = u + 1e-3 * np.abs(u).max() * rng.standard_normal(u.shape)
    dense = float(np.linalg.norm(np.asarray(Fe) - np.asarray(Ke) @ u_bad)
                  / np.linalg.norm(np.asarray(Fe)))
    np.testing.assert_allclose(
        chip_smoke.relative_true_residual(p, u_bad), dense, rtol=1e-10)
    assert dense > 1e-6


def test_newton_step_residuals_reads_each_load_step():
    logs = ["Interval: 1", "    newton: r0=1.000e+00 tol=1.000e-08",
            "    newton it 1: rnorm=1.000e-03 lam=1.0",
            "    newton it 2: rnorm=5.000e-09 lam=1.0",
            "Interval: 2", "    newton: r0=2.000e+00 tol=2.000e-08"]
    assert chip_smoke.newton_step_residuals(logs) == [
        (5e-9, 1e-8), (2.0, 2e-8)]


def test_solve_path_keeps_setup_lines_only():
    logs = ["Interval: 1", "    Structured grid detected: stencil",
            "    newton: r0=1 tol=1", "    SNES Iteration Count: 2"]
    assert chip_smoke.solve_path(logs) == ["Structured grid detected: stencil"]


@pytest.fixture
def gpu_device():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return dev


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_device, capsys):
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"ok": true' in last and '"platform": "gpu"' in last


def test_stepper_result_is_host_array():
    """run_solve's timing ends on the host copy of u (stepper.run returns
    numpy), so block_until_ready covers the whole solve."""
    p = meshgen.quad_grid_problem(2, 2, E=100.0, nu=0.3,
                                  tip_force=(0.0, -1.0))
    res, wall, _ = chip_smoke.run_solve(p, Config())
    assert isinstance(res.aggregate_u, np.ndarray) and wall > 0
    assert stepper.StepResult is type(res)
