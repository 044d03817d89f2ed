"""chip_smoke.py's solve phases at tiny sizes on the CPU.

Each phase runs the production path it runs on the card (the size gates are
lowered so a 5^3 box takes the same branch) and is held to the same f64
true-residual check, and its displacement to the dense direct solve.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from fem_tpu.config import Config  # noqa: E402
from fem_tpu.io import meshgen  # noqa: E402
from fem_tpu.solver import stepper  # noqa: E402


def _agrees_with_direct(problem, u):
    ref = stepper.run(problem, Config(solver="direct", bc_mode="eliminate"))
    scale = np.abs(ref.aggregate_u).max()
    np.testing.assert_allclose(u, ref.aggregate_u, atol=1e-7 * scale)


def test_phase_structured_ir_path():
    res, rec = chip_smoke.phase_structured(
        5, Config(solver="cg", structured_big_threshold=0))
    assert rec["rel_true_residual"] <= 1e-9
    assert any("iterative refinement" in m for m in rec["path"])
    _agrees_with_direct(meshgen.hex_box_problem(
        5, 5, 5, lx=1.0, ly=1.0, lz=1.0, E=200e9, nu=0.3, tip_load=-1e6),
        res.aggregate_u)


def test_phase_lattice_grid_gmg(monkeypatch):
    monkeypatch.setenv("FEM_TPU_GMG_MIN", "1")
    res, rec = chip_smoke.phase_lattice(5, Config(solver="cg", precond="amg"))
    assert rec["rel_true_residual"] <= 1e-9
    assert not any("ELL" in m for m in rec["path"])
    _agrees_with_direct(meshgen.hex_box_problem(
        5, 5, 5, lx=1.0, ly=1.0, lz=1.0, E=200e9, nu=0.3, tip_load=-1e6,
        jitter=0.2), res.aggregate_u)


def test_phase_general_sa_amg():
    res, rec = chip_smoke.phase_general(5, Config(solver="cg", precond="amg"))
    assert rec["rel_true_residual"] <= 1e-9
    assert not any("Lattice" in m for m in rec["path"])
    p = meshgen.permute_nodes(
        meshgen.hex_box_problem(5, 5, 5, lx=1.0, ly=1.0, lz=1.0, E=200e9,
                                nu=0.3, tip_load=-1e6, jitter=0.2), seed=1)
    _agrees_with_direct(p, res.aggregate_u)


def test_phase_cohesive_meets_newton_rtol():
    res, rec = chip_smoke.phase_cohesive(4, 2)
    assert len(rec["step_rnorm_tol"]) == 2
    assert all(r <= tol for r, tol in rec["step_rnorm_tol"])
    p = meshgen.cohesive_interface_problem(
        4, 2, lx=5.0, ly_half=1.0, E=3640.0, open_disp=0.015, t=1.0, dt=0.5,
        coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0))
    ref = stepper.run(p, Config(solver="direct", bc_mode="eliminate"))
    scale = np.abs(ref.aggregate_u).max()
    np.testing.assert_allclose(res.aggregate_u, ref.aggregate_u,
                               atol=1e-6 * scale)


def test_phase_rejects_unconverged_solve():
    """A solve stopped short of Config.rtol fails the phase."""
    with pytest.raises(RuntimeError, match="true residual"):
        chip_smoke.phase_structured(
            4, Config(solver="cg", maxiter=2))
