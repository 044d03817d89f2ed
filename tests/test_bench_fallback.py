"""The bench GMG -> SA-AMG fallback must engage on a corrupt solve.

bench.bench_amg_solve acceptance-tests its geometric cycle (miscompiles #5
and #6 in DESIGN.md once corrupted such cycles): if the GMG-preconditioned
solve comes back non-finite OR with blown-up iteration counts, it rebuilds
with the gather-based SA-AMG hierarchy and re-solves. The bench's lattice
path is the grid-state geometric cycle (gmg.build_lattice), with SA-AMG
when that declines; these tests poison the cycle on CPU and assert the
fallback produces a finite, converged record. Mirrors the MUMPS-grade reliability bar of the
reference's only solver configuration (main.F90:354-390).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.slow  # ~2 min: four full n=8 AMG/GMG solves on CPU


def test_gmg_nonfinite_triggers_sa_fallback(monkeypatch):
    import bench
    from fem_tpu.solver import gmg

    # keep the env from redirecting the mesh size
    monkeypatch.delenv("FEM_TPU_BENCH_AMG_N", raising=False)

    real_v_g = gmg.v_cycle_g

    def poisoned_v_g(h, mv, r):
        # models miscompile #6: the compiled cycle silently produces
        # garbage while every standalone piece is exact
        return real_v_g(h, mv, r) * jnp.nan

    monkeypatch.setattr(gmg, "v_cycle_g", poisoned_v_g)

    rec = bench.bench_amg_solve(n=8)

    assert rec["precond"] == "sa-amg-fallback"
    assert np.isfinite(rec["rel_residual"])
    assert rec["rel_residual"] <= 1e-8


def test_gmg_finite_keeps_gmg(monkeypatch):
    import bench

    monkeypatch.delenv("FEM_TPU_BENCH_AMG_N", raising=False)

    rec = bench.bench_amg_solve(n=8)

    assert rec["precond"] == "gmg"
    assert np.isfinite(rec["rel_residual"])
    assert rec["rel_residual"] <= 1e-8


def test_gmg_degraded_convergence_triggers_sa_fallback(monkeypatch):
    """Miscompile #6 is binary-dependent: a recompile can return a
    SILENTLY corrupt (finite) V-cycle that balloons CG iterations ~10x
    while the f64 IR outer still verifies (round 4, 527k: 24 -> 264
    inner its). The bench must treat the iteration blowup as corruption
    and demote to SA-AMG. Modeled by an identity 'V-cycle' (valid but
    useless preconditioner -> unpreconditioned-CG iteration counts)."""
    import bench
    from fem_tpu.solver import gmg

    monkeypatch.delenv("FEM_TPU_BENCH_AMG_N", raising=False)

    monkeypatch.setattr(gmg, "v_cycle_g", lambda h, mv, r: r)

    rec = bench.bench_amg_solve(n=8)

    assert rec["precond"] == "sa-amg-fallback"
    assert np.isfinite(rec["rel_residual"])
    assert rec["rel_residual"] <= 1e-8


def test_sa_when_grid_hierarchy_declines(monkeypatch):
    """When gmg.build_lattice declines, the bench preconditions with
    SA-AMG from the start."""
    import bench
    from fem_tpu.solver import gmg

    monkeypatch.setattr(gmg, "build_lattice", lambda *a, **k: None)
    monkeypatch.delenv("FEM_TPU_BENCH_AMG_N", raising=False)

    rec = bench.bench_amg_solve(n=8)

    assert rec["precond"] == "sa-amg"
    assert np.isfinite(rec["rel_residual"])
    assert rec["rel_residual"] <= 1e-8
