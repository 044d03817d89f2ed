"""On-GPU smoke test of the deck-driven solve path, one process, one card.

    python chip_smoke.py          # phases 1-6 on one GPU
    python chip_smoke.py --four   # sharded phases 3-4 on four GPUs, each
                                  # beside its one-card counterpart

Every phase goes through the entry points a user calls (`cli.main`,
`stepper.run`) with a default `Config`, at the sizes the benchmark decks
use:

1. device: jax.devices()[0] must be a GPU (no CPU fallback);
2. the golden elastic deck through the CLI, diffed against its golden VTK;
3. the structured 3D hex8 cantilever, 80^3 cells (1.59M dofs): stencil +
   multigrid under f64/f32 iterative refinement;
4. a jittered 55^3 lattice box (527k dofs): block stencil + geometric
   lattice multigrid;
5. a node-permuted jittered 40^3 box (207k dofs): general topology, SA-AMG
   around the gather operator (operator.matvec_cm);
6. the cohesive instability strip (105k dofs), two load steps past the
   traction peak, through matrix-free Newton.

Phases 3-5 are checked with the f64 relative true residual
||F - K u|| / ||F|| against a CSR assembled on the host independently of the
path under test (amg.assemble_csr, BCs eliminated, scipy f64 matvec), which
must be <= Config.rtol. Phase 6 must meet Config.newton_rtol in every load
step, with a finite u. Three more lines give XLA's time on the card for
hex8 stiffness formation and one stencil matvec at 1.59M dofs in the matmul
schedule (the solvers') and the planes schedule.

A failed phase raises: the script exits non-zero and does not print its
last line, which is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

import bench
from bench import device_record, require_gpu

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "ref", "SNES_test", "elastic")

# Seconds JAX spent tracing, lowering and compiling (all backends), summed
# by a monitoring listener that main() registers.
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]


def _on_duration(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration


def card_line() -> str:
    """`name, power.limit` of the card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peak_bytes():
    """Peak device bytes in use so far in this process (None if the
    backend keeps no statistics)."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def report(name: str, rec: dict) -> None:
    print(f"[{name}] " + json.dumps(rec), flush=True)


def start(name: str) -> float:
    """Announce a phase; returns the compile-seconds counter at its start."""
    print(f"[{name}] start {time.strftime('%H:%M:%S')}", flush=True)
    return _compile_s[0]


def relative_true_residual(problem, u) -> float:
    """||F - K u|| / ||F|| of the cumulative linear system with eliminated
    BCs, K assembled on the host (amg.assemble_csr) and applied in scipy f64."""
    import jax
    import jax.numpy as jnp

    from fem_tpu.models.system import System
    from fem_tpu.solver import amg

    with jax.default_device(jax.devices("cpu")[0]):
        s = System(problem, dtype=jnp.float64)
        A = amg.assemble_csr(s)
        F = np.asarray(s.rhs_cumulative(s.t_total), np.float64)
        ubc_vals = np.asarray(s.bc_total_vals(s.t_total), np.float64)
    bc = np.asarray(s.bc_dofs)
    u = np.asarray(u, np.float64)
    ubc = np.zeros_like(F)
    ubc[bc] = ubc_vals
    # eliminated system K_e u = F_e: free rows F - K u with the constrained
    # entries of u held at u_bc, constrained rows u_bc - u
    u_e = u.copy()
    u_e[bc] = ubc[bc]
    r = F - A @ u_e
    r[bc] = ubc[bc] - u[bc]
    Fe = F - A @ ubc
    Fe[bc] = ubc[bc]
    return float(np.linalg.norm(r) / np.linalg.norm(Fe))


def run_solve(problem, config):
    """stepper.run timed on the host clock; returns (result, wall, logs)."""
    import jax

    from fem_tpu.solver import stepper

    logs = []
    t0 = time.perf_counter()

    def log(msg):  # echoed live, so a slow step shows where it is
        logs.append(msg)
        print(f"  [+{time.perf_counter() - t0:7.1f}s] {msg}", flush=True)

    res = stepper.run(problem, config, log=log)
    jax.block_until_ready(res.aggregate_u)
    return res, time.perf_counter() - t0, logs


def solve_path(logs) -> list:
    """The solver-path lines the stepper logged (indented set-up lines)."""
    return [m.strip() for m in logs if m.startswith("    ")
            and not m.strip().startswith(("newton", "SNES"))]


def _linear_phase(name, problem, config, expect, check_residual=True):
    c0 = start(name)
    res, wall, logs = run_solve(problem, config)
    compile_s = _compile_s[0] - c0
    path = solve_path(logs)
    for want in expect:
        if not any(want in m for m in path):
            raise RuntimeError(f"{name}: expected path {want!r}, got {path}")
    u = res.aggregate_u
    if not np.all(np.isfinite(u)):
        raise RuntimeError(f"{name}: non-finite displacement")
    t1 = time.perf_counter()
    rel = relative_true_residual(problem, u) if check_residual else None
    rec = {"ndof": int(problem.ndof), "wall_s": wall,
           "check_s": time.perf_counter() - t1,
           "setup_s": res.timers.totals.get("setup", 0.0),
           "solve_s": res.timers.totals.get("solve", 0.0),
           "compile_s": compile_s,
           "krylov_iters": res.krylov_iters, "rel_true_residual": rel,
           "peak_bytes_in_use": peak_bytes(), "path": path}
    report(name, rec)
    if check_residual and not rel <= config.rtol:
        raise RuntimeError(f"{name}: true residual {rel:.3e} > {config.rtol}")
    return res, rec


def phase_golden(outdir: str) -> dict:
    """The golden elastic deck through the CLI, diffed against its VTK."""
    from fem_tpu.cli import main as cli_main
    from fem_tpu.io import vtk

    c0 = start("golden")
    deck = os.path.join(GOLDEN_DIR, "elastic_test.inp")
    prefix = os.path.join(outdir, "")
    t0 = time.perf_counter()
    if cli_main(["-f", deck, "-o", prefix, "-q"]) != 0:
        raise RuntimeError("golden: CLI failed")
    wall = time.perf_counter() - t0
    pts, stress, disp = vtk.read_fields(prefix + "0_output_000000.vtk")
    gpts, gstress, gdisp = vtk.read_fields(
        os.path.join(GOLDEN_DIR, "0_output_000000.vtk"))
    for i in range(gpts.shape[0]):
        j = int(np.argmin(np.linalg.norm(pts - gpts[i], axis=1)))
        if (np.linalg.norm(pts[j] - gpts[i]) > 1e-9
                or np.max(np.abs(disp[j] - gdisp[i])) > 1e-6
                or np.max(np.abs(stress[j] - gstress[i])) > 1e-6):
            raise RuntimeError(f"golden: mismatch at point {gpts[i]}")
    rec = {"wall_s": wall, "compile_s": _compile_s[0] - c0,
           "u_y": sorted({round(float(v), 6) for v in disp[:, 1]}),
           "stress_top": [round(float(v), 6) for v in
                          stress[int(np.argmax(pts[:, 1]))]],
           "peak_bytes_in_use": peak_bytes()}
    report("golden", rec)
    return rec


def phase_structured(n=80, config=None, check_residual=True):
    """Structured hex8 cantilever (BASELINE.json configs[4])."""
    from fem_tpu.config import Config
    from fem_tpu.io import meshgen

    config = config or Config()
    p = meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0,
                                E=200e9, nu=0.3, tip_load=-1e6)
    expect = ["Structured grid detected"]
    if config.n_devices:
        expect.append("MG fine level sharded")
    elif p.ndof >= config.structured_big_threshold:
        expect.append("f64/f32 iterative refinement")
    return _linear_phase("structured", p, config, expect, check_residual)


def phase_lattice(n=55, config=None, check_residual=True):
    """Jittered lattice box: block stencil + geometric lattice MG."""
    from fem_tpu.config import Config
    from fem_tpu.io import meshgen

    config = config or Config()
    p = meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0,
                                E=200e9, nu=0.3, tip_load=-1e6, jitter=0.2)
    expect = ["Geometric lattice-MG preconditioner"]
    expect.append("DOF-sharded halo block stencil" if config.n_devices
                  else "Lattice topology: block-stencil fine operator")
    return _linear_phase("lattice", p, config, expect, check_residual)


def phase_general(n=40, config=None):
    """Node-permuted jittered box: SA-AMG around the gather operator."""
    from fem_tpu.config import Config
    from fem_tpu.io import meshgen

    config = config or Config()
    p = meshgen.permute_nodes(
        meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0,
                                E=200e9, nu=0.3, tip_load=-1e6, jitter=0.2),
        seed=1)
    return _linear_phase("general", p, config,
                         ["AMG preconditioner (smoothed aggregation)"])


_R0 = re.compile(r"newton: r0=(\S+) tol=(\S+)")
_RN = re.compile(r"newton it \d+: rnorm=(\S+)")


def newton_step_residuals(logs):
    """[(final rnorm, tol)] per load step, from the Newton log lines."""
    steps = []
    for m in logs:
        if (g := _R0.search(m)) is not None:
            steps.append([float(g.group(1)), float(g.group(2))])
        elif (g := _RN.search(m)) is not None:
            steps[-1][0] = float(g.group(1))
    return [tuple(s) for s in steps]


def phase_cohesive(nx=360, ny_half=72, config=None):
    """Cohesive strip pulled to 1.5 delta_n in two load steps, through the
    matrix-free Newton path."""
    from fem_tpu.config import Config
    from fem_tpu.io import meshgen

    config = config or Config(solver="cg")
    p = meshgen.cohesive_interface_problem(
        nx, ny_half, lx=5.0, ly_half=1.0, E=3640.0, open_disp=0.015,
        t=1.0, dt=0.5, coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0))
    c0 = start("cohesive")
    res, wall, logs = run_solve(p, config)
    steps = newton_step_residuals(logs)
    rec = {"ndof": int(p.ndof), "wall_s": wall,
           "compile_s": _compile_s[0] - c0,
           "newton_s": res.timers.totals.get("newton", 0.0),
           "newton_iters": res.newton_iters,
           "inner_krylov_iters": res.krylov_iters,
           "gmres_fallbacks": res.gmres_fallbacks,
           "step_rnorm_tol": steps, "peak_bytes_in_use": peak_bytes(),
           "path": solve_path(logs)
           + [m.strip() for m in logs if "newton wall" in m]}
    report("cohesive", rec)
    if not np.all(np.isfinite(res.aggregate_u)):
        raise RuntimeError("cohesive: non-finite displacement")
    if len(steps) != res.nsteps or any(not r <= tol for r, tol in steps):
        raise RuntimeError(f"cohesive: Newton residual above tol: {steps}")
    return res, rec


def xla_op_times():
    """XLA's own time on the card for hex8 stiffness formation and one
    stencil matvec at 1.59M dofs, in the matmul schedule that the solvers
    run and in the planes schedule."""
    start("xla_ops")
    rate, dt = bench.bench_element_stiffness()
    report("xla_hex8_stiffness", {"elements": 131072, "dtype": "float32",
                                  "elements_per_s": rate, "s_per_call": dt})
    times, ndof = bench.bench_stencil_matvecs(n=80)
    for name, mv in times.items():
        report(f"xla_{name}_matvec",
               {"ndof": ndof, "dtype": "float32", "ms": mv * 1e3,
                "on_solver_path": name == "matmul"})


def run_four(n_structured=80, n_lattice=55, base=None):
    """Sharded phases 3 and 4 on four devices beside their one-card runs."""
    import dataclasses

    import jax

    from fem_tpu.config import Config

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 devices, found {len(jax.devices())}")
    base = base or Config()
    # the one-card structured solve takes the same host-driven MG-CG as the
    # sharded one (structured_big_threshold above n), so counts compare
    one = dataclasses.replace(base, structured_big_threshold=10 ** 9)
    four = dataclasses.replace(base, n_devices=4)
    for name, fn, n, same_iters in (
            ("structured", phase_structured, n_structured, True),
            ("lattice", phase_lattice, n_lattice, False)):
        # the agreement with the one-card run is the check here; phase 3-4's
        # residual checks belong to the one-card smoke run
        ref, _ = fn(n, config=one, check_residual=False)
        shd, _ = fn(n, config=four, check_residual=False)
        du = (np.linalg.norm(shd.aggregate_u - ref.aggregate_u)
              / np.linalg.norm(ref.aggregate_u))
        rec = {"rel_u_diff": du, "iters_1": ref.krylov_iters,
               "iters_4": shd.krylov_iters}
        # every card holds its shard: none may have stayed empty
        rec["peak_bytes_per_device"] = [
            (d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.devices()[:4]]
        report(f"{name}_4_vs_1", rec)
        if 0 in rec["peak_bytes_per_device"]:
            raise RuntimeError(f"{name}: a device held no shard")
        if not du <= 1e-8:
            raise RuntimeError(f"{name}: 4-card u differs by {du:.3e}")
        for a, b in zip(shd.krylov_iters, ref.krylov_iters):
            tol = 0 if same_iters else max(2, int(0.25 * b))
            if abs(a - b) > tol:
                raise RuntimeError(f"{name}: iterations {a} vs {b}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded phases 3-4 on four GPUs")
    args = ap.parse_args(argv)

    dev = require_gpu()
    import jax
    import jax.monitoring

    from fem_tpu.utils import jaxcache

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    jaxcache.enable()
    print(f"card: {card_line()}", flush=True)
    report("device", device_record(dev))
    t0 = time.perf_counter()
    if args.four:
        run_four()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            phase_golden(tmp)
        phase_structured()
        phase_lattice()
        phase_general()
        phase_cohesive()
        xla_op_times()
    print(f"total wall {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": device_record(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
