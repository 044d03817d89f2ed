"""Benchmark stages on one GPU, in one process.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

Headline: hex8 element stiffness formation (k_e = sum_ip B^T D B w |J|, 8
integration points, 24x24 output) in float32 — the reference's hottest
kernel (FormElKE, m_local.F90:21-67). vs_baseline divides by an estimate of
the reference's 64-core CPU rate (a measured single-core C++ FormElKE from
native/benchref.cpp times 64, or 2e6 elems/s when it cannot be built).

Secondary stages (JSON records on stderr), all run every time, in order:
stencil and fused-operator matvecs, the 1.59M-dof structured MG-IR solve,
the 527k-dof jittered-lattice AMG/GMG solve and the cohesive Newton solve.
Every time is taken on the host clock around work that ends in
`block_until_ready`. Without a GPU the script exits non-zero before any
measurement.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REFERENCE_64CORE_ELEMS_PER_SEC = 2.0e6  # used when benchref cannot be built

_T0 = time.time()


def log(msg):
    print(f"[{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def require_gpu():
    """The first device, which must be a GPU: a measurement path that finds
    no GPU fails instead of timing the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: jax.devices()[0] is {dev.platform!r} ({dev.device_kind})")
    return dev


def device_record(dev):
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def measure_reference_baseline():
    """64-core reference baseline from a MEASURED single-core -O3 C++
    reimplementation of FormElKE (native/benchref.cpp), assuming perfect MPI
    scaling — a deliberately generous stand-in for the Fortran+PETSc
    reference. Falls back to a constant if the library cannot be built."""
    import ctypes

    from fem_tpu.io import native

    path = native.build("libbenchref.so")
    if path is None:
        return REFERENCE_64CORE_ELEMS_PER_SEC, "estimated"
    lib = ctypes.CDLL(path)
    lib.fem_ref_ke_rate.restype = ctypes.c_double
    lib.fem_ref_ke_rate.argtypes = [ctypes.c_int64]
    per_core = lib.fem_ref_ke_rate(100000)
    return 64.0 * per_core, f"measured ({per_core:.3e}/core x 64)"


def _time_call(f, *args, iters):
    """Mean seconds per call of a jitted f, after one warm-up call."""
    jax.block_until_ready(f(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = f(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def bench_element_stiffness(ne=131072, iters=20, dtype=jnp.float32):
    """hex8 stiffness formation rate (elements/s) and seconds per batch."""
    from fem_tpu.ops import elements, stiffness

    et = elements.get("hex")
    rng = np.random.default_rng(0)
    base = np.array(
        [
            [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
            [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
        ],
        dtype=np.float32,
    )
    offsets = rng.normal(size=(ne, 1, 3)).astype(np.float32)
    jitter = 0.05 * rng.normal(size=(ne, 8, 3)).astype(np.float32)
    # element-batch-LAST layout: (pdim, nn, ne) — see
    # stiffness.element_stiffness_lame_batchlast.
    ecoords = jnp.asarray(
        np.transpose(base[None] + offsets + jitter, (2, 1, 0)), dtype=dtype
    )
    lam, mu = stiffness.lame(
        jnp.full(ne, 200.0e9, dtype=dtype), jnp.full(ne, 0.3, dtype=dtype)
    )
    f = jax.jit(
        lambda ec: stiffness.element_stiffness_lame_batchlast(et, ec, lam, mu)
    )
    dt = _time_call(f, ecoords, iters=iters)
    return ne / dt, dt


def _stencil_f32(n):
    """f32 stencil operator of an n^3 hex8 box and a random vector."""
    from fem_tpu.ops import structured
    from fem_tpu.ops.stiffness import lame

    lam, mu = lame(jnp.asarray(200e9, jnp.float32),
                   jnp.asarray(0.3, jnp.float32))
    st = structured.build((1.0 / n,) * 3, (n + 1,) * 3, lam, mu,
                          dtype=jnp.float32)
    u = jnp.asarray(np.random.default_rng(0).standard_normal(st.ndof),
                    jnp.float32)
    return st, u


def bench_stencil_matvecs(n=80, iters=30):
    """Seconds per f32 stencil matvec on an n^3 hex8 box for the matmul
    schedule (structured.matvec, which every solver runs) and the planes
    schedule (structured.matvec_planes); returns ({schedule: s}, ndof)."""
    from fem_tpu.ops import structured

    st, u = _stencil_f32(n)
    return {name: _time_call(jax.jit(f), st, u, iters=iters)
            for name, f in (("matmul", structured.matvec),
                            ("planes", structured.matvec_planes))}, st.ndof


def bench_big_solve(device=None):
    """1.59M-DOF hex8 cube (n=80), stencil operator + geometric multigrid +
    mixed-precision iterative refinement to 1e-9 relative residual (f64
    outer, f32 inner). The inner solver is cg.ir_pcg_chunked: `chunk`
    complete MG-CG iterations fused into one jitted dispatch. The reference
    solves the same class of problem with MUMPS' distributed f64 LU
    (main.F90:354-390).
    """
    from fem_tpu.io import meshgen
    from fem_tpu.models.system import System
    from fem_tpu.ops import structured
    from fem_tpu.ops.stiffness import lame
    from fem_tpu.solver import cg, multigrid

    device = device or jax.devices()[0]
    n = int(os.environ.get("FEM_TPU_BENCH_N", "80"))
    chunk = int(os.environ.get("FEM_TPU_BENCH_CHUNK", "4"))
    # A/B knobs (defaults = production schedule): MG smoother, Chebyshev
    # degree, Chebyshev interval lower bound lambda_max/lb, and gamma=2
    # W-cycles.
    smoother = os.environ.get("FEM_TPU_BENCH_SMOOTHER", "chebyshev")
    degree = int(os.environ.get("FEM_TPU_BENCH_DEG", "3"))
    cheb_lb = float(os.environ.get("FEM_TPU_BENCH_CHEB_LB", "30"))
    gamma = int(os.environ.get("FEM_TPU_BENCH_GAMMA", "1"))
    adapt = os.environ.get("FEM_TPU_BENCH_ADAPT", "0") == "1"
    # Setup runs on the CPU backend; its results move to the device once.
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        problem = meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0,
                                          E=200e9, nu=0.3, tip_load=-1e6)
        system = System(problem, dtype=jnp.float64)
        ndof = system.ndof
        log(f"big solve: {problem.nels} hex8 elements, {ndof} dofs")
        lam, mu = lame(jnp.asarray(200e9), jnp.asarray(0.3))
        op64 = structured.build((1.0 / n,) * 3, (n + 1,) * 3, lam, mu)
        op32 = op64.astype(jnp.float32)
        F = system.rhs(0.0)
        hier32 = multigrid.build(op32, system.bc_dofs, smoother=smoother,
                                 degree=degree, lb_frac=cheb_lb,
                                 gamma=gamma)
        bc_mask = jnp.zeros(system.ndof, bool).at[system.bc_dofs].set(True)
        mf32 = jnp.asarray(bc_mask, jnp.float32)
        ubc = jnp.zeros(system.ndof).at[system.bc_dofs].set(
            system.bc_step_vals()
        )
    op64, op32, F, hier32, bc_mask, mf32, ubc = jax.device_put(
        (op64, op32, F, hier32, bc_mask, mf32, ubc), device
    )
    log("big solve: setup done (CPU), arrays on device")

    # GRID-shaped state throughout (structured.matvec_g)
    gsh = (n + 1, n + 1, n + 1, 3)
    mf32_g = mf32.reshape(gsh)
    mf64_g = jax.device_put(bc_mask.astype(jnp.float64).reshape(gsh), device)
    ubc_g = ubc.reshape(gsh)
    F_g = F.reshape(gsh)

    def A32(ops, v):
        op32_, _ = ops
        keep = 1.0 - mf32_g
        return structured.matvec_g(op32_, v * keep) * keep + v * mf32_g

    def M32(ops, r):
        _, h32_ = ops
        return multigrid.v_cycle_g(h32_, r)

    @jax.jit
    def make_b(op64, F_g, ubc_g):
        keep = 1.0 - mf64_g
        return (F_g - structured.matvec_g(op64, ubc_g)) * keep + ubc_g * mf64_g

    b64_g = make_b(op64, F_g, ubc_g)  # constant across refinement cycles

    @jax.jit
    def true_resid(op64, b64_g, xg):
        keep = 1.0 - mf64_g
        ax = structured.matvec_g(op64, xg * keep) * keep + xg * mf64_g
        r = b64_g - ax
        return r, r.astype(jnp.float32), jnp.sqrt(jnp.sum(r * r))

    def _tr_spec(xg):
        _, r32, rn_dev = true_resid(op64, b64_g, xg)
        return r32, rn_dev

    def _combine(xg, dx32):
        return ((xg + dx32.astype(jnp.float64)) * (1.0 - mf64_g)
                + ubc_g * mf64_g)

    def solve():
        x, inner_total, rel = cg.ir_pcg_chunked(
            _tr_spec, _combine, A32, M32, (op32, hier32), ubc_g,
            rtol=1e-9, maxcycles=8, maxiter=80, chunk=chunk, adapt=adapt)
        jax.block_until_ready(x)
        return x, inner_total, rel

    t0 = time.perf_counter()
    solve()  # compile + run
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, inner_total, rel = solve()
    dt = time.perf_counter() - t0
    rec = {
        "metric": "mg_ir_solve_wall_1e-9", "value": dt, "unit": "s",
        "ndof": ndof, "inner_iters": inner_total,
        "rel_residual": float(rel), "cold_s": cold,
        "config": f"{smoother}{degree}/chunk{chunk}"
                  + (f"/lb{cheb_lb:g}" if cheb_lb != 30.0 else "")
                  + ("/W" if gamma >= 2 else "")
                  + ("/adapt" if adapt else ""),
    }
    log(json.dumps(rec))
    return rec


def bench_amg_solve(n=None, device=None):
    """Geometric-lattice or smoothed-aggregation AMG + f64/f32 iterative
    refinement on a JITTERED (non-box) hex mesh — the unstructured half of
    the MUMPS role (main.F90:354-390 handles any mesh). Default n=55 ->
    527k dofs; FEM_TPU_BENCH_AMG_N=70 gives 1.07M dofs."""
    n = int(os.environ.get("FEM_TPU_BENCH_AMG_N", n or 55))

    from fem_tpu.io import meshgen
    from fem_tpu.models.system import System
    from fem_tpu.ops import blockstencil as bs
    from fem_tpu.ops import operator as op_mod
    from fem_tpu.solver import amg, cg, gmg

    device = device or jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        p = meshgen.hex_box_problem(n, n, n, lx=1.0, ly=1.0, lz=1.0,
                                    E=200e9, nu=0.3, tip_load=-1e6,
                                    jitter=0.25)
        s = System(p, dtype=jnp.float64)
        log(f"amg solve: jittered mesh {p.nels} hex8, ndof={s.ndof}")
        A_csr = amg.assemble_csr(s)
        # Operator tier (ops/blockstencil.py): the jittered box is
        # geometrically unstructured but its TOPOLOGY is a lattice, so the
        # fine matvec runs as a variable-coefficient 27-point block stencil
        # (static shifted slices, zero gathers) instead of the fused
        # gather schedule. FEM_TPU_AMG_NO_STENCIL=1 forces the general
        # gather path.
        dims = None
        if os.environ.get("FEM_TPU_AMG_NO_STENCIL", "0") != "1":
            dims = bs.detect(A_csr, s.pdim, s.nnds)
        amg_lb = float(os.environ.get("FEM_TPU_BENCH_CHEB_LB", "30"))
        h32 = None
        pc_kind = "sa-amg"
        if (dims is not None
                and os.environ.get("FEM_TPU_NO_GMG", "0") != "1"):
            # grid-state geometric MG, every level gather-free (the
            # stepper's choice); SA-AMG when it declines
            h32 = gmg.build_lattice(A_csr, s.pdim, dims,
                                    bc_dofs=s.bc_dofs,
                                    dtype=jnp.float32, lb_frac=amg_lb)
            if h32 is not None:
                pc_kind = "gmg"
        if h32 is None:
            # coarse_max=20000: stop at the first aggressive-coarsening
            # level, dense inverse there
            h32 = amg.build(s, s.bc_dofs, A=A_csr,
                            coarse_max=20000).astype(jnp.float32)
        if dims is not None:
            # raw-matrix blocks + external float masks: same semantics as
            # the fused path, and the BC-column couplings stay available
            # for prescribed-displacement lifts
            op64 = bs.build(A_csr, s.pdim, dims)
            op32 = op64.astype(jnp.float32)
            op_kind = "blockstencil"
            mv_cm = bs.matvec_cm
        else:
            op64 = op_mod.build(s)
            op32 = op64.astype(jnp.float32)
            op_kind = "fused-gather"
            mv_cm = op_mod.matvec_cm
        # A_csr stays alive until the GMG solve is validated finite: the
        # fallback rebuild would otherwise re-assemble the CSR from scratch
        log(f"amg solve: fine operator = {op_kind}")
        bc_mask = jnp.zeros(s.ndof, bool).at[s.bc_dofs].set(True)
        mf32 = jnp.asarray(bc_mask, jnp.float32)
        mf64 = jnp.asarray(bc_mask, jnp.float64)
        F = s.rhs(0.0)
        # COMPONENT-MAJOR state precomputed eagerly
        nnds = s.ndof // s.pdim
        mf32_cm = jnp.asarray(np.asarray(mf32).reshape(nnds, s.pdim).T)
        mf64_cm = jnp.asarray(np.asarray(mf64).reshape(nnds, s.pdim).T)
        F_cm = jnp.asarray(np.asarray(F).reshape(nnds, s.pdim).T)
    if pc_kind == "gmg":
        # GRID-SHAPED state (pdim, *dims) end-to-end (stepper._gmg_mv_g)
        gshape = (s.pdim,) + tuple(dims)
        with jax.default_device(cpu):
            mf32_cm = mf32_cm.reshape(gshape)
            mf64_cm = mf64_cm.reshape(gshape)
            F_cm = F_cm.reshape(gshape)
        mv_cm = bs.matvec_g
    op64, op32, h32, mf32_cm, mf64_cm, F_cm = jax.device_put(
        (op64, op32, h32, mf32_cm, mf64_cm, F_cm), device)

    def mv32(ops, v):
        o = ops[0]
        keep = 1.0 - mf32_cm
        return mv_cm(o, v * keep) * keep + v * mf32_cm

    def pc32(ops, r):
        o, hh = ops
        keep = 1.0 - mf32_cm

        def fine_mv(v):
            return mv_cm(o, v * keep) * keep + v * mf32_cm

        if isinstance(hh, gmg.GMGPrecond):
            return gmg.v_cycle_g(hh, fine_mv, r)
        return amg.v_cycle_cm(hh, fine_mv, r)

    @jax.jit
    def true_resid(fop, Fv, mf, x2):
        keep = 1.0 - mf
        ax = mv_cm(fop, x2 * keep) * keep + x2 * mf
        r = Fv * keep - ax
        return r, r.astype(jnp.float32), jnp.sqrt(jnp.sum(r * r))

    def solve():
        def _tr(x2):
            _, r32, rn_dev = true_resid(op64, F_cm, mf64_cm, x2)
            return r32, rn_dev

        def _comb(x2, dx32):
            return x2 + dx32.astype(jnp.float64) * (1.0 - mf64_cm)

        x, inner, rel = cg.ir_pcg_chunked(
            _tr, _comb, mv32, pc32, (op32, h32),
            jnp.zeros_like(F_cm, dtype=jnp.float64),
            rtol=1e-9, maxcycles=6, maxiter=120, chunk=4, adapt=True)
        jax.block_until_ready(x)
        return x, inner, rel

    t0 = time.perf_counter()
    x, inner, rel = solve()
    cold = time.perf_counter() - t0
    # GMG acceptance test: a clean GMG solve at these sizes takes <=~32
    # inner iterations; treat NaN OR an iteration blowup as a broken cycle
    # and demote to SA-AMG.
    gmg_bad = pc_kind == "gmg" and (
        not np.isfinite(rel) or inner > 100)
    if gmg_bad:
        # Rebuild with the gather-based SA-AMG hierarchy and rerun. pc32
        # dispatches on the hierarchy type, so only the operand changes.
        # The cm reshapes go through HOST copies: default_device does not
        # apply to committed arrays. Exercised by
        # tests/test_bench_fallback.py.
        log(f"amg solve: GMG solve {'non-finite' if not np.isfinite(rel) else f'degraded ({inner} inner its)'} -> SA-AMG fallback")
        pc_kind = "sa-amg-fallback"
        nnds_ = s.ndof // s.pdim
        with jax.default_device(cpu):
            mf32_cm = jnp.asarray(
                np.asarray(jax.device_get(mf32_cm)).reshape(s.pdim, nnds_))
            mf64_cm = jnp.asarray(
                np.asarray(jax.device_get(mf64_cm)).reshape(s.pdim, nnds_))
            F_cm = jnp.asarray(
                np.asarray(jax.device_get(F_cm)).reshape(s.pdim, nnds_))
            h32 = amg.build(s, s.bc_dofs, A=A_csr,
                            coarse_max=20000).astype(jnp.float32)
        mv_cm = bs.matvec_cm
        h32, mf32_cm, mf64_cm, F_cm = jax.device_put(
            (h32, mf32_cm, mf64_cm, F_cm), device)
        t0 = time.perf_counter()
        x, inner, rel = solve()
        cold = time.perf_counter() - t0
    del A_csr
    t0 = time.perf_counter()
    x, inner, rel = solve()
    dt = time.perf_counter() - t0
    rec = {"metric": "amg_ir_solve_wall_1e-9", "value": dt,
           "unit": "s", "ndof": s.ndof, "inner_iters": inner,
           "rel_residual": rel, "cold_s": cold,
           "operator": op_kind, "precond": pc_kind}
    log(json.dumps(rec))
    return rec


def bench_cohesive_solve(nx=None, ny_half=None):
    """Cohesive-interface instability deck at scale through the matrix-free
    Newton–Krylov path (BASELINE.json configs[3]; the reference's canonical
    run IS the cohesive deck under SNES, main.F90:199-248). A >=100k-dof
    two-block strip is pulled past the Xu–Needleman traction peak
    (open_disp = 1.5 delta_n), so the run crosses the softening
    instability: the inner solves are f32 chunked AMG-CG
    (newton._mf_jac_mv) with the f64 outer residual/line search, and
    indefinite-tangent steps exercise the GMRES fallback. Wall time is the
    steady (second) run; Newton iterations and fallback counts are recorded.
    """
    from fem_tpu.config import Config
    from fem_tpu.io import meshgen
    from fem_tpu.solver import stepper

    nx = int(os.environ.get("FEM_TPU_BENCH_COH_NX", nx or 360))
    ny_half = int(os.environ.get("FEM_TPU_BENCH_COH_NY", ny_half or 72))
    p = meshgen.cohesive_interface_problem(
        nx, ny_half, lx=5.0, ly_half=1.0, E=3640.0,
        open_disp=0.015, t=1.0, dt=0.5,
        coh_props=(100.0, 0.01, 0.01, 1.0, 0.0, 0.0),
    )
    log(f"cohesive solve: {p.nnds} nodes, {p.ndof} dofs, "
        f"{p.blocks['coh'].ne} interface elements, {p.nsteps} steps")
    cfg = Config(solver="cg")

    def once():
        t0 = time.perf_counter()
        res = stepper.run(p, cfg, log=lambda m: log(f"  coh: {m}"))
        return res, time.perf_counter() - t0

    _, cold = once()
    res, dtw = once()
    rec = {
        "metric": "cohesive_newton_solve_wall", "value": dtw,
        "unit": "s", "ndof": p.ndof, "nsteps": res.nsteps,
        "newton_iters": int(sum(res.newton_iters)),
        "inner_cg_iters": int(sum(res.krylov_iters)),
        "gmres_fallbacks": int(sum(res.gmres_fallbacks)),
        # pure Newton time within the wall (setup = System build + stress
        # recovery + rhs is the rest)
        "newton_s": res.timers.totals.get("newton", 0.0),
        "cold_s": cold,
    }
    log(json.dumps(rec))
    return rec


def bench_operators(n=64, iters=30):
    """Matvec throughput of the ops that dominate solves: the structured
    stencil matvec (matmul and planes schedules) and the fused unstructured
    matvec, all f32. Reports GFLOP/s and effective bytes/s (the schedule's
    minimum traffic over the measured time); records go to stderr."""
    from fem_tpu.io import meshgen
    from fem_tpu.models.system import System
    from fem_tpu.ops import operator as op_mod
    from fem_tpu.ops import structured

    st, u = _stencil_f32(n)
    rng = np.random.default_rng(0)
    flops_stencil = 2 * n ** 3 * 24 * 24  # k_e-apply flops per matvec

    def rec_for(metric, dt, flops, bytes_min, ndof, note):
        return {"metric": metric, "value": flops / dt / 1e9,
                "unit": "GFLOP/s", "ndof": ndof, "ms": dt * 1e3,
                "eff_GBps": bytes_min / dt / 1e9, "note": note}

    recs = []
    # stencil matmul: materializes the (ne, 24) corner gather and the
    # (ne, 24) element forces, plus the vector read/write
    dt = _time_call(jax.jit(structured.matvec), st, u, iters=iters)
    recs.append(rec_for("matvec_stencil_matmul", dt, flops_stencil,
                        (2 * n ** 3 * 24 + 2 * st.ndof) * 4, st.ndof,
                        "gather+force intermediates counted"))
    # planes: fully fused elementwise stencil — traffic is just u + out
    dt = _time_call(jax.jit(structured.matvec_planes), st, u, iters=iters)
    recs.append(rec_for("matvec_stencil_planes", dt, flops_stencil,
                        2 * st.ndof * 4, st.ndof, "vector in+out"))

    # fused unstructured operator on a jittered (non-box) mesh
    nj = max(n // 2, 8)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        p = meshgen.hex_box_problem(nj, nj, nj, lx=1.0, ly=1.0, lz=1.0,
                                    jitter=0.25)
        s = System(p, dtype=jnp.float32)
        fop = op_mod.build(s)
        uj = jnp.asarray(rng.standard_normal(s.ndof), jnp.float32)
    dev = jax.devices()[0]
    fop, uj = jax.device_put((fop, uj), dev)
    flops_fused = 2 * nj ** 3 * 24 * 24
    # per matvec the fused schedule streams every operator coefficient
    # (dNx, scale, lam, mu), the gather/scatter index tables, the per-block
    # force intermediate (written + re-gathered), and the vectors
    op_bytes = sum(
        b.dNx.nbytes + b.scale.nbytes + b.lam.nbytes + b.mu.nbytes
        + b.conn_t.nbytes
        for b in fop.blocks
    ) + sum(a.nbytes + e.nbytes for a, e in zip(fop.row_a, fop.row_e))
    force_bytes = 2 * sum(
        b.dNx.shape[1] * b.dNx.shape[2] * (b.dNx.shape[3] + 1) * 4
        for b in fop.blocks
    )
    bytes_fused = op_bytes + force_bytes + 2 * s.ndof * 4
    dt = _time_call(jax.jit(op_mod.matvec), fop, uj, iters=iters)
    recs.append(rec_for("matvec_fused_unstructured", dt, flops_fused,
                        bytes_fused, s.ndof,
                        "coefficients+indices+force intermediates"))
    # component-major schedule (the production layout inside solvers)
    uj_cm = jax.device_put(uj.reshape(s.ndof // s.pdim, s.pdim).T, dev)
    dt = _time_call(jax.jit(op_mod.matvec_cm), fop, uj_cm, iters=iters)
    recs.append(rec_for("matvec_fused_cm", dt, flops_fused,
                        bytes_fused, s.ndof,
                        "coefficients+indices+force intermediates"))
    for rec in recs:
        log(json.dumps(rec))
    return recs


def main():
    dev = require_gpu()
    from fem_tpu.utils import jaxcache

    jaxcache.enable()
    baseline, how = measure_reference_baseline()
    log(f"reference 64-core baseline: {baseline:.3e} elems/sec ({how})")
    ne_rate, per_iter = bench_element_stiffness()
    log(f"hex8 stiffness (XLA): {ne_rate:.3e} elems/sec "
        f"({per_iter * 1e3:.3f} ms/iter)")
    print(json.dumps({
        "metric": "hex8_element_stiffness_throughput",
        "value": ne_rate, "unit": "elems/sec",
        "vs_baseline": ne_rate / baseline,
        "device": device_record(dev),
    }), flush=True)
    bench_operators()
    bench_big_solve(dev)
    bench_amg_solve(device=dev)
    bench_cohesive_solve()
    log(f"bench complete at {time.time() - _T0:.1f}s")


if __name__ == "__main__":
    main()
