"""Smoothed-aggregation AMG preconditioner for unstructured meshes.

The reference solves ANY mesh with MUMPS' distributed sparse direct LU
(main.F90:354-390) — mesh topology never matters because factorization is
general. The equivalent here for *structured* boxes is the
geometric multigrid in solver/multigrid.py; this module covers the rest of
MUMPS' role: large UNSTRUCTURED meshes, where geometric coarsening does not
exist. Smoothed aggregation (Vanek/Mandel/Brezina '96) builds the hierarchy
algebraically from the assembled matrix and the elastic rigid-body modes.

Division of labor:
  - SETUP runs on the HOST in scipy/numpy: sparse assembly, strength graph,
    greedy aggregation, per-aggregate rank-revealing QR of the rigid-body
    modes, prolongator smoothing, Galerkin triple products, spectral-radius
    power iteration. This mirrors the framework-wide rule that irregular,
    data-dependent index work is host-side setup (SURVEY.md §2c: MPI_Bcast
    sites become host setup + device_put).
  - The CYCLE runs on DEVICE as one jittable program: Chebyshev polynomial
    smoothing (matvec-only, no data-dependent control flow), ELL-format
    coarse matvecs (fixed-width gather + sum — static shapes for XLA),
    segment-sum restriction, gather prolongation, dense coarsest inverse.

The preconditioner is symmetric positive definite (same-degree Chebyshev
pre/post smoothing, adjoint transfers, Galerkin coarse operators), so it is
a valid CG preconditioner. BC dofs are eliminated before setup (identity
rows/cols) to match solver/cg.masked_operator's fine-level convention.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Host-side setup
# ---------------------------------------------------------------------------


def assemble_csr(system, dtype=np.float64):
    """Assemble the elastic stiffness as a scipy CSR matrix on the host.

    Element matrices come from the same batched kernels the device uses
    (ops/stiffness.element_stiffness_lame), evaluated on the CPU backend.
    Replaces the reference's MatSetValues/MatAssembly scatter
    (main.F90:157-171).

    The assembly runs at NODE-BLOCK granularity rather than scalar dofs:
    elasticity couples full pdim x pdim blocks per node pair, so sorting
    node-pair codes touches pdim^2 (4-9x) fewer indices than scipy's
    scalar COO->CSR, and the duplicate blocks collapse in one vectorized
    np.add.reduceat. The block rows then expand to scalar CSR through
    scipy's native bsr_tocsr (at 527k dofs: 166k hex8, 95.8M scalar nnz).
    """
    import scipy.sparse as sp

    from fem_tpu.ops import stiffness as stiff_ops

    cpu = jax.devices("cpu")[0]
    pdim = system.pdim
    nnds = system.ndof // pdim
    brows: List[np.ndarray] = []
    bcols: List[np.ndarray] = []
    blocks: List[np.ndarray] = []
    with jax.default_device(cpu):
        for name, e in system.blocks.items():
            if e["is_coh"]:
                continue
            et = e["et"]
            ec = jnp.asarray(np.asarray(e["ecoords"], dtype=dtype))
            lam, mu = stiff_ops.lame(
                jnp.asarray(np.asarray(e["E"], dtype=dtype)),
                jnp.asarray(np.asarray(e["nu"], dtype=dtype)),
            )
            ke = np.asarray(
                stiff_ops.element_stiffness_lame(et, ec, lam, mu)
            ).astype(dtype, copy=False)
            conn = np.asarray(e["conn"], dtype=np.int64)  # (ne, nn)
            ne, nn = conn.shape
            # ke is interleaved node-major ((n0_x, n0_y, ...), element_dofs)
            # -> (ne, nn, nn, pdim, pdim) node-pair blocks
            kb = ke.reshape(ne, nn, pdim, nn, pdim).transpose(0, 1, 3, 2, 4)
            brows.append(
                np.broadcast_to(conn[:, :, None], (ne, nn, nn)).reshape(-1))
            bcols.append(
                np.broadcast_to(conn[:, None, :], (ne, nn, nn)).reshape(-1))
            blocks.append(np.ascontiguousarray(kb).reshape(-1, pdim, pdim))
    codes = np.concatenate(brows) * nnds + np.concatenate(bcols)
    del brows, bcols
    blk = blocks[0] if len(blocks) == 1 else np.concatenate(blocks)
    del blocks
    order = np.argsort(codes, kind="stable")  # radix sort on int64 codes
    codes = codes[order]
    starts = np.flatnonzero(np.r_[True, codes[1:] != codes[:-1]])
    ublk = np.add.reduceat(blk[order], starts, axis=0)
    del blk, order
    ucodes = codes[starts]
    urows = ucodes // nnds
    ucols = (ucodes % nnds).astype(np.int32)
    indptr = np.zeros(nnds + 1, dtype=np.int64)
    np.cumsum(np.bincount(urows, minlength=nnds), out=indptr[1:])
    n = system.ndof
    A = sp.bsr_matrix((ublk, ucols, indptr), shape=(n, n),
                      blocksize=(pdim, pdim))
    return A.tocsr()


def _eliminate_bcs(A, bc_dofs):
    """Zero constrained rows/cols, unit diagonal (cg.masked_operator form)."""
    import scipy.sparse as sp

    n = A.shape[0]
    keep = np.ones(n)
    keep[bc_dofs] = 0.0
    D = sp.diags(keep)
    ones = sp.coo_matrix(
        (np.ones(len(bc_dofs)), (bc_dofs, bc_dofs)), shape=(n, n)
    )
    A = (D @ A @ D + ones).tocsr()
    A.sum_duplicates()
    return A


def rigid_body_modes(coords, pdim, bc_dofs=None):
    """Near-nullspace B (ndof x nb): translations + rotations, zeroed on
    constrained dofs. nb = 3 (2D) or 6 (3D)."""
    nn = coords.shape[0]
    x = coords[:, 0]
    y = coords[:, 1]
    if pdim == 2:
        B = np.zeros((nn * 2, 3))
        B[0::2, 0] = 1.0
        B[1::2, 1] = 1.0
        B[0::2, 2] = -y
        B[1::2, 2] = x
    else:
        z = coords[:, 2]
        B = np.zeros((nn * 3, 6))
        for d in range(3):
            B[d::3, d] = 1.0
        B[0::3, 3] = -y
        B[1::3, 3] = x
        B[1::3, 4] = -z
        B[2::3, 4] = y
        B[0::3, 5] = z
        B[2::3, 5] = -x
    if bc_dofs is not None and len(bc_dofs):
        B[np.asarray(bc_dofs)] = 0.0
    return B


def _node_graph(A, dof_node, nnodes):
    """Condense |A| onto the node partition given by dof_node (len ndof)."""
    import scipy.sparse as sp

    n = A.shape[0]
    R = sp.csr_matrix(
        (np.ones(n), (dof_node, np.arange(n))), shape=(nnodes, n)
    )
    N = R @ abs(A) @ R.T
    N = N.tocsr()
    N.setdiag(0.0)
    N.eliminate_zeros()
    return N


def _aggregate(N):
    """Standard greedy aggregation on the node graph N (CSR, no diagonal).

    Three passes (Vanek et al.): (1) a node whose neighborhood is untouched
    seeds an aggregate with all its neighbors; (2) leftover nodes join the
    neighboring aggregate with the strongest connection; (3) remaining
    connected leftovers seed aggregates from what is left. Isolated nodes
    (e.g. fully constrained: their matrix rows are identity) stay
    unaggregated and carry no coarse dofs.
    """
    n = N.shape[0]
    indptr, indices, data = N.indptr, N.indices, N.data
    agg = np.full(n, -1, dtype=np.int64)
    # -2 marks "adjacent to an aggregate" (not a seed candidate in pass 1)
    na = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if len(nbrs) == 0:
            continue  # isolated
        if np.all(agg[nbrs] == -1):
            agg[i] = na
            agg[nbrs] = na
            na += 1
    # pass 2: join strongest neighboring aggregate
    unassigned = np.nonzero(agg == -1)[0]
    joined = agg.copy()
    for i in unassigned:
        lo, hi = indptr[i], indptr[i + 1]
        nbrs = indices[lo:hi]
        w = data[lo:hi]
        mask = agg[nbrs] >= 0
        if np.any(mask):
            joined[i] = agg[nbrs[mask][np.argmax(w[mask])]]
    agg = joined
    # pass 3: aggregate the remaining connected nodes among themselves
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if len(nbrs) == 0:
            continue
        agg[i] = na
        free = nbrs[agg[nbrs] == -1]
        agg[free] = na
        na += 1
    return agg, na


def _tentative(agg, naggs, dof_node, B):
    """Tentative prolongator + coarse candidate modes via per-aggregate
    rank-revealing QR of B. Returns (P0 csr, B_c, dof_node_c)."""
    import scipy.linalg as sla
    import scipy.sparse as sp

    ndof = B.shape[0]
    nb = B.shape[1]
    dof_agg = np.where(dof_node >= 0, agg[dof_node], -1)
    order = np.argsort(dof_agg, kind="stable")
    sorted_agg = dof_agg[order]
    start = np.searchsorted(sorted_agg, np.arange(naggs), side="left")
    end = np.searchsorted(sorted_agg, np.arange(naggs), side="right")

    rowsP: List[np.ndarray] = []
    colsP: List[np.ndarray] = []
    valsP: List[np.ndarray] = []
    Bc_rows: List[np.ndarray] = []
    dof_node_c: List[np.ndarray] = []
    nc = 0
    for g in range(naggs):
        idx = order[start[g]:end[g]]
        if len(idx) == 0:
            continue
        Bg = B[idx]  # (m, nb)
        if not np.any(Bg):
            continue
        Q, R, piv = sla.qr(Bg, mode="economic", pivoting=True)
        d = np.abs(np.diag(R))
        if d.size == 0 or d[0] == 0.0:
            continue
        rank = int(np.sum(d > max(Bg.shape) * np.finfo(float).eps * d[0]))
        if rank == 0:
            continue
        Qg = Q[:, :rank]  # (m, rank)
        rowsP.append(np.repeat(idx, rank))
        colsP.append(np.tile(nc + np.arange(rank), len(idx)))
        valsP.append(Qg.reshape(-1))
        Bc_rows.append(Qg.T @ Bg)  # (rank, nb)
        dof_node_c.append(np.full(rank, g, dtype=np.int64))
        nc += rank
    if not rowsP:
        return sp.csr_matrix((ndof, 0)), np.zeros((0, nb)), np.zeros(0, np.int64)
    P0 = sp.csr_matrix(
        (np.concatenate(valsP), (np.concatenate(rowsP), np.concatenate(colsP))),
        shape=(ndof, nc),
    )
    B_c = np.vstack(Bc_rows) if Bc_rows else np.zeros((0, nb))
    return P0, B_c, np.concatenate(dof_node_c) if dof_node_c else np.zeros(0, np.int64)


def _empty_bt(np_dtype):
    zi = lambda *s: jnp.asarray(np.zeros(s, dtype=np.int32))  # noqa: E731
    zf = lambda *s: jnp.asarray(np.zeros(s, dtype=np_dtype))  # noqa: E731
    return dict(
        bt_kg=zi(2, 0), bt_pad_map=zi(0, 0), bt_p_aggs=zi(0, 0),
        bt_p_vals=zf(0, 0, 0, 0), bt_r_nodes=zi(0, 0),
        bt_r_vals=zf(0, 0, 0, 0),
    )


def _block_transfer_tables(P, dof_node_c, pdim, nb, nnodes, naggs):
    """Node x aggregate BLOCK layout of the smoothed prolongator, for the
    component-major transfer kernels (fine level only).

    P couples fine NODES (pdim rows each) to AGGREGATES (<= nb contiguous
    coarse dofs each). Scalar-dof forms of P@xc / P^T@r cost 25M/14M gather
    indices at 527k dofs; the block forms gather one pdim- or nb-wide ROW
    per (node,
    aggregate) pair instead — ~10x fewer indices, lanes-major results.

    Returns numpy tables:
      k_of_dof, g_of_dof: (nc,) position-in-aggregate / aggregate of each
        coarse dof (aggregate dof ranges are contiguous by construction).
      pad_map: (nb, naggs + 1) coarse-dof index or nc (zero slot); last
        aggregate column is all-zero padding.
      p_aggs: (Kp, nnodes) aggregate ids per node (pad: naggs).
      p_vals: (pdim, Kp, nb, nnodes) P block values.
      r_nodes: (Ka, naggs) contributing node ids per aggregate (pad: nnodes).
      r_vals: (nb, pdim, Ka, naggs) P^T block values.
    """
    Pc = P.tocoo()
    rows, cols, vals = Pc.row, Pc.col, Pc.data
    nc = P.shape[1]
    g_of_dof = np.asarray(dof_node_c, dtype=np.int64)
    # contiguous position within the aggregate
    cstart = np.zeros(naggs + 1, dtype=np.int64)
    np.add.at(cstart, g_of_dof + 1, 1)
    np.cumsum(cstart, out=cstart)
    k_of_dof = np.arange(nc) - cstart[g_of_dof]

    pad_map = np.full((nb, naggs + 1), nc, dtype=np.int64)
    pad_map[k_of_dof, g_of_dof] = np.arange(nc)

    node = rows // pdim
    p_comp = rows % pdim
    g_ent = g_of_dof[cols]
    k_ent = k_of_dof[cols]

    # unique (node, aggregate) pairs -> slot within node, slot within agg
    key = node * np.int64(naggs) + g_ent
    ukey, inv = np.unique(key, return_inverse=True)
    unode = (ukey // naggs).astype(np.int64)
    uagg = (ukey % naggs).astype(np.int64)

    def slots(ids, nseg):
        """per-pair slot index within its segment + segment table."""
        order = np.argsort(ids, kind="stable")
        counts = np.bincount(ids, minlength=nseg)
        K = int(counts.max()) if len(ids) else 1
        starts = np.zeros(nseg + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.empty(len(ids), dtype=np.int64)
        slot[order] = np.arange(len(ids)) - starts[ids[order]]
        return slot, K

    p_slot, Kp = slots(unode, nnodes)
    r_slot, Ka = slots(uagg, naggs)

    p_aggs = np.full((Kp, nnodes), naggs, dtype=np.int64)
    p_aggs[p_slot, unode] = uagg
    r_nodes = np.full((Ka, naggs), nnodes, dtype=np.int64)
    r_nodes[r_slot, uagg] = unode

    p_vals = np.zeros((pdim, Kp, nb, nnodes))
    p_vals[p_comp, p_slot[inv], k_ent, node] = vals
    r_vals = np.zeros((nb, pdim, Ka, naggs))
    r_vals[k_ent, p_comp, r_slot[inv], g_ent] = vals
    return (k_of_dof, g_of_dof, pad_map, p_aggs, p_vals, r_nodes, r_vals,
            Kp, Ka)


def _lambda_max(A, dinv, iters=30, seed=0):
    """Power-iteration estimate of lambda_max(D^-1 A), with 10% headroom."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(A.shape[0])
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(iters):
        y = dinv * (A @ x)
        ny = np.linalg.norm(y)
        if ny == 0.0:
            return 1.0
        lam = ny
        x = y / ny
    return float(lam)


@jax.jit
def _chol_inv_blocked_jit(S):
    """S^-1 for large equilibrated SPD S: Cholesky + BLOCKED triangular
    inverse + one Newton-Schulz polish.

    Same math as _chol_inv_jit, different lowering: XLA's
    solve_triangular(L, I) at n=18900 rematerializes ~100 GB of
    (k, n) dynamic-update-slice temps and runs out of device memory (a
    1.07M-dof hierarchy). Here the identity RHS is solved in 2048-wide column
    panels with an UNROLLED block forward substitution — (b, b)
    triangular solves plus (b, b) matmuls, live set a few (n, n)
    buffers. (A pure Newton-Schulz inverse was tried and rejected: its
    f32 error floor ~n*eps*cond diverges for cond >= ~1e5, while
    f32 Cholesky is backward-stable to cond ~1e7.)"""
    hi = jax.lax.Precision.HIGHEST
    n = S.shape[0]
    b = 2048
    nb = -(-n // b)
    bounds = [(i * b, min(n, (i + 1) * b)) for i in range(nb)]
    with jax.default_matmul_precision("float32"):
        L = jnp.linalg.cholesky(S)
        Lb = [[L[r0:r1, c0:c1] for (c0, c1) in bounds] for (r0, r1) in bounds]
        panels = []
        for j in range(nb):
            j0, j1 = bounds[j]
            wj = j1 - j0
            Ys = []
            for i in range(nb):
                i0, i1 = bounds[i]
                ri = i1 - i0
                if i < j:
                    Ys.append(jnp.zeros((ri, wj), dtype=S.dtype))
                    continue
                acc = (jnp.eye(ri, wj, dtype=S.dtype) if i == j
                       else jnp.zeros((ri, wj), dtype=S.dtype))
                for k in range(j, i):
                    acc = acc - jnp.matmul(Lb[i][k], Ys[k], precision=hi)
                Ys.append(jax.scipy.linalg.solve_triangular(
                    Lb[i][i], acc, lower=True))
            panels.append(jnp.concatenate(Ys, axis=0))
        Linv = jnp.concatenate(panels, axis=1)
        X = jnp.matmul(Linv.T, Linv, precision=hi)
        eye = jnp.eye(n, dtype=S.dtype)
        X = jnp.matmul(X, 2.0 * eye - jnp.matmul(S, X, precision=hi),
                       precision=hi)
        return 0.5 * (X + X.T)


@jax.jit
def _chol_inv_jit(S):
    """S^-1 for SPD S via Cholesky + one Newton-Schulz polish (device-side).

    Traced under true-f32 matmul precision: reduced-precision (bf16 or
    TF32) passes inside cholesky/solve_triangular would turn the 'exact'
    coarse solve into a ~1e-3 one. The caller passes the diagonally EQUILIBRATED
    operator (f32 Cholesky breaks down around cond ~1e7; equilibration
    strips the diagonal spread), and the Newton-Schulz step
    X <- X(2I - S X) squares the remaining inverse error — two cheap
    matmuls."""
    with jax.default_matmul_precision("float32"):
        L = jnp.linalg.cholesky(S)
        eye = jnp.eye(S.shape[0], dtype=S.dtype)
        Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
        hi = jax.lax.Precision.HIGHEST
        X = jnp.matmul(Linv.T, Linv, precision=hi)
        X = jnp.matmul(X, 2.0 * eye - jnp.matmul(S, X, precision=hi),
                       precision=hi)
        return 0.5 * (X + X.T)


def _dense_inv(Kc):
    """Dense inverse of the coarsest SPD operator.

    A coarse ELL matvec is random gathers (x7 Chebyshev applies per
    cycle), while a dense (n, n) matvec is one streaming pass over memory.
    So production hierarchies stop coarsening at ~20k dofs and apply an
    explicit dense inverse instead of recursing — a two-level method with
    an exact coarse solve, which also upper-bounds the iteration count of
    the deeper hierarchy.  The inverse itself: f32 Cholesky on the
    accelerator for large blocks (8.9e12 flops at 19k), host LAPACK
    otherwise (f32 above 4096: backward-stable, and the production
    hierarchy is cast to f32 anyway).
    """
    import sys
    import time as _time

    n = Kc.shape[0]
    t0 = _time.perf_counter()
    if n >= 8000:
        try:
            dev = jax.devices()[0]
            if dev.platform != "cpu":
                # diagonal equilibration: inv(K) = d * inv(S) * d with
                # S = d K d, d = diag(K)^-1/2 — strips the diagonal spread
                # that pushes f32 Cholesky past breakdown
                d = Kc.diagonal().copy()
                d[d <= 0.0] = 1.0
                d = 1.0 / np.sqrt(d)
                S = (Kc * d[None, :]) * d[:, None]
                A = jax.device_put(jnp.asarray(S.astype(np.float32)), dev)
                del S
                dj = jax.device_put(jnp.asarray(d.astype(np.float32)), dev)
                # monolithic solve_triangular(L, I) OOMs above ~12k
                # (XLA remats ~100 GB of temps at n=18900); big blocks
                # take the panel-blocked route
                inv_jit = _chol_inv_jit if n < 12000 else _chol_inv_blocked_jit
                X = _descale_jit(inv_jit(A), dj)
                # finiteness probe pulls ONE scalar; the (n, n) inverse
                # itself STAYS ON DEVICE
                if bool(jnp.isfinite(jnp.sum(X))):
                    print(
                        f"[amg] dense coarse inverse n={n}: device f32 "
                        f"chol+NS, {_time.perf_counter() - t0:.1f}s",
                        file=sys.stderr, flush=True,
                    )
                    del A
                    return X
                print(f"[amg] device f32 cholesky of n={n} coarse block "
                      "not finite; falling back to host f64 LAPACK",
                      file=sys.stderr, flush=True)
        except Exception as e:
            print(f"[amg] device coarse inverse failed ({e!r}); "
                  "falling back to host f64 LAPACK",
                  file=sys.stderr, flush=True)
    try:
        # SPD fast path: Cholesky-based inverse (potrf+potri) does about
        # half the flops of the LU route np.linalg.inv takes. potri fills
        # only the lower triangle — mirror it in place panel-wise (one
        # whole-matrix tril/transpose temp chain is several n^2 copies).
        from scipy.linalg.lapack import dpotrf, dpotri

        c, info = dpotrf(Kc, lower=1, overwrite_a=0)
        if info == 0:
            x, info2 = dpotri(c, lower=1, overwrite_c=1)
            if info2 == 0:
                bs = 2048
                for j0 in range(0, n, bs):
                    j1 = min(j0 + bs, n)
                    if j0:
                        x[:j0, j0:j1] = x[j0:j1, :j0].T
                    blk = x[j0:j1, j0:j1]
                    lo = np.tril(blk)
                    blk[:] = lo + np.tril(blk, -1).T
                if n >= 4096:
                    print(f"[amg] dense coarse inverse n={n}: host f64 "
                          f"chol, {_time.perf_counter() - t0:.1f}s",
                          file=sys.stderr, flush=True)
                return x  # exactly symmetric by construction
    except Exception:
        pass
    inv = np.linalg.inv(Kc)
    if n >= 4096:
        print(f"[amg] dense coarse inverse n={n}: host f64 LAPACK, "
              f"{_time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
    return 0.5 * (inv + inv.T)


@jax.jit
def _descale_jit(X, d):
    X = (X * d[None, :]) * d[:, None]
    return 0.5 * (X + X.T)


def _to_ell(A, dtype):
    """CSR -> padded ELL (vals (n, w), cols (n, w) int32)."""
    n = A.shape[0]
    counts = np.diff(A.indptr)
    w = int(counts.max()) if n else 0
    vals = np.zeros((n, w), dtype=dtype)
    cols = np.zeros((n, w), dtype=np.int32)
    # vectorized fill: position within row
    pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    rows = np.repeat(np.arange(n), counts)
    vals[rows, pos] = A.data
    cols[rows, pos] = A.indices
    return vals, cols


# ---------------------------------------------------------------------------
# Device-side hierarchy
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AMGLevel:
    # operator in ELL form; EMPTY (0,0) on level 0, where the caller's fine
    # matvec (fused/stencil) is used instead
    ell_vals: jax.Array
    ell_cols: jax.Array
    # densified operator for SMALL mid levels (n <= dense_level_max), else
    # EMPTY (0,0): the w~27 ELL smoother matvec is gather-bound, while a
    # dense matvec is one streaming pass — the same trade that moved the
    # coarsest solve to a dense inverse
    dense_op: jax.Array
    dinv: jax.Array  # (n,) 1/diag (1.0 on constrained dofs)
    # component-major copy (pdim, nnodes) — level 0 only, empty elsewhere.
    # Precomputed eagerly: the (n,) -> (pdim, nnodes) transpose is a full
    # pass over the vector inside a fused program (see operator.matvec_cm).
    dinv_cm: jax.Array
    # prolongator fine<-coarse in ELL over FINE rows; empty on the coarsest
    p_vals: jax.Array
    p_cols: jax.Array
    # restriction = P^T as COO sorted by coarse row (for segment_sum)
    pt_vals: jax.Array
    pt_fine: jax.Array  # fine dof of each nnz
    pt_coarse: jax.Array  # ascending coarse dof of each nnz
    # BLOCK transfer tables (fine level only; empty elsewhere) — see
    # _block_transfer_tables
    bt_kg: jax.Array  # (2, nc) int32: k_of_dof / g_of_dof
    bt_pad_map: jax.Array  # (nb, naggs + 1) int32
    bt_p_aggs: jax.Array  # (Kp, nnodes) int32
    bt_p_vals: jax.Array  # (pdim, Kp, nb, nnodes)
    bt_r_nodes: jax.Array  # (Ka, naggs) int32
    bt_r_vals: jax.Array  # (nb, pdim, Ka, naggs)
    # Chebyshev interval [theta - delta, theta + delta] of D^-1 A
    theta: float = dataclasses.field(metadata=dict(static=True))
    delta: float = dataclasses.field(metadata=dict(static=True))
    n_coarse: int = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AMGPrecond:
    levels: Tuple[AMGLevel, ...]
    coarse_inv: jax.Array  # dense inverse of the coarsest operator
    degree: int = dataclasses.field(default=3, metadata=dict(static=True))

    def astype(self, dtype):
        def cast(x):
            return x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating) else x

        return jax.tree_util.tree_map(cast, self)


def build(
    system,
    bc_dofs,
    coarse_max: int = 1200,
    max_levels: int = 10,
    degree: int = 3,
    dtype=jnp.float64,
    A=None,
    filter_frac: float = 0.0,
    aggressive_threshold: int = 10000,
    dense_level_max: int = 8192,
    lb_frac: float = 30.0,
) -> AMGPrecond:
    """Build the SA-AMG hierarchy for a System's elastic operator (host-side;
    returns a device pytree). `A` may be a pre-assembled scipy CSR (BCs NOT
    yet eliminated) to skip re-assembly."""
    if A is None:
        A = assemble_csr(system)
    bc = np.asarray(bc_dofs)
    A = _eliminate_bcs(A, bc)
    coords = np.asarray(system.problem.coords)
    pdim = system.pdim
    B = rigid_body_modes(coords, pdim, bc)
    ndof = A.shape[0]
    dof_node = np.arange(ndof) // pdim
    nnodes = coords.shape[0]

    np_dtype = np.dtype(jnp.dtype(dtype).name)
    levels: List[AMGLevel] = []
    level_A = A
    while len(levels) < max_levels - 1 and level_A.shape[0] > coarse_max:
        d = level_A.diagonal()
        dinv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
        lam_max = 1.1 * _lambda_max(level_A, dinv)
        N = _node_graph(level_A, dof_node, nnodes)
        if aggressive_threshold and N.shape[0] > aggressive_threshold:
            # aggressive (2-hop) coarsening on large levels: aggregates
            # span the squared graph, shrinking the next level ~5x, so the
            # gather-bound level-1 ELL matvec shrinks with it, at ~20% more
            # CG iterations.
            import scipy.sparse as _sp

            N2 = (N @ N + N).tocsr()
            N2.setdiag(0.0)
            N2.eliminate_zeros()
            N = N2
        agg, naggs = _aggregate(N)
        P0, B_c, dof_node_c = _tentative(agg, naggs, dof_node, B)
        if P0.shape[1] == 0 or P0.shape[1] >= level_A.shape[0]:
            break
        # smoothed prolongator: P = (I - omega D^-1 A) P0
        import scipy.sparse as sp

        omega = (4.0 / 3.0) / lam_max
        # D^-1 A as a direct row scaling of A's data (one vectorized pass
        # instead of a DIA @ CSR sparse product)
        row_of = np.repeat(
            np.arange(level_A.shape[0]), np.diff(level_A.indptr))
        DinvA = sp.csr_matrix(
            (level_A.data * dinv[row_of], level_A.indices, level_A.indptr),
            shape=level_A.shape)
        P = (P0 - omega * (DinvA @ P0)).tocsr()
        P.sum_duplicates()
        if filter_frac > 0.0:
            # optional PyAMG-style prolongator filtering: bounds the
            # coarse operator's row fill (the device-side ELL width) at a
            # convergence cost (measured +30% iterations at 0.02 on a
            # jittered cantilever — default OFF). Each row keeps at least
            # its max-magnitude entry.
            absd = np.abs(P.data)
            rows = np.repeat(np.arange(P.shape[0]), np.diff(P.indptr))
            row_max = np.zeros(P.shape[0])
            np.maximum.at(row_max, rows, absd)
            mask = (absd >= filter_frac * row_max[rows]) | (
                absd >= row_max[rows] * (1.0 - 1e-12)
            )
            P.data = np.where(mask, P.data, 0.0)
            P.eliminate_zeros()
        # Galerkin RAP with an explicit CSR restriction: evaluating
        # P.T @ A @ P directly re-converts the CSC transpose inside each
        # product; A @ P first also keeps the large intermediate's rows
        # CSR-contiguous.
        R = P.T.tocsr()
        A_c = (R @ (level_A @ P)).tocsr()
        A_c.sum_duplicates()

        dense_op = np.zeros((0, 0), dtype=np_dtype)
        if len(levels) == 0:
            ell_vals = np.zeros((0, 0), dtype=np_dtype)
            ell_cols = np.zeros((0, 0), dtype=np.int32)
        elif level_A.shape[0] <= dense_level_max:
            dense_op = level_A.toarray().astype(np_dtype)
            ell_vals = np.zeros((0, 0), dtype=np_dtype)
            ell_cols = np.zeros((0, 0), dtype=np.int32)
        else:
            ell_vals, ell_cols = _to_ell(level_A, np_dtype)
        p_vals, p_cols = _to_ell(P, np_dtype)
        Pc = P.tocoo()
        order = np.argsort(Pc.col, kind="stable")
        # lb_frac=4 narrows the smoothing interval to the upper spectrum
        # (the MG-smoother convention — see multigrid.build's docstring)
        lb = lam_max / lb_frac
        if len(levels) == 0:
            nb_modes = B.shape[1]
            (k_of, g_of, pad_map, p_aggs, pb_vals, r_nodes, rb_vals,
             _, _) = _block_transfer_tables(
                P, dof_node_c, pdim, nb_modes, nnodes, naggs,
            )
            bt = dict(
                bt_kg=jnp.asarray(
                    np.stack([k_of, g_of]).astype(np.int32)),
                bt_pad_map=jnp.asarray(pad_map.astype(np.int32)),
                bt_p_aggs=jnp.asarray(p_aggs.astype(np.int32)),
                bt_p_vals=jnp.asarray(pb_vals.astype(np_dtype)),
                bt_r_nodes=jnp.asarray(r_nodes.astype(np.int32)),
                bt_r_vals=jnp.asarray(rb_vals.astype(np_dtype)),
            )
        else:
            bt = _empty_bt(np_dtype)
        levels.append(
            AMGLevel(
                ell_vals=jnp.asarray(ell_vals),
                ell_cols=jnp.asarray(ell_cols),
                dense_op=jnp.asarray(dense_op),
                dinv=jnp.asarray(dinv.astype(np_dtype)),
                dinv_cm=jnp.asarray(
                    dinv.reshape(-1, pdim).T.astype(np_dtype)
                    if len(levels) == 0
                    else np.zeros((0, 0), dtype=np_dtype)
                ),
                p_vals=jnp.asarray(p_vals),
                p_cols=jnp.asarray(p_cols),
                pt_vals=jnp.asarray(Pc.data[order].astype(np_dtype)),
                pt_fine=jnp.asarray(Pc.row[order].astype(np.int32)),
                pt_coarse=jnp.asarray(Pc.col[order].astype(np.int32)),
                theta=float(0.5 * (lam_max + lb)),
                delta=float(0.5 * (lam_max - lb)),
                n_coarse=int(P.shape[1]),
                **bt,
            )
        )
        level_A = A_c
        B = B_c
        dof_node = dof_node_c
        nnodes = naggs

    # coarsest level: dense inverse
    nc = level_A.shape[0]
    d = level_A.diagonal()
    dinv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
    Kc = level_A.toarray()
    zero_rows = np.abs(Kc).sum(axis=1) == 0.0
    if np.any(zero_rows):
        Kc[zero_rows, zero_rows] = 1.0
    coarse_inv = _dense_inv(Kc)
    del Kc
    empty_f = np.zeros((0, 0), dtype=np_dtype)
    empty_i = np.zeros((0, 0), dtype=np.int32)
    ell_vals, ell_cols = (
        (empty_f, empty_i) if not levels else _to_ell(level_A, np_dtype)
    )
    levels.append(
        AMGLevel(
            ell_vals=jnp.asarray(ell_vals),
            ell_cols=jnp.asarray(ell_cols),
            dense_op=jnp.asarray(np.zeros((0, 0), dtype=np_dtype)),
            dinv=jnp.asarray(dinv.astype(np_dtype)),
            dinv_cm=jnp.asarray(
                dinv.reshape(-1, pdim).T.astype(np_dtype)
                if not levels
                else np.zeros((0, 0), dtype=np_dtype)
            ),
            p_vals=jnp.asarray(empty_f),
            p_cols=jnp.asarray(empty_i),
            pt_vals=jnp.asarray(np.zeros(0, dtype=np_dtype)),
            pt_fine=jnp.asarray(np.zeros(0, dtype=np.int32)),
            pt_coarse=jnp.asarray(np.zeros(0, dtype=np.int32)),
            theta=1.0,
            delta=0.5,
            n_coarse=0,
            **_empty_bt(np_dtype),
        )
    )
    return AMGPrecond(
        levels=tuple(levels),
        # a committed device f32 array from _dense_inv stays as-is (all
        # production hierarchies run f32; upcasting 361+ MB to f64 on
        # device would be pure waste)
        coarse_inv=(coarse_inv if isinstance(coarse_inv, jax.Array)
                    else jnp.asarray(coarse_inv.astype(np_dtype))),
        degree=degree,
    )


# ---------------------------------------------------------------------------
# Device-side cycle (jittable)
# ---------------------------------------------------------------------------


def _ell_matvec(vals, cols, x):
    return jnp.sum(vals * x[cols], axis=1)


def _lv_matvec(lv: "AMGLevel", x):
    """Mid-level operator apply: one dense streaming matmul when the
    level was densified at build time, gather-ELL otherwise."""
    if lv.dense_op.shape[0] > 0:
        return jnp.matmul(lv.dense_op, x,
                          precision=jax.lax.Precision.HIGHEST)
    return _ell_matvec(lv.ell_vals, lv.ell_cols, x)


def _chebyshev(matvec, lv: AMGLevel, x, b, degree: int):
    """Chebyshev polynomial smoothing of D^-1 A on [theta-delta, theta+delta].
    Matvec-only — no data-dependent control flow, ideal under jit."""
    theta, delta = lv.theta, lv.delta
    sigma = theta / delta
    rho = 1.0 / sigma
    r = lv.dinv * (b - matvec(x))
    d = r / theta
    for _ in range(degree - 1):
        x = x + d
        r = r - lv.dinv * matvec(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x + d


def v_cycle(h: AMGPrecond, fine_matvec: Callable, r):
    """One V-cycle; level 0 applies `fine_matvec` (the masked fused/stencil
    operator), deeper levels their ELL matrices."""
    return _v(h, 0, fine_matvec, r)


def _v(h: AMGPrecond, i: int, mv: Callable, r):
    lv = h.levels[i]
    if i == len(h.levels) - 1:
        return jnp.matmul(
            h.coarse_inv, r, precision=jax.lax.Precision.HIGHEST
        )
    x = _chebyshev(mv, lv, jnp.zeros_like(r), r, h.degree)
    res = r - mv(x)
    rc = jax.ops.segment_sum(
        lv.pt_vals * res[lv.pt_fine],
        lv.pt_coarse,
        num_segments=lv.n_coarse,
        indices_are_sorted=True,
    )
    nxt = h.levels[i + 1]
    xc = _v(h, i + 1, lambda v: _lv_matvec(nxt, v), rc)
    x = x + _ell_matvec(lv.p_vals, lv.p_cols, xc)
    return _chebyshev(mv, lv, x, r, h.degree)


def preconditioner(h: AMGPrecond, fine_matvec: Callable) -> Callable:
    return lambda r: v_cycle(h, fine_matvec, r)


# ---------------- component-major fine level ----------------
#
# The fused unstructured matvec is fastest in (pdim, nnds) component-major
# layout (operator.matvec_cm: no per-matvec transposes). This cycle keeps ALL fine-level work component-major and pays
# exactly two layout transposes per cycle, at the coarse-transfer boundary.


def _chebyshev_cm(matvec_cm, lv: AMGLevel, x, b, degree: int):
    theta, delta = lv.theta, lv.delta
    sigma = theta / delta
    rho = 1.0 / sigma
    r = lv.dinv_cm * (b - matvec_cm(x))
    d = r / theta
    for _ in range(degree - 1):
        x = x + d
        r = r - lv.dinv_cm * matvec_cm(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x + d


def _restrict_blk(lv: AMGLevel, res_cm):
    """P^T @ res via the node x aggregate block tables: one (Ka, naggs)
    row-gather + unrolled small-dim FMAs. Returns flat (nc,)."""
    res_pad = jnp.pad(res_cm, ((0, 0), (0, 1)))  # zero node column
    gath = res_pad.at[:, lv.bt_r_nodes].get(mode="promise_in_bounds")
    # out_pad[k, g] = sum_{p, t} r_vals[k, p, t, g] * gath[p, t, g]
    out_pad = jnp.sum(lv.bt_r_vals * gath[None, :, :, :], axis=(1, 2))
    return out_pad[lv.bt_kg[0], lv.bt_kg[1]]  # (nc,) flat coarse


def _prolong_blk(lv: AMGLevel, xc):
    """P @ xc via the block tables: one (Kp, nnodes) row-gather + FMAs.
    Returns (pdim, nnodes) component-major."""
    xc_ext = jnp.concatenate([xc, jnp.zeros(1, dtype=xc.dtype)])
    xc_pad = xc_ext[lv.bt_pad_map]  # (nb, naggs + 1); pad col is zero
    gath = xc_pad.at[:, lv.bt_p_aggs].get(mode="promise_in_bounds")
    # corr[p, i] = sum_{s, k} p_vals[p, s, k, i] * gath[k, s, i]
    g_t = jnp.swapaxes(gath, 0, 1)  # (Kp, nb, nnodes), leading swap
    return jnp.sum(lv.bt_p_vals * g_t[None, :, :, :], axis=(1, 2))


def v_cycle_cm(h: AMGPrecond, fine_matvec_cm: Callable, r_cm):
    """One V-cycle with the FINE level in (pdim, nnds) layout; coarse
    levels run flat as in v_cycle. r_cm, result: (pdim, nnds).

    Transfers use the block tables when present (build() creates them for
    the fine level): ~10x fewer gather indices than the scalar-dof
    restrict/prolong."""
    lv = h.levels[0]
    pdim, nnds = r_cm.shape
    if len(h.levels) == 1:
        x = jnp.matmul(h.coarse_inv, r_cm.T.reshape(-1),
                       precision=jax.lax.Precision.HIGHEST)
        return x.reshape(nnds, pdim).T
    has_blk = lv.bt_p_vals.size > 0
    x = _chebyshev_cm(fine_matvec_cm, lv, jnp.zeros_like(r_cm), r_cm,
                      h.degree)
    res_cm = r_cm - fine_matvec_cm(x)
    if has_blk:
        rc = _restrict_blk(lv, res_cm)
    else:
        res_flat = res_cm.T.reshape(-1)  # layout transpose
        rc = jax.ops.segment_sum(
            lv.pt_vals * res_flat[lv.pt_fine],
            lv.pt_coarse,
            num_segments=lv.n_coarse,
            indices_are_sorted=True,
        )
    nxt = h.levels[1]
    xc = _v(h, 1, lambda v: _lv_matvec(nxt, v), rc)
    if has_blk:
        x = x + _prolong_blk(lv, xc)
    else:
        corr = _ell_matvec(lv.p_vals, lv.p_cols, xc)
        x = x + corr.reshape(nnds, pdim).T  # layout transpose
    return _chebyshev_cm(fine_matvec_cm, lv, x, r_cm, h.degree)
