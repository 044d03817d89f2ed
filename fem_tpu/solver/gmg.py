"""Geometric block multigrid for lattice-TOPOLOGY meshes — every level a
gather-free block stencil.

Covers the same MUMPS-distributed-solver role as solver/amg.py
(main.F90:354-390) on the large sub-class of decks whose
assembled connectivity is a lattice even when the geometry is not (jittered /
graded / mapped grids, and the cohesive strip whose two blocks embed in one
lattice with a zero-stiffness seam — see ops/blockstencil.py tier 2).

Why this exists: most of an SA-AMG V-cycle goes to the FIRST COARSE
level's scalar-ELL gather matvec (7 Chebyshev applies) and the block-table
transfers, while the fine lattice-stencil matvec itself is cheap. The
coarse levels are gather-bound, not FLOP- or bandwidth-bound: XLA lowers
x[cols] to gathers.

The fix is structural, not a faster gather: coarsen GEOMETRICALLY by
factor 2 per axis with kron'd 1D linear interpolation. For a reach-1
lattice operator A and linear P, the Galerkin product P^T A P couples
coarse nodes i, j only if some fine pair within distance 1 links their
supports: |2i - 2j| <= 3  =>  |i - j| <= 1 per axis. So EVERY coarse
operator is again a 3^d lattice block stencil (ops/blockstencil.py),
smoothing at every level is static shifted slices (zero gather indices),
and the transfers are the axis-separable stack/reshape interleaves proven
at 1.59M dofs in solver/multigrid.py — generalized here to even axis
sizes (the cohesive strip's NY = 2*(ny_half+1) is always even).

Host side builds scipy P / RAP per level (no aggregation, no RBM QR —
cheaper setup than SA as well); device side is a pure pytree of
BlockStencilOperators + Chebyshev bounds. The coarsest level uses the
same dense-inverse machinery as AMG (amg._dense_inv: null-pivot pinning,
blocked Cholesky — the MUMPS icntl(24) analogue).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from fem_tpu.ops import blockstencil as bs
from fem_tpu.solver import amg as amg_mod
from fem_tpu.solver import multigrid as mg_mod


# ---------------------------------------------------------------------------
# Host-side hierarchy construction
# ---------------------------------------------------------------------------


def _p1d(n: int):
    """1D linear prolongation (n fine rows, ceil(n/2) coarse cols).

    Coarse nodes sit at even fine indices 0, 2, ..; odd fine nodes take
    (1/2, 1/2) from their coarse neighbours. When n is EVEN the last fine
    node (odd index n-1) has no right coarse neighbour and takes weight 1
    from the left — constant vectors stay exactly representable (rigid
    translations must lie in range(P) for elasticity).
    """
    import scipy.sparse as sp

    m = (n + 1) // 2
    rows, cols, vals = [], [], []
    for i in range(m):
        rows.append(2 * i)
        cols.append(i)
        vals.append(1.0)
    for i in range(m - 1):
        rows.append(2 * i + 1)
        cols.append(i)
        vals.append(0.5)
        rows.append(2 * i + 1)
        cols.append(i + 1)
        vals.append(0.5)
    if n == 2 * m:  # even: weight-1 edge copy
        rows.append(n - 1)
        cols.append(m - 1)
        vals.append(1.0)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, m))


def _prolongation(dims: Tuple[int, ...], pdim: int, flags=None):
    """P = (P_ax0 kron P_ax1 [kron P_ax2]) kron I_pdim over lex node order
    (axis 0 slowest — matches blockstencil.build / the mesh generators).

    flags[ax] False keeps that axis at fine resolution (identity factor) —
    semi-coarsening for anisotropic meshes (see _axis_strengths)."""
    import scipy.sparse as sp

    def fac(ax, d):
        if flags is not None and not flags[ax]:
            return sp.identity(d, format="csr")
        return _p1d(d)

    P = fac(0, dims[0])
    for ax, d in enumerate(dims[1:], start=1):
        P = sp.kron(P, fac(ax, d), format="csr")
    return sp.kron(P, sp.identity(pdim, format="csr"), format="csr")


def _axis_strengths(A, pdim: int, dims: Tuple[int, ...]) -> np.ndarray:
    """Per-axis coupling strength: sum of the NEGATIVE same-component
    entries -min(a_ij, 0) over face neighbours (node offset exactly +-1
    along the axis, 0 elsewhere) — the classic M-matrix strength measure.
    Drives semi-coarsening: on anisotropic meshes (the default lx=10
    cantilever deck, element aspect 10:1:1) the stretched axis's
    same-component face couplings turn POSITIVE (strength -> 0) while
    |a_ij|-sums stay deceptively equal (shear terms); isotropic factor-2
    coarsening under a point-Chebyshev smoother stalls there (42 PCG
    iterations on the 6^3 deck vs ~12 with strength-guided semi-coarsening;
    measured: aniso neg-strengths [0, .997, 1], iso [.90, .997, 1])."""
    Ac = A.tocoo()
    rem_i, rem_j = Ac.row // pdim, Ac.col // pdim
    same_comp = (Ac.row % pdim) == (Ac.col % pdim)
    offs = []
    for d in dims[::-1]:
        offs.append((rem_j % d).astype(np.int64) - (rem_i % d))
        rem_i, rem_j = rem_i // d, rem_j // d
    offs = offs[::-1]
    neg = np.maximum(-Ac.data, 0.0)
    n_moved = np.zeros(len(Ac.data), dtype=np.int8)
    for o in offs:
        n_moved += (o != 0)
    out = np.zeros(len(dims))
    for ax in range(len(dims)):
        m = (np.abs(offs[ax]) == 1) & (n_moved == 1) & same_comp
        out[ax] = float(neg[m].sum())
    return out


def _axis_offsets_ok(A, pdim: int, dims: Tuple[int, ...]) -> bool:
    """True iff every nonzero of A couples lattice neighbours (offsets in
    {-1,0,1}^d) — the invariant the Galerkin RAP is proven to preserve;
    checked per level anyway (cheap) so a violation falls back to SA-AMG
    instead of silently corrupting the stencil scatter."""
    Ac = A.tocoo()
    i_node = Ac.row // pdim
    j_node = Ac.col // pdim
    rem_i, rem_j = i_node, j_node
    for d in dims[:0:-1]:
        ci, rem_i = rem_i % d, rem_i // d
        cj, rem_j = rem_j % d, rem_j // d
        if np.abs(cj - ci).max(initial=0) > 1:
            return False
    return np.abs(rem_j - rem_i).max(initial=0) <= 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GMGLevel:
    # smoothing operator; None on level 0 (the caller's fine matvec — the
    # masked block stencil, or the full cohesive tangent — is used there)
    op: Optional[bs.BlockStencilOperator]
    dinv_g: jax.Array  # (pdim, *dims) 1/diag (1.0 where diag == 0)
    theta: float = dataclasses.field(metadata=dict(static=True))
    delta: float = dataclasses.field(metadata=dict(static=True))
    dims: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    # which axes the transfer to the NEXT level coarsens (None = all);
    # semi-coarsening pattern chosen by _axis_strengths in build_lattice
    coarsen: Optional[Tuple[bool, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GMGPrecond:
    levels: Tuple[GMGLevel, ...]
    coarse_inv: jax.Array  # dense inverse, interleaved (node*pdim+p) order
    coarse_dims: Tuple[int, ...] = dataclasses.field(
        metadata=dict(static=True))
    pdim: int = dataclasses.field(metadata=dict(static=True))
    degree: int = dataclasses.field(default=3, metadata=dict(static=True))

    def astype(self, dtype):
        def cast(x):
            return (x.astype(dtype)
                    if jnp.issubdtype(x.dtype, jnp.floating) else x)

        return jax.tree_util.tree_map(cast, self)


def build_lattice(
    A,
    pdim: int,
    dims: Tuple[int, ...],
    bc_dofs=None,
    coarse_max: int = 2400,
    max_levels: int = 10,
    degree: int = 3,
    dtype=jnp.float32,
    lb_frac: float = 30.0,
    max_stencil_levels: Optional[int] = None,
) -> Optional[GMGPrecond]:
    """Build the geometric hierarchy from the assembled scipy CSR `A` whose
    node numbering is lex over `dims` (bs.detect provides dims). Returns
    None if any Galerkin level leaves the lattice (never observed; the
    caller then falls back to amg.build). `max_stencil_levels` caps the
    number of stencil levels (default: all but the dense coarse)."""
    A = A.tocsr()
    if bc_dofs is not None and len(np.asarray(bc_dofs)) > 0:
        A = amg_mod._eliminate_bcs(A, np.asarray(bc_dofs))
    np_dtype = np.dtype(jnp.dtype(dtype).name)

    if max_stencil_levels is None:
        max_stencil_levels = max_levels - 1
    dense_coarse_cap = 24000  # largest coarse amg._dense_inv can take

    levels = []
    cur_A, cur_dims = A, tuple(int(d) for d in dims)
    while (len(levels) < min(max_levels - 1, max_stencil_levels)
           and (cur_A.shape[0] > coarse_max or not levels)
           and any(d >= 3 for d in cur_dims)):
        if not _axis_offsets_ok(cur_A, pdim, cur_dims):
            return None
        # strength-guided semi-coarsening: coarsen the axes whose face
        # couplings are within 4x of the strongest (classic 0.25 rule);
        # weak (long-element) axes wait until RAP levels the anisotropy
        can = np.array([d >= 3 for d in cur_dims])
        strengths = _axis_strengths(cur_A, pdim, cur_dims)
        flags = can & (strengths >= 0.25 * strengths[can].max())
        if not flags.any():
            flags = can
        d = cur_A.diagonal()
        dinv = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 1.0)
        lam_max = 1.1 * amg_mod._lambda_max(cur_A, dinv)
        # lb_frac=4 narrows the smoothing interval to the upper spectrum
        # (the MG-smoother convention — see multigrid.build's docstring)
        lb = lam_max / lb_frac
        op = None
        if levels:  # level 0 smooths through the caller's fine matvec
            op = bs.build(cur_A, pdim, cur_dims, dtype=dtype)
        nnds_l = int(np.prod(cur_dims))
        levels.append(GMGLevel(
            op=op,
            dinv_g=jnp.asarray(
                dinv.astype(np_dtype).reshape(nnds_l, pdim).T.reshape(
                    (pdim,) + cur_dims)),
            theta=float(0.5 * (lam_max + lb)),
            delta=float(0.5 * (lam_max - lb)),
            dims=cur_dims,
            coarsen=tuple(bool(f) for f in flags),
        ))
        # P is the SAME pure-geometric map the device prolong_g/restrict_g
        # implement — Galerkin consistency (and hence an SPD M) requires
        # it exactly. The identity rows _eliminate_bcs left behind flow
        # through RAP as unit-scale couplings; they are negligible next to
        # the physical stiffness scale and Chebyshev's D^-1 handles the
        # nonuniformity.
        P = _prolongation(cur_dims, pdim, flags)
        cur_A = (P.T.tocsr() @ (cur_A @ P)).tocsr()
        cur_A.sum_duplicates()
        cur_dims = tuple((d + 1) // 2 if f else d
                         for d, f in zip(cur_dims, flags))
    if not levels:
        return None
    if cur_A.shape[0] > dense_coarse_cap:
        # a level cap stopped coarsening above what a dense inverse can
        # take; the caller falls back to SA-AMG
        return None
    Kc = cur_A.toarray()
    coarse_inv = amg_mod._dense_inv(Kc)
    if jnp.issubdtype(coarse_inv.dtype, jnp.floating):
        coarse_inv = coarse_inv.astype(dtype)
    return GMGPrecond(levels=tuple(levels), coarse_inv=coarse_inv,
                      coarse_dims=cur_dims, pdim=pdim, degree=degree)


# ---------------------------------------------------------------------------
# Device-side cycle (all grid-shaped: state is (pdim, *dims))
# ---------------------------------------------------------------------------


def _interp_axis_n(a, axis: int, n_fine: int):
    """multigrid._interp_axis (m -> 2m-1, stack/reshape interleave)
    generalized to EVEN fine sizes: 2m appends a weight-1
    copy of the last coarse value (the adjoint of _restrict_axis_n)."""
    m = a.shape[axis]
    body = mg_mod._interp_axis(a, axis)
    if n_fine == 2 * m - 1:
        return body
    assert n_fine == 2 * m, (n_fine, m)
    last = [slice(None)] * a.ndim
    last[axis] = slice(m - 1, m)
    return jnp.concatenate([body, a[tuple(last)]], axis=axis)


def _restrict_axis_n(r, axis: int):
    """Adjoint of _interp_axis_n: size n -> ceil(n/2) for any n."""
    n = r.shape[axis]
    if n % 2 == 1:
        return mg_mod._restrict_axis(r, axis)
    m = n // 2
    core = [slice(None)] * r.ndim
    core[axis] = slice(0, n - 1)
    out = mg_mod._restrict_axis(r[tuple(core)], axis)
    lastf = [slice(None)] * r.ndim
    lastf[axis] = slice(n - 1, n)
    lastc = [slice(None)] * r.ndim
    lastc[axis] = slice(m - 1, m)
    return out.at[tuple(lastc)].add(r[tuple(lastf)])


def prolong_g(xc_g, fine_dims: Tuple[int, ...], flags=None):
    """(pdim, *coarse_dims) -> (pdim, *fine_dims); flags[ax] False leaves
    that axis untouched (semi-coarsening identity factor)."""
    a = xc_g
    for ax, n in enumerate(fine_dims):
        if flags is None or flags[ax]:
            a = _interp_axis_n(a, 1 + ax, n)
    return a


def restrict_g(r_g, flags=None):
    """(pdim, *fine_dims) -> (pdim, *coarse_dims): ceil(n/2) on coarsened
    axes, identity on the rest."""
    a = r_g
    for ax in range(r_g.ndim - 1):
        if flags is None or flags[ax]:
            a = _restrict_axis_n(a, 1 + ax)
    return a


def _cheb_g(matvec_g, lv: GMGLevel, x, b, degree: int):
    """Chebyshev smoothing of D^-1 A on [theta-delta, theta+delta] —
    same recurrence as amg._chebyshev, grid-shaped state."""
    theta, delta = lv.theta, lv.delta
    sigma = theta / delta
    rho = 1.0 / sigma
    r = lv.dinv_g * (b - matvec_g(x))
    d = r / theta
    for _ in range(degree - 1):
        x = x + d
        r = r - lv.dinv_g * matvec_g(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x + d


def v_cycle_g(h: GMGPrecond, fine_matvec_g: Callable, r_g):
    """One V-cycle, state (pdim, *dims) at every level; level 0 smooths via
    `fine_matvec_g` (the caller's masked stencil / full cohesive tangent),
    deeper levels via their own block stencils."""
    return _v(h, 0, fine_matvec_g, r_g)


def _v(h: GMGPrecond, i: int, mv_g: Callable, r_g):
    lv = h.levels[i]
    x = _cheb_g(mv_g, lv, jnp.zeros_like(r_g), r_g, h.degree)
    res = r_g - mv_g(x)
    rc = restrict_g(res, lv.coarsen)
    if i + 1 == len(h.levels):
        pdim = h.pdim
        # device dof order inside coarse_inv is interleaved (node*pdim+p)
        rc_flat = rc.reshape(pdim, -1).T.reshape(-1)
        xc_flat = jnp.matmul(h.coarse_inv, rc_flat,
                             precision=jax.lax.Precision.HIGHEST)
        xc = xc_flat.reshape(-1, pdim).T.reshape(rc.shape)
    else:
        nxt = h.levels[i + 1]
        xc = _v(h, i + 1, lambda v: bs.matvec_g(nxt.op, v), rc)
    x = x + prolong_g(xc, lv.dims, lv.coarsen)
    return _cheb_g(mv_g, lv, x, r_g, h.degree)


def v_cycle_cm(h: GMGPrecond, fine_matvec_cm: Callable, r_cm):
    """(pdim, nnds) component-major wrapper: the lex grid reshape is
    metadata-only, so solvers carrying cm state (newton._mf_jac_mv_cm,
    bench/stepper AMG branches) can swap v_cycle_cm implementations."""
    pdim = r_cm.shape[0]
    dims = h.levels[0].dims
    g = v_cycle_g(h, lambda v: fine_matvec_cm(
        v.reshape(pdim, -1)).reshape((pdim,) + dims),
        r_cm.reshape((pdim,) + dims))
    return g.reshape(pdim, -1)


def preconditioner_g(h: GMGPrecond, fine_matvec_g: Callable) -> Callable:
    return lambda r: v_cycle_g(h, fine_matvec_g, r)
