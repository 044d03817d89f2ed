"""Fused matrix-free elastic operator as a JAX pytree (element-batch-last).

Why a pytree: the hot solve functions must receive the element data (spatial
gradients, scales, Lame parameters, dof maps) as *arguments*, not as closed-
over constants — closures bake device arrays into the HLO as literals, which
bloats compile payloads (hundreds of MB at 1M DOF) and defeats donation. With
`FusedOperator` registered as a pytree, `jax.jit(solve)(op, F, ...)` traces
once and streams the arrays as buffers.

Why element-batch-LAST: element-batch-first layouts like (ne, nip, pdim, nn)
put tiny dims (3, 8) in the fastest-varying positions. Storing
(nip, pdim, nn, ne) keeps the huge ne axis contiguous, so every elementwise op
streams long contiguous rows.

The operator applies K @ u without materializing element stiffness matrices:
gather (nn*pdim, ne) -> fused isotropic stress kernel -> sorted segment-sum
scatter. This replaces the reference's assembled PETSc MatAIJ SpMV
(main.F90:157-171 + MatMult inside KSP) with on-the-fly
compute: ~5k flops vs ~2.3KB of matrix traffic per hex8 element.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fem_tpu.ops import stiffness as stiff_ops


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusedBlock:
    """Per-element-type data, batched over elements in the LAST axis."""

    edofs_t: jax.Array  # (nn*pdim, ne) int32, interleaved dof ids
    conn_t: jax.Array  # (nn, ne) int32 node ids (row-gather schedule)
    dNx: jax.Array  # (nip, pdim, nn, ne)
    scale: jax.Array  # (nip, ne) w * detJ
    lam: jax.Array  # (ne,)
    mu: jax.Array  # (ne,)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FusedOperator:
    blocks: Tuple[FusedBlock, ...]
    perm: jax.Array  # (sum nn*pdim*ne,) sorted-scatter permutation
    sorted_ids: jax.Array  # same length, ascending dof ids
    # Node-centric ELL scatter: gather_idx[d, k] indexes the concatenated
    # per-block force vector (one extra trailing ZERO slot for padding);
    # out[d] = sum_k forces[gather_idx[d, k]]. Converts the segment-sum
    # scatter into a dense (ndof, K) gather + axis reduction.
    gather_idx: jax.Array  # (ndof, K) int32
    # ROW-gather schedule (the production one): indices address pdim-wide
    # NODE ROWS instead of scalar dofs — 3x fewer indices and row-
    # vectorized fetches. Entry rows
    # are the concatenated per-(block, corner, element) force rows in
    # a-major order; the trailing row is the zero slot.
    row_gather_idx: jax.Array  # (nnds, Kn) int32
    # Per-block (corner, element) assembly coordinates, pre-transposed to
    # (Kn_b, nnds): the per-block force tensor (pdim, nn, ne+1) is gathered
    # directly at [:, row_a, row_e] — no (nn, ne) -> (nn*ne) lane/sublane
    # relayout. Padding points at
    # (a=0, e=ne), the zero column.
    row_a: Tuple[jax.Array, ...]
    row_e: Tuple[jax.Array, ...]
    ndof: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dtype(self):
        return self.blocks[0].dNx.dtype if self.blocks else jnp.float64

    def astype(self, dtype):
        """Cast the float leaves (dof maps stay integer)."""
        blocks = tuple(
            FusedBlock(
                b.edofs_t,
                b.conn_t,
                b.dNx.astype(dtype),
                b.scale.astype(dtype),
                b.lam.astype(dtype),
                b.mu.astype(dtype),
            )
            for b in self.blocks
        )
        return FusedOperator(blocks, self.perm, self.sorted_ids,
                             self.gather_idx, self.row_gather_idx,
                             self.row_a, self.row_e, self.ndof)


def _ell_table(ids, nseg, zero_slot):
    """Positions of each segment's entries, padded with `zero_slot`."""
    nz = ids.shape[0]
    counts = np.bincount(ids, minlength=nseg)
    K = int(counts.max()) if nz else 1
    table = np.full((nseg, K), zero_slot, dtype=np.int64)
    perm = np.argsort(ids, kind="stable")
    starts = np.zeros(nseg + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    col = np.arange(nz) - starts[ids[perm]]
    table[ids[perm], col] = perm
    return table.astype(np.int32), perm


def build(system) -> FusedOperator:
    """Build from a models.system.System (host-side, once per problem)."""
    blocks = []
    flat_dofs = []
    flat_nodes = []
    for name, e in system.blocks.items():
        if e["is_coh"]:
            continue
        et = e["et"]
        dNx, detj = stiff_ops.grad_and_detj(et, e["ecoords"])
        w = jnp.asarray(et.weights, dtype=system.dtype)
        scale = (detj * w[None, :]).T  # (nip, ne)
        lam, mu = stiff_ops.lame(e["E"], e["nu"])
        conn_t = np.asarray(e["conn"]).T  # (nn, ne)
        blocks.append(
            FusedBlock(
                edofs_t=jnp.asarray(e["edofs"]).T,
                conn_t=jnp.asarray(conn_t.astype(np.int32)),
                dNx=jnp.transpose(dNx, (1, 2, 3, 0)),
                scale=scale,
                lam=lam,
                mu=mu,
            )
        )
        flat_dofs.append(np.asarray(e["edofs"]).T.reshape(-1))
        flat_nodes.append(conn_t.reshape(-1))  # a-major row order
    flat = np.concatenate(flat_dofs) if flat_dofs else np.zeros(0, np.int32)
    perm = np.argsort(flat, kind="stable")
    gather, _ = _ell_table(flat, system.ndof, flat.shape[0])
    fnodes = (
        np.concatenate(flat_nodes) if flat_nodes else np.zeros(0, np.int32)
    )
    row_gather, _ = _ell_table(fnodes, system.nnds, fnodes.shape[0])
    # per-block (corner, element) assembly coordinates, (Kn_b, nnds)
    row_a: List = []
    row_e: List = []
    for bi, fn in enumerate(flat_nodes):
        ne_b = blocks[bi].conn_t.shape[1]
        tbl, _ = _ell_table(fn, system.nnds, fn.shape[0])
        a_idx = (tbl // ne_b).astype(np.int32)
        e_idx = (tbl % ne_b).astype(np.int32)
        # zero slot: tbl == fn.shape[0] = nn_b*ne_b -> a = nn_b (OOB!);
        # remap padding to (a=0, e=ne_b) — the appended zero column
        pad = tbl == fn.shape[0]
        a_idx[pad] = 0
        e_idx[pad] = ne_b
        row_a.append(jnp.asarray(a_idx.T))
        row_e.append(jnp.asarray(e_idx.T))
    return FusedOperator(
        blocks=tuple(blocks),
        perm=jnp.asarray(perm),
        sorted_ids=jnp.asarray(flat[perm]),
        gather_idx=jnp.asarray(gather),
        row_gather_idx=jnp.asarray(row_gather),
        row_a=tuple(row_a),
        row_e=tuple(row_e),
        ndof=system.ndof,
    )


def block_force(b: FusedBlock, u):
    """Fused internal force for one block: returns (nn*pdim, ne).

    f[(a,q)] = sum_ip scale * dNx[ip,p,a] * sigma[ip,p,q], with
    sigma = lam tr(g) I + mu (g + g^T) and g[ip,p,q] = sum_a dNx[ip,p,a] u[a,q].

    The tiny-dim contractions are UNROLLED as elementwise multiply-adds
    (ne in lanes) instead of einsum: XLA lowers einsums over 8/3-sized
    contraction dims to dot_generals whose tiny dims can be padded into
    buffers many times the data's size.
    """
    nip, pdim, nn, ne = b.dNx.shape
    un = u[b.edofs_t].reshape(nn, pdim, ne)  # (a, q, e)
    return block_force_un(b, un).reshape(nn * pdim, ne)


def block_force_un(b: FusedBlock, un):
    """block_force given the pre-gathered element displacements
    un (nn, pdim, ne); returns (nn, pdim, ne)."""
    nip, pdim, nn, ne = b.dNx.shape
    # g[i,p,q,e] = sum_a dNx[i,p,a,e] * un[a,q,e]
    g = None
    for a in range(nn):
        term = b.dNx[:, :, a, None, :] * un[a][None, None, :, :]
        g = term if g is None else g + term
    tr = None  # (i, e)
    for p in range(pdim):
        t = g[:, p, p, :]
        tr = t if tr is None else tr + t
    sym = g + jnp.swapaxes(g, 1, 2)
    eye = jnp.eye(pdim, dtype=un.dtype)
    sigma = (
        b.lam[None, None, None, :] * tr[:, None, None, :] * eye[None, :, :, None]
        + b.mu[None, None, None, :] * sym
    )
    sigma = sigma * b.scale[:, None, None, :]
    # f[a,q,e] = sum_{i,p} dNx[i,p,a,e] * sigma[i,p,q,e]
    rows = []
    for a in range(nn):
        fa = jnp.sum(b.dNx[:, :, a, None, :] * sigma, axis=(0, 1))  # (q, e)
        rows.append(fa)
    return jnp.stack(rows, axis=0)  # (a, q, e)


# Which schedule matvec() uses: "rows" (node-row gathers in component-major
# layout — fewer indices, well-tiled fetches) or "ell" (scalar-dof ELL
# gathers — the conservative fallback). Module-level switch read at trace
# time.
MATVEC_IMPL = "rows"


def matvec(op: FusedOperator, u):
    """K @ u, matrix-free, deterministic reduction order."""
    if MATVEC_IMPL == "rows":
        return matvec_rows(op, u)
    return matvec_ell(op, u)


def matvec_cm(op: FusedOperator, u2c):
    """K @ u in COMPONENT-MAJOR layout: u2c, out (pdim, nnds).

    The node-ROW-gather schedule: gathers fetch pdim-wide node rows (3x
    fewer indices than scalar-dof gathers), and every gather result keeps
    a LARGE axis in
    the trailing (lane) position:
      - input:  u2c[:, conn_t] -> (pdim, nn, ne)          [ne lanes]
      - output: fpad (pdim, nn, ne+1)[:, row_a, row_e] ->
                (pdim, Kn, nnds)                          [nnds lanes]
    Two layout rules: (1) never materialize a gather whose trailing dims
    are tiny ((Kn, pdim) = (8, 3)); (2) the (nnds, pdim) <-> (pdim, nnds)
    transposes are full passes over the vector — solvers should carry
    component-major state end-to-end and only the flat-API wrapper pays
    them.
    """
    out_c = None
    for b, ra, re_ in zip(op.blocks, op.row_a, op.row_e):
        un = jnp.swapaxes(
            u2c.at[:, b.conn_t].get(mode="promise_in_bounds"), 0, 1
        )  # (nn, pdim, ne) — leading-axes swap only, no tiled-layout change
        f = block_force_un(b, un)  # (nn, pdim, ne)
        fswap = jnp.swapaxes(f, 0, 1)  # (pdim, nn, ne), leading swap
        fpad = jnp.pad(fswap, ((0, 0), (0, 0), (0, 1)))  # zero column e=ne
        inc = fpad.at[:, ra, re_].get(mode="promise_in_bounds")
        s = jnp.sum(inc, axis=1)  # (pdim, nnds)
        out_c = s if out_c is None else out_c + s
    return out_c


def matvec_rows(op: FusedOperator, u):
    """Flat (ndof,) wrapper around matvec_cm (pays the two transposes)."""
    nnds = op.row_gather_idx.shape[0]
    pdim = op.ndof // nnds
    return matvec_cm(op, u.reshape(nnds, pdim).T).T.reshape(-1)


def matvec_ell(op: FusedOperator, u):
    """Scalar-dof ELL-gather schedule (kept for comparison)."""
    parts = [block_force(b, u).reshape(-1) for b in op.blocks]
    flat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    padded = jnp.concatenate([flat, jnp.zeros(1, dtype=flat.dtype)])
    return jnp.sum(padded[op.gather_idx], axis=1)


def matvec_segsum(op: FusedOperator, u):
    """The round-1 sorted segment-sum schedule (kept for comparison)."""
    parts = [block_force(b, u).reshape(-1) for b in op.blocks]
    flat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    return jax.ops.segment_sum(
        flat[op.perm], op.sorted_ids, num_segments=op.ndof,
        indices_are_sorted=True,
    )


def diag(op: FusedOperator):
    """Diagonal of K (Jacobi preconditioner) from the fused data:
    diag[(a,p)] = (lam+mu) sum_ip s dNx[p,a]^2 + mu sum_ip,k s dNx[k,a]^2."""
    d = jnp.zeros(op.ndof, dtype=op.dtype)
    for b in op.blocks:
        hd = jnp.einsum("ie,ipae,ipae->pae", b.scale, b.dNx, b.dNx)
        tot = jnp.sum(hd, axis=0)  # (nn, ne)
        dv = (
            (b.lam + b.mu)[None, None, :] * jnp.swapaxes(hd, 0, 1)
            + b.mu[None, None, :] * tot[:, None, :]
        )  # (nn, pdim, ne)
        nnp = dv.shape[0] * dv.shape[1]
        d = d.at[b.edofs_t.reshape(-1)].add(dv.reshape(nnp, -1).reshape(-1))
    return d
