"""DOF-sharded halo matvec for GENERAL unstructured meshes.

The element-DP ShardedOperator (parallel/ops.py) psums a full O(ndof)
vector per matvec — the honest fallback, but not the scalable layout. The
lattice block-stencil halo (ops/blockstencil.halo_matvec_g) fixed that for
lattice-embeddable decks; this module closes the remaining gap: ANY
single-element-type mesh, any node numbering.

Design (the reference's distributed Mat + VecScatter ghost exchange,
m_global.F90:549-564 / main.F90:184-191, re-thought for a 1-D device
mesh):

  1. Nodes are renumbered by coordinate-lexicographic sort (a cheap
     bandwidth reducer — the analog of the reference's METIS partition,
     m_io.F90:107-143). Each device owns a CONTIGUOUS slab of S nodes.
  2. Each element is assigned to the slab holding its MEDIAN node; the
     halo bandwidth B is the max reach of any element past its slab
     boundary. For meshes with spatial locality B ~ nnds^(2/3) << S.
  3. Per device, the element data of the tuned row-gather schedule
     (operator.matvec_cm: component-major state, node-row gathers, ELL
     assembly tables) is rebuilt against LOCAL indices into the
     (S + 2B)-node extended slab.
  4. A matvec exchanges exactly FOUR (pdim, B) boundary bands (two
     ppermute pairs: fetch neighbor values, return neighbor
     contributions) instead of psum-ing O(ndof) — the interconnect traffic drops
     from ndof to 4*B*pdim per device per apply.

Falls back (raises ValueError at build) when the mesh has multiple
element blocks or an element's reach exceeds the slab size; callers keep
the psum path for those.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax import shard_map

from fem_tpu.ops import operator as op_mod


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloGatherOp:
    """Per-device element tables, stacked on a leading device axis (shard
    axis 0 over the 1-D mesh). Local node ids index the extended slab
    [0, S + 2B): [0, B) = left halo band, [B, B + S) = owned nodes,
    [B + S, S + 2B) = right halo band."""

    conn_t: jax.Array  # (nd, nn, ne_max) int32 local extended-slab ids
    dNx: jax.Array  # (nd, nip, pdim, nn, ne_max)
    scale: jax.Array  # (nd, nip, ne_max) w*detJ (0 on padding elements)
    lam: jax.Array  # (nd, ne_max)
    mu: jax.Array  # (nd, ne_max)
    row_a: jax.Array  # (nd, Kn, S + 2B) int32 assembly corner index
    row_e: jax.Array  # (nd, Kn, S + 2B) int32 assembly element index
    S: int = dataclasses.field(metadata=dict(static=True))
    B: int = dataclasses.field(metadata=dict(static=True))
    nnds: int = dataclasses.field(metadata=dict(static=True))
    pdim: int = dataclasses.field(metadata=dict(static=True))

    def astype(self, dtype):
        return HaloGatherOp(
            self.conn_t, self.dNx.astype(dtype), self.scale.astype(dtype),
            self.lam.astype(dtype), self.mu.astype(dtype),
            self.row_a, self.row_e, self.S, self.B, self.nnds, self.pdim,
        )


def build(system, nd: int):
    """Host-side setup. Returns (HaloGatherOp, pos) where pos[node] is the
    node's position in the slab ordering (use with to_padded_cm /
    from_padded_cm). Raises ValueError when the layout does not apply
    (multi-block mesh, or element reach > slab size)."""
    fop = system.fused_operator()
    vol_blocks = [b for b in fop.blocks if b.conn_t.shape[1] > 0]
    if len(vol_blocks) != 1:
        raise ValueError(
            f"halo_gather supports single-element-type meshes "
            f"(got {len(vol_blocks)} blocks)")
    b = vol_blocks[0]
    coords = np.asarray(system.problem.coords, dtype=np.float64)
    nnds = coords.shape[0]
    pdim = system.pdim
    # coordinate-lexicographic slab order: primary x, then y, then z
    keys = tuple(coords[:, k] for k in range(coords.shape[1] - 1, -1, -1))
    order = np.lexsort(keys)
    pos = np.empty(nnds, dtype=np.int64)
    pos[order] = np.arange(nnds)

    conn = np.asarray(b.conn_t)  # (nn, ne) global node ids
    nn, ne = conn.shape
    pconn = pos[conn]
    S = -(-nnds // nd)  # ceil
    med = np.sort(pconn, axis=0)[nn // 2]  # median node position per elem
    dev = np.clip(med // S, 0, nd - 1)
    emin = pconn.min(axis=0)
    emax = pconn.max(axis=0)
    reach_l = np.maximum(dev * S - emin, 0)
    reach_r = np.maximum(emax - ((dev + 1) * S - 1), 0)
    B = int(max(reach_l.max(initial=0), reach_r.max(initial=0), 1))
    if B > S:
        raise ValueError(
            f"element reach B={B} exceeds slab size S={S}; mesh has no "
            f"spatial locality under the slab order — use the psum path")

    dNx = np.asarray(b.dNx)  # (nip, pdim, nn, ne)
    scale = np.asarray(b.scale)  # (nip, ne)
    lam = np.asarray(b.lam)
    mu = np.asarray(b.mu)
    nip = dNx.shape[0]
    S2B = S + 2 * B

    per_dev = [np.nonzero(dev == d)[0] for d in range(nd)]
    ne_max = max(1, max(ix.size for ix in per_dev))

    conn_d = np.zeros((nd, nn, ne_max), dtype=np.int32)
    dNx_d = np.zeros((nd, nip, pdim, nn, ne_max), dtype=dNx.dtype)
    scale_d = np.zeros((nd, nip, ne_max), dtype=scale.dtype)
    lam_d = np.zeros((nd, ne_max), dtype=lam.dtype)
    mu_d = np.zeros((nd, ne_max), dtype=mu.dtype)
    tables = []
    Kn = 1
    for d, ix in enumerate(per_dev):
        k = ix.size
        lconn = (pconn[:, ix] - (d * S - B)).astype(np.int32)  # (nn, k)
        conn_d[d, :, :k] = lconn
        dNx_d[d, ..., :k] = dNx[..., ix]
        scale_d[d, :, :k] = scale[:, ix]
        lam_d[d, :k] = lam[ix]
        mu_d[d, :k] = mu[ix]
        # assembly table over the extended slab: entry (a, e) contributes
        # to local node lconn[a, e]; zero slot = (a=0, e=ne_max) (the
        # force tensor is padded with a zero column there)
        ids = lconn.reshape(-1).astype(np.int64)  # a-major
        table, _ = op_mod._ell_table(ids, S2B, zero_slot=nn * k)
        ra = np.where(table == nn * k, 0, table // max(k, 1))
        re = np.where(table == nn * k, ne_max, table % max(k, 1))
        tables.append((ra.astype(np.int32), re.astype(np.int32)))
        Kn = max(Kn, table.shape[1])
    row_a = np.zeros((nd, Kn, S2B), dtype=np.int32)
    row_e = np.full((nd, Kn, S2B), ne_max, dtype=np.int32)
    for d, (ra, re) in enumerate(tables):
        row_a[d, : ra.shape[1]] = ra.T
        row_e[d, : re.shape[1]] = re.T

    op = HaloGatherOp(
        conn_t=jnp.asarray(conn_d),
        dNx=jnp.asarray(dNx_d),
        scale=jnp.asarray(scale_d),
        lam=jnp.asarray(lam_d),
        mu=jnp.asarray(mu_d),
        row_a=jnp.asarray(row_a),
        row_e=jnp.asarray(row_e),
        S=S, B=B, nnds=nnds, pdim=pdim,
    )
    return op, pos


def device_put(op: HaloGatherOp, mesh):
    """Shard every stacked table on its leading device axis."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    ax = mesh.axis_names[0]

    def put(x):
        if isinstance(x, jax.Array) and x.ndim >= 1:
            spec = P(ax, *([None] * (x.ndim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))
        return x

    return jax.tree_util.tree_map(put, op)


def to_padded_cm(u_flat, pos, nd: int, S: int, pdim: int):
    """(ndof,) interleaved dof vector -> (pdim, nd*S) slab-ordered
    component-major state (eager, once per solve boundary)."""
    nnds = u_flat.shape[0] // pdim
    un = u_flat.reshape(nnds, pdim)
    up = jnp.zeros((nd * S, pdim), dtype=u_flat.dtype)
    up = up.at[jnp.asarray(pos)].set(un)
    return up.T


def from_padded_cm(up, pos, pdim: int):
    """(pdim, nd*S) slab-ordered state -> (ndof,) interleaved vector."""
    un = up.T[jnp.asarray(pos)]  # (nnds, pdim)
    return un.reshape(-1)


def matvec_cm_sharded(op: HaloGatherOp, up, mesh):
    """K @ u on slab-ordered component-major state up (pdim, nd*S),
    DOF-sharded over the mesh's single axis. Exchanges four (pdim, B)
    bands per apply (two ppermute pairs) — no O(ndof) collective."""
    from jax.sharding import PartitionSpec as P

    ax = mesh.axis_names[0]
    nd = mesh.devices.size
    S, B, pdim = op.S, op.B, op.pdim
    fwd = [(i, (i + 1) % nd) for i in range(nd)]
    bwd = [(i, (i - 1) % nd) for i in range(nd)]

    def local(u_loc, conn_t, dNx, scale, lam, mu, ra, re_):
        # u_loc (pdim, S); tables arrive with a leading length-1 shard axis
        conn_t, dNx, scale = conn_t[0], dNx[0], scale[0]
        lam, mu, ra, re_ = lam[0], mu[0], ra[0], re_[0]
        # fetch neighbor boundary bands (wraparound bands are never
        # referenced by construction: no element reaches past B)
        lb = jax.lax.ppermute(u_loc[:, S - B:], ax, fwd)  # left nbr's tail
        rb = jax.lax.ppermute(u_loc[:, :B], ax, bwd)  # right nbr's head
        u_ext = jnp.concatenate([lb, u_loc, rb], axis=1)  # (pdim, S+2B)
        blk = op_mod.FusedBlock(
            edofs_t=conn_t, conn_t=conn_t, dNx=dNx, scale=scale,
            lam=lam, mu=mu,
        )
        un = jnp.swapaxes(
            u_ext.at[:, conn_t].get(mode="promise_in_bounds"), 0, 1
        )  # (nn, pdim, ne)
        f = op_mod.block_force_un(blk, un)  # (nn, pdim, ne)
        fpad = jnp.pad(jnp.swapaxes(f, 0, 1), ((0, 0), (0, 0), (0, 1)))
        inc = fpad.at[:, ra, re_].get(mode="promise_in_bounds")
        out_ext = jnp.sum(inc, axis=1)  # (pdim, S+2B)
        # return halo contributions to their owners
        from_right = jax.lax.ppermute(out_ext[:, :B], ax, bwd)
        from_left = jax.lax.ppermute(out_ext[:, S + B:], ax, fwd)
        out = out_ext[:, B: B + S]
        out = out.at[:, S - B:].add(from_right)
        out = out.at[:, :B].add(from_left)
        return out

    sh = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(None, ax),) + (P(ax),) * 7,
        out_specs=P(None, ax),
    )
    return sh(up, op.conn_t, op.dNx, op.scale, op.lam, op.mu,
              op.row_a, op.row_e)
