"""Structured-grid (stencil) elastic operator: no gathers, matmuls + shifts.

Irregular gather/scatter over millions of indices is the bottleneck of
unstructured matrix-free FEM. For meshes
that ARE structured boxes — including the ~1M-DOF hex8 benchmark geometry
from BASELINE.md — the element gather is 8 contiguous array slices, the
scatter-add is 8 contiguous `.at[slice].add`s, and because every element
shares the same Jacobian the element kernel collapses to ONE large matmul:

    f_e = k_ref @ u_e   for all elements at once:
    (ne, 24) @ (24, 24) — ne in the matmul's M dimension.

Heterogeneous isotropic materials are supported through the linearity of k_e
in the Lame parameters: k_e = lam_e K_lam + mu_e K_mu, two matmuls plus
elementwise scaling by the (lam, mu) fields.

This is the answer here to "METIS partitioning quality matters" (SURVEY.md
§2b): for structured problems, partitioning disappears entirely — the grid
shards along its leading axis and the only communication is a halo exchange
(here: psum of boundary planes when sharded).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Reduced-precision f32 matmuls (bf16 or TF32 passes, ~1e-3 relative error)
# are enough to stall CG. All stencil matmuls force full fp32 accumulation.
_HIGH = jax.lax.Precision.HIGHEST

from fem_tpu.ops import elements as element_lib
from fem_tpu.ops import stiffness as stiff_ops

# Grid-index corner offsets matching the element node ordering of
# meshgen's builders. 3D: hex_box_problem numbers nodes (i,j,k)=(x,y,z)
# fastest-z, and the hex8 node order is bottom face CCW then top face —
# grid offsets equal coordinate offsets. 2D: quad_grid_problem numbers
# nodes y-major (row=y, col=x), so grid offsets are (dy, dx) while the
# element corners stay (x, y)-ordered.
_HEX_OFFSETS = (
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
)
_HEX_CORNERS = _HEX_OFFSETS
_QUAD_OFFSETS = ((0, 0), (0, 1), (1, 1), (1, 0))  # (dy, dx) per node 1..4
_QUAD_CORNERS = ((0, 0), (1, 0), (1, 1), (0, 1))  # (x, y) per node 1..4


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Uniform-geometry box-grid elastic operator.

    k_lam/k_mu: (ndof_e, ndof_e) reference stiffness split by Lame parameter.
    lam/mu: scalar () arrays, or (*cells,) fields for heterogeneous material.
    shape: node-grid shape (nnx[, nny[, nnz]]) — static metadata.
    """

    k_lam: jax.Array
    k_mu: jax.Array
    lam: jax.Array
    mu: jax.Array
    shape: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))

    @property
    def pdim(self) -> int:
        return len(self.shape)

    @property
    def ndof(self) -> int:
        return int(np.prod(self.shape)) * self.pdim

    @property
    def offsets(self):
        return _HEX_OFFSETS if self.pdim == 3 else _QUAD_OFFSETS

    def astype(self, dtype):
        return dataclasses.replace(
            self,
            k_lam=self.k_lam.astype(dtype),
            k_mu=self.k_mu.astype(dtype),
            lam=self.lam.astype(dtype),
            mu=self.mu.astype(dtype),
        )


def build(cell_sizes, node_shape, lam, mu, dtype=jnp.float64) -> StencilOperator:
    """cell_sizes: element edge lengths (dx[, dy[, dz]]); node_shape: node
    counts per axis; lam/mu: scalars or per-cell fields."""
    pdim = len(node_shape)
    et = element_lib.get("hex" if pdim == 3 else "qua")
    # reference element coordinates (x, y[, z]) scaled by the cell size
    corners = np.array(_HEX_CORNERS if pdim == 3 else _QUAD_CORNERS, dtype=float)
    ecoords = jnp.asarray(corners * np.asarray(cell_sizes), dtype=dtype)[None]
    one = jnp.ones(1, dtype=dtype)
    zero = jnp.zeros(1, dtype=dtype)
    k_lam = stiff_ops.element_stiffness_lame(et, ecoords, one, zero)[0]
    k_mu = stiff_ops.element_stiffness_lame(et, ecoords, zero, one)[0]
    return StencilOperator(
        k_lam=k_lam,
        k_mu=k_mu,
        lam=jnp.asarray(lam, dtype=dtype),
        mu=jnp.asarray(mu, dtype=dtype),
        shape=tuple(int(n) for n in node_shape),
    )


def detect(problem):
    """Recognize a uniform box-grid Problem and return a matching
    StencilOperator spec, or None.

    Accepts the canonical generated orderings (meshgen builders / the
    reference's make_example strips): 3D nodes numbered z-fastest
    ((i*(ny+1)+j)*(nz+1)+k), 2D y-major (row*nnx+col). Requires a single
    continuum block (qua/hex), one material, and uniform spacing per axis.
    Used by the stepper to route structured decks onto the stencil+multigrid
    path automatically.
    """
    names = [n for n in problem.blocks if n != "coh"]
    if "coh" in problem.blocks or len(names) != 1:
        return None
    b = problem.blocks[names[0]]
    if b.eltype not in ("qua", "hex"):
        return None
    if np.unique(b.mat).size != 1 or int(b.mat[0]) < 0:
        return None
    coords = problem.coords
    pdim = problem.pdim
    axes = []
    for j in range(pdim):
        vals = np.unique(coords[:, j])
        if vals.size < 2:
            return None
        d = np.diff(vals)
        if not np.allclose(d, d[0], rtol=1e-9, atol=1e-12):
            return None
        axes.append(vals)
    counts = [v.size for v in axes]
    if int(np.prod(counts)) != problem.nnds:
        return None

    if pdim == 3:
        nx, ny, nz = counts
        gx, gy, gz = np.meshgrid(axes[0], axes[1], axes[2], indexing="ij")
        lattice = np.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)], 1)
        node_shape = (nx, ny, nz)
        offsets = _HEX_OFFSETS

        def nid(i, j, k):
            return (i * ny + j) * nz + k

        i, j, k = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                              np.arange(nz - 1), indexing="ij")
        idx = [i.reshape(-1), j.reshape(-1), k.reshape(-1)]
        conn_expect = np.stack(
            [nid(idx[0] + ox, idx[1] + oy, idx[2] + oz)
             for ox, oy, oz in offsets], axis=1
        )
    else:
        nx, ny = counts
        gx, gy = np.meshgrid(axes[0], axes[1], indexing="xy")
        lattice = np.stack([gx.reshape(-1), gy.reshape(-1)], 1)
        node_shape = (ny, nx)  # y-major numbering
        i, j = np.meshgrid(np.arange(ny - 1), np.arange(nx - 1), indexing="ij")
        n1 = (j + i * nx).reshape(-1)
        conn_expect = np.stack([n1, n1 + 1, n1 + 1 + nx, n1 + nx], axis=1)

    if not np.allclose(coords, lattice, rtol=1e-9, atol=1e-12):
        return None
    if b.conn.shape != conn_expect.shape:
        return None
    # element ORDER may differ; compare as sets via lexicographic sort
    a = np.sort(b.conn, axis=1)
    e = np.sort(conn_expect.astype(np.int32), axis=1)
    pa = np.lexsort(a.T)
    pe = np.lexsort(e.T)
    if not np.array_equal(a[pa], e[pe]):
        return None
    cell_sizes = tuple(float(v[1] - v[0]) for v in axes)
    if pdim == 2:
        cell_sizes = (cell_sizes[0], cell_sizes[1])
    E, nu = problem.mats[int(b.mat[0]), 0], problem.mats[int(b.mat[0]), 1]
    return dict(cell_sizes=cell_sizes, node_shape=node_shape, E=float(E),
                nu=float(nu))


def _corner_slices(shape, off):
    """Slice of the node grid selecting each element's `off` corner."""
    return tuple(slice(o, o + n - 1) for o, n in zip(off, shape))


def matvec(op: StencilOperator, u):
    """K @ u via 8 (or 4) shifted slices + one or two big matmuls (the
    matmul schedule, which every solver path runs)."""
    return _matmul_core(op, u.reshape(*op.shape, op.pdim)).reshape(-1)


def matvec_g(op: StencilOperator, g):
    """K @ u on GRID-SHAPED (*shape, pdim) vectors — no flat reshapes.

    Why this exists: on an earlier accelerator backend, a flat (ndof,)
    elementwise multiply FUSED onto the stencil matvec's output silently
    corrupted the array tail at >=1.59M dofs (`matvec(v)*keep` wrong while
    `matvec(v*keep)` and the same combine in (*shape, pdim) layout were
    exact — miscompile #5, DESIGN.md). All fused solver code (CG chunks,
    V-cycles) carries grid-shaped state and only flattens, if at all, as
    the program's final op.
    """
    return _matmul_core(op, g)


def _matmul_core(op: StencilOperator, nodes):
    """Grid-shaped core of the matmul schedule: (*shape, pdim) in/out."""
    pdim = op.pdim
    shape = op.shape
    ue = jnp.stack(
        [nodes[_corner_slices(shape, off)] for off in op.offsets], axis=-2
    )  # (*cells, nn, pdim)
    cells = ue.shape[:pdim]
    ndof_e = len(op.offsets) * pdim
    ue_flat = ue.reshape(-1, ndof_e)
    if op.lam.ndim == 0:
        k_ref = op.lam * op.k_lam + op.mu * op.k_mu
        fe = jnp.matmul(ue_flat, k_ref.T, precision=_HIGH)
    else:
        f_lam = jnp.matmul(ue_flat, op.k_lam.T, precision=_HIGH)
        f_mu = jnp.matmul(ue_flat, op.k_mu.T, precision=_HIGH)
        fe = (
            op.lam.reshape(-1, 1) * f_lam + op.mu.reshape(-1, 1) * f_mu
        )
    fe = fe.reshape(*cells, len(op.offsets), pdim)
    out = jnp.zeros_like(nodes)
    for c, off in enumerate(op.offsets):
        out = out.at[_corner_slices(shape, off)].add(fe[..., c, :])
    return out


def matvec_planes(op: StencilOperator, u):
    """K @ u as a fused 27-point (3D) / 9-point (2D) stencil over
    component-planes — the bandwidth-optimal form for scalar materials.

    The matmul form above materializes a (ne, nn*pdim) gather (24x the DOF
    vector in 3D) and runs nn scatter-adds, far more memory traffic than
    the vector itself. Here the same operator is expressed as

        out_p[n] = sum_a M_a[n] * sum_{b,q} k[a,p,b,q] * u_q[n - off_a + off_b]

    where a,b run over element corners, M_a is the float indicator that the
    cell at n - off_a exists, and every shifted read is a static slice of a
    zero-padded (pdim, *(shape+2)) component-planes array. XLA fuses the
    whole sum into one elementwise kernel: traffic ~ u + out instead of
    ~50x u. The per-axis masks are built with numpy at trace time (they
    become small f32 constants — no in-jit bool casts, DESIGN.md
    miscompile #3). Scalar materials only; heterogeneous fields use the
    matmul form.

    No solver runs it: a fused solver program inlines dozens of matvecs,
    and 576 unrolled terms each make that program too large to compile in
    reasonable time (PERF.md). It stays as the bandwidth-bound reference
    form of the operator, timed by chip_smoke.py.
    """
    if op.lam.ndim != 0:
        raise NotImplementedError("matvec_planes requires scalar materials")
    comps = jnp.moveaxis(u.reshape(*op.shape, op.pdim), -1, 0)
    return _planes_core(op, comps).reshape(-1)


def _planes_core(op: StencilOperator, comps):
    """Planes-schedule core: comps (pdim, *shape) in, (*shape, pdim) out."""
    shape = op.shape
    pdim = op.pdim
    offs = op.offsets
    nn = len(offs)
    dtype = comps.dtype
    k_ref = (op.lam * op.k_lam + op.mu * op.k_mu).reshape(nn, pdim, nn, pdim)
    U = jnp.pad(comps, [(0, 0)] + [(1, 1)] * pdim)

    totals = [None] * pdim
    for a in range(nn):
        off_a = offs[a]
        # float mask: cell at (node - off_a) exists, per-axis outer product
        mask_a = None
        for ax in range(pdim):
            nax = shape[ax]
            x = np.arange(nax)
            ok = ((x - off_a[ax] >= 0) & (x - off_a[ax] <= nax - 2))
            mshape = [1] * pdim
            mshape[ax] = nax
            m = jnp.asarray(ok.astype(np.float64).reshape(mshape), dtype=dtype)
            mask_a = m if mask_a is None else mask_a * m
        acc = [None] * pdim
        for b in range(nn):
            off_b = offs[b]
            sl = tuple(
                slice(1 + ob - oa, 1 + ob - oa + n)
                for oa, ob, n in zip(off_a, off_b, shape)
            )
            for q in range(pdim):
                Uq = U[(q,) + sl]
                for p in range(pdim):
                    term = k_ref[a, p, b, q] * Uq
                    acc[p] = term if acc[p] is None else acc[p] + term
        for p in range(pdim):
            t = mask_a * acc[p]
            totals[p] = t if totals[p] is None else totals[p] + t
    out = jnp.stack(totals, axis=0)  # (pdim, *shape)
    return jnp.moveaxis(out, 0, -1)


def matvec_pairs(op: StencilOperator, u):
    """K @ u via per-corner-pair fused slice arithmetic (no (ne, nn*pdim)
    intermediate, no masks — cell-grid slices are exact at boundaries).
    Supports scalar and per-cell heterogeneous materials."""
    pdim = op.pdim
    shape = op.shape
    offs = op.offsets
    nn = len(offs)
    nodes = u.reshape(*shape, pdim)
    if op.lam.ndim == 0:
        k_ref = (op.lam * op.k_lam + op.mu * op.k_mu).reshape(nn, pdim, nn, pdim)
    else:
        k_lam = op.k_lam.reshape(nn, pdim, nn, pdim)
        k_mu = op.k_mu.reshape(nn, pdim, nn, pdim)
    out = jnp.zeros_like(nodes)
    for a in range(nn):
        acc = None
        for b in range(nn):
            ub = nodes[_corner_slices(shape, offs[b])]  # (*cells, pdim)
            for p in range(pdim):
                for q in range(pdim):
                    if op.lam.ndim == 0:
                        term = k_ref[a, p, b, q] * ub[..., q]
                    else:
                        term = (
                            op.lam * k_lam[a, p, b, q]
                            + op.mu * k_mu[a, p, b, q]
                        ) * ub[..., q]
                    if acc is None:
                        acc = [None] * pdim
                    acc[p] = term if acc[p] is None else acc[p] + term
        fe = jnp.stack(acc, axis=-1)  # (*cells, pdim)
        out = out.at[_corner_slices(shape, offs[a])].add(fe)
    return out.reshape(-1)


def matvec_sharded(op: StencilOperator, u, mesh, axis=None):
    """K @ u with element slabs sharded over a 1D device mesh.

    The node grid's leading axis is split into equal cell slabs; each device
    runs the local stencil matvec on its slab (pure slicing + one matmul)
    and the shared boundary planes are reduced by a single psum — the halo
    reduction. u is replicated (a 1.6M-dof f32 grid is ~6.4MB, so its psum
    per matvec is small next to the compute).

    Requires (shape[0]-1) divisible by the mesh size.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    axis = axis or mesh.axis_names[0]
    nd = mesh.devices.size
    shape = op.shape
    pdim = op.pdim
    cells_x = shape[0] - 1
    if cells_x % nd:
        raise ValueError(
            f"leading cell count {cells_x} not divisible by {nd} devices"
        )
    c = cells_x // nd
    local_shape = (c + 1,) + shape[1:]

    def local(u_flat):
        idx = jax.lax.axis_index(axis)
        zero = jnp.zeros((), dtype=idx.dtype)
        grid = u_flat.reshape(*shape, pdim)
        start = (idx * c,) + (zero,) * (len(shape) - 1) + (zero,)
        slab = jax.lax.dynamic_slice(grid, start, local_shape + (pdim,))
        local_op = StencilOperator(
            k_lam=op.k_lam, k_mu=op.k_mu, lam=op.lam, mu=op.mu,
            shape=local_shape,
        )
        if op.lam.ndim != 0:
            # slice the material fields to the local cells
            fstart = (idx * c,) + (zero,) * (len(shape) - 1)
            fsizes = (c,) + tuple(n - 1 for n in shape[1:])
            local_op = StencilOperator(
                k_lam=op.k_lam, k_mu=op.k_mu,
                lam=jax.lax.dynamic_slice(op.lam, fstart, fsizes),
                mu=jax.lax.dynamic_slice(op.mu, fstart, fsizes),
                shape=local_shape,
            )
        f_local = matvec(local_op, slab.reshape(-1)).reshape(
            local_shape + (pdim,)
        )
        out = jnp.zeros_like(grid)
        out = jax.lax.dynamic_update_slice(out, f_local, start)
        return jax.lax.psum(out.reshape(-1), axis)

    return shard_map(
        local, mesh=mesh, in_specs=(P(),), out_specs=P(), check_vma=False
    )(u)


# ---------------- DOF-sharded (halo-exchange) layout ----------------
#
# matvec_sharded above replicates the DOF vector and psums the full grid —
# simple, but O(ndof) communication and O(ndof) memory per device. The
# block layout here shards the VECTORS too ("TP over the linear-algebra
# dimension", SURVEY.md §2c): device d owns node planes [d*c, d*c+c] of the
# leading axis (one plane overlapped with the next device), and a matvec
# communicates exactly TWO boundary planes via ppermute — the classical
# halo exchange over the device interconnect.


def to_blocks(op: StencilOperator, u, nd: int):
    """(ndof,) -> (nd, c+1, *rest, pdim) overlapping slab blocks."""
    shape = op.shape
    pdim = op.pdim
    cells_x = shape[0] - 1
    if cells_x % nd:
        raise ValueError(f"{cells_x} cells not divisible by {nd}")
    c = cells_x // nd
    grid = u.reshape(*shape, pdim)
    return jnp.stack([grid[d * c:d * c + c + 1] for d in range(nd)])


def from_blocks(op: StencilOperator, blocks):
    """Inverse of to_blocks (drops the duplicated planes)."""
    nd = blocks.shape[0]
    parts = [blocks[d, :-1] for d in range(nd - 1)] + [blocks[nd - 1]]
    return jnp.concatenate(parts, axis=0).reshape(-1)


def block_weights(op: StencilOperator, nd: int, dtype):
    """Per-entry weights for sharded dot products: duplicated planes count
    once (first plane of every block except block 0 gets weight 0)."""
    shape = op.shape
    pdim = op.pdim
    c = (shape[0] - 1) // nd
    w = np.ones((nd, c + 1) + shape[1:] + (pdim,), dtype=np.float64)
    w[1:, 0] = 0.0
    return jnp.asarray(w, dtype=dtype)


def fields_to_blocks(op: StencilOperator, nd: int):
    """Per-cell material fields -> (nd, c, *rest) disjoint slab blocks
    (cells partition cleanly; only NODE planes overlap). Returns None for
    scalar materials."""
    if op.lam.ndim == 0:
        return None
    cells_x = op.shape[0] - 1
    if cells_x % nd:
        raise ValueError(f"{cells_x} cells not divisible by {nd}")
    c = cells_x // nd
    lam_b = jnp.stack([op.lam[d * c:(d + 1) * c] for d in range(nd)])
    mu_b = jnp.stack([op.mu[d * c:(d + 1) * c] for d in range(nd)])
    return lam_b, mu_b


def halo_matvec(op: StencilOperator, u_blocks, mesh, axis=None,
                field_blocks=None):
    """K @ u on the block layout: local stencil apply + two one-plane
    ppermutes to reconcile the shared boundary planes. u_blocks is sharded
    P(axis) on its leading (device) dimension. Heterogeneous per-cell
    materials are supported by passing `field_blocks = fields_to_blocks(op,
    nd)` sharded the same way (cell slabs are disjoint, so no material
    halo is needed)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    if op.lam.ndim != 0 and field_blocks is None:
        raise NotImplementedError(
            "heterogeneous materials need field_blocks=fields_to_blocks(...)"
        )
    axis = axis or mesh.axis_names[0]
    nd = mesh.devices.size
    local_shape = u_blocks.shape[1:-1]  # (c+1, *rest)
    pdim = op.pdim
    local_op = StencilOperator(op.k_lam, op.k_mu, op.lam, op.mu,
                               shape=local_shape)

    def local(ub, *fb):
        slab = ub[0]  # (c+1, *rest, pdim)
        lop = local_op
        if fb:
            lam_l, mu_l = fb[0][0], fb[1][0]
            lop = StencilOperator(op.k_lam, op.k_mu, lam_l, mu_l,
                                  shape=local_shape)
        f = matvec(lop, slab.reshape(-1)).reshape(slab.shape)
        # send my FIRST plane's partial value to the left neighbor, which
        # adds it into its LAST plane (the same physical plane)
        nd_ = jax.lax.axis_size(axis)
        idx = jax.lax.axis_index(axis)
        left = [(i, (i - 1) % nd_) for i in range(nd_)]
        from_right = jax.lax.ppermute(f[0], axis, left)
        summed_last = f[-1] + from_right
        # devices 0..nd-2 get the true value for their last plane; device
        # nd-1's incoming chunk is block 0's first plane (true boundary,
        # no neighbor) — keep its own value there.
        f = f.at[-1].set(jnp.where(idx < nd_ - 1, summed_last, f[-1]))
        # propagate the reconciled plane right so the duplicated first
        # planes match: first plane of d>0 := last plane of d-1
        right = [(i, (i + 1) % nd_) for i in range(nd_)]
        from_left = jax.lax.ppermute(f[-1], axis, right)
        f = f.at[0].set(jnp.where(idx > 0, from_left, f[0]))
        return f[None]

    args = (u_blocks,)
    specs = (P(axis),)
    if field_blocks is not None:
        args = (u_blocks,) + tuple(field_blocks)
        specs = (P(axis), P(axis), P(axis))
    return shard_map(
        local, mesh=mesh, in_specs=specs, out_specs=P(axis),
        check_vma=False,
    )(*args)


def pad_for_devices(op: StencilOperator, nd: int):
    """Pad the leading cell axis to a multiple of nd so the slab-sharded
    paths work on ANY grid (VERDICT r1: matvec_sharded hard-required
    divisibility). Phantom cells get ZERO material (the scalar operator is
    promoted to a per-cell field), so they contribute nothing; phantom node
    planes must be treated as constrained dofs (mask them in the caller —
    their stiffness rows are zero).

    Returns (op_padded, embed, extract): embed maps an (ndof,) vector of
    the original grid to the padded grid (zero fill); extract inverts it.
    """
    cells_x = op.shape[0] - 1
    c = -(-cells_x // nd)
    pad = nd * c - cells_x
    if pad == 0:
        return op, (lambda u: u), (lambda u: u)
    shape_p = (op.shape[0] + pad,) + op.shape[1:]
    rest = tuple(n - 1 for n in op.shape[1:])
    if op.lam.ndim == 0:
        lam_f = jnp.concatenate([
            jnp.broadcast_to(op.lam, (cells_x,) + rest),
            jnp.zeros((pad,) + rest, dtype=op.k_lam.dtype),
        ])
        mu_f = jnp.concatenate([
            jnp.broadcast_to(op.mu, (cells_x,) + rest),
            jnp.zeros((pad,) + rest, dtype=op.k_lam.dtype),
        ])
    else:
        zeros = jnp.zeros((pad,) + rest, dtype=op.lam.dtype)
        lam_f = jnp.concatenate([op.lam, zeros])
        mu_f = jnp.concatenate([op.mu, zeros])
    op_p = StencilOperator(op.k_lam, op.k_mu, lam_f, mu_f, shape=shape_p)
    pdim = op.pdim
    n_real = op.shape[0]

    def embed(u):
        g = u.reshape(*op.shape, pdim)
        gp = jnp.pad(g, ((0, pad),) + ((0, 0),) * pdim)
        return gp.reshape(-1)

    def extract(up):
        gp = up.reshape(*shape_p, pdim)
        return gp[:n_real].reshape(-1)

    return op_p, embed, extract


def diag(op: StencilOperator):
    """Diagonal of K via the same slice-scatter with k_ref's diagonal."""
    pdim = op.pdim
    shape = op.shape
    nn = len(op.offsets)
    if op.lam.ndim == 0:
        k_ref = op.lam * op.k_lam + op.mu * op.k_mu
        dref = jnp.diag(k_ref).reshape(nn, pdim)
        cells = tuple(n - 1 for n in shape)
        dcell = jnp.broadcast_to(dref, (*cells, nn, pdim))
    else:
        d_lam = jnp.diag(op.k_lam).reshape(nn, pdim)
        d_mu = jnp.diag(op.k_mu).reshape(nn, pdim)
        dcell = (
            op.lam[..., None, None] * d_lam + op.mu[..., None, None] * d_mu
        )
    out = jnp.zeros((*shape, pdim), dtype=op.k_lam.dtype)
    for c, off in enumerate(op.offsets):
        out = out.at[_corner_slices(shape, off)].add(dcell[..., c, :])
    return out.reshape(-1)
