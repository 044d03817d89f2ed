"""Dryrun-counted interconnect traffic: the DESIGN.md §5b communication model.

The per-iteration communication model (bytes over the interconnect per
fine-operator apply as a function of mesh size and device count) is
validated by COUNTING the collectives in the traced programs on the 8-way
virtual CPU mesh: walk the jaxpr of each production sharded matvec, collect
every ppermute/psum and its operand bytes, and assert both the count and
the byte total equal the closed-form model. A trace of a run on several devices measures the
time; this pins the bytes (comm-site inventory per SURVEY.md §2c).

Model (3D lattice, n cells/side, p=pdim dofs/node, d devices, itemsize w):
  plane_bytes = (n+1)^2 * p * w                    (one boundary node plane)
  slab stencil halo  (structured.halo_matvec):    2 * plane_bytes / apply
  block-stencil halo (blockstencil.halo_matvec_g): 2 * plane_bytes / apply
  general halo-gather (halo_gather.matvec_cm_sharded):
                      4 * B * p * w / apply        (B = slab-order reach)
  element-DP psum    (parallel/ops.ShardedOperator): one full-vector
                      all-reduce, ndof * w operand (ring cost is
                      2*(d-1)/d of that per device).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from fem_tpu.io import meshgen
from fem_tpu.models.system import System
from fem_tpu.ops import structured
from fem_tpu.ops.stiffness import lame
from fem_tpu.parallel import make_mesh


# the walker lives in fem_tpu/parallel/commcount.py so the multichip
# dryrun can print the same validated inventory (VERDICT r4 next #7)
from fem_tpu.parallel.commcount import collectives  # noqa: E402


def _shard(mesh, blocks):
    return jax.device_put(blocks, NamedSharding(mesh, P(mesh.axis_names[0])))


def test_slab_stencil_halo_two_planes():
    n, nd = 8, 4
    lam, mu = lame(jnp.asarray(70.0), jnp.asarray(0.25))
    op = structured.build((1.0 / n,) * 3, (n + 1,) * 3, lam, mu)
    mesh = make_mesh(nd)
    u = jnp.ones(op.ndof)
    ub = _shard(mesh, structured.to_blocks(op, u, nd))

    cols = collectives(
        lambda x: structured.halo_matvec(op, x, mesh), ub)
    pp = [c for c in cols if c[0] == "ppermute"]
    assert len(pp) == 2, cols
    assert not [c for c in cols if "psum" in c[0]]
    w = jnp.dtype(u.dtype).itemsize
    plane_bytes = (n + 1) ** 2 * op.pdim * w
    assert sum(nb for _, _, nb in pp) == 2 * plane_bytes


def test_blockstencil_halo_two_planes():
    from fem_tpu.ops import blockstencil as bs
    from fem_tpu.solver import amg as amg_mod

    n, nd = 6, 4
    p = meshgen.hex_box_problem(n, n, n, jitter=0.2)
    s = System(p)
    A = amg_mod.assemble_csr(s)
    dims = bs.detect(A, s.pdim, s.ndof // s.pdim)
    op = bs.build(A, s.pdim, dims)
    mesh = make_mesh(nd)
    opp = bs.pad_rows(op, nd)
    u_p = bs.embed_rows_g(jnp.ones((op.pdim,) + op.dims), opp.dims[0])
    vals_b = _shard(mesh, bs.vals_to_slabs(opp, nd))
    u_b = _shard(mesh, bs.u_to_slabs(u_p, nd))
    ml, mr = bs.halo_masks(nd, u_p.dtype)
    ml, mr = _shard(mesh, ml), _shard(mesh, mr)

    cols = collectives(
        lambda vb, ub: bs.halo_matvec_g(opp, vb, ub, mesh, ml, mr),
        vals_b, u_b)
    pp = [c for c in cols if c[0] == "ppermute"]
    assert len(pp) == 2, cols
    assert not [c for c in cols if "psum" in c[0]]
    w = jnp.dtype(u_p.dtype).itemsize
    plane_bytes = int(np.prod(opp.dims[1:])) * op.pdim * w
    assert sum(nb for _, _, nb in pp) == 2 * plane_bytes


def test_halo_gather_four_bands():
    from fem_tpu.parallel import halo_gather as hg

    nd = 8
    p = meshgen.hex_box_problem(12, 6, 6, jitter=0.25, seed=3)
    s = System(p, dtype=jnp.float64)
    op, pos = hg.build(s, nd)
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:nd]), ("shard",))
    op_d = hg.device_put(op, mesh)
    u = jnp.ones(s.ndof)
    up = hg.to_padded_cm(u, pos, nd, op.S, op.pdim)

    cols = collectives(
        lambda x: hg.matvec_cm_sharded(op_d, x, mesh), up)
    pp = [c for c in cols if c[0] == "ppermute"]
    assert len(pp) == 4, cols
    assert not [c for c in cols if "psum" in c[0]]
    w = jnp.dtype(u.dtype).itemsize
    band_bytes = op.B * op.pdim * w
    assert sum(nb for _, _, nb in pp) == 4 * band_bytes


def test_element_dp_one_full_psum():
    from fem_tpu.parallel import ShardedOperator

    p = meshgen.quad_grid_problem(12, 7, E=100.0, nu=0.3,
                                  tip_force=(0.0, -1.0))
    s = System(p)
    mesh = make_mesh(8)
    op = ShardedOperator(s, mesh)
    u = jnp.ones(s.ndof)

    cols = collectives(op.matvec, u)
    ps = [c for c in cols if "psum" in c[0]]
    assert len(ps) == 1, cols
    # the psum operand is the FULL dof vector — the O(ndof) collective the
    # halo layouts exist to avoid
    w = jnp.dtype(u.dtype).itemsize
    assert ps[0][2] == s.ndof * w
