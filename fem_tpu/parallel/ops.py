"""Sharded matrix-free FEM operators (shard_map + collectives).

Replaces the reference's METIS partitioning + PETSc distributed assembly
(PartitionBroadcast m_io.F90:107-143, DistributeElements m_io.F90:200-237,
MatAssembly/VecScatter comms) with SPMD element sharding:

  - every element-type batch (k_e, dof indices) is sharded along the 1D
    device mesh axis ("domain decomposition" without any explicit send/recv);
  - the displacement vector is replicated (it is small relative to element
    data: ndof ~ nodes*pdim, while element data is O(ne*ndof_e^2));
  - the matvec is: local gather -> batched k_e @ u_e -> local scatter-add
    -> jax.lax.psum over the axis. The psum is exactly the shared-node
    reduction PETSc performed in MatAssembly (SURVEY.md §2c), over the interconnect.

Partition quality does not matter here (unlike METIS): every device does
identical dense batched work, and the reduction cost is O(ndof) independent
of the partition, so plain block sharding is optimal. Load balance comes from
padding each type batch to a multiple of the axis size.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from fem_tpu.models.system import System
from fem_tpu.parallel.mesh import AXIS, make_mesh


def _pad_to_multiple(a: jnp.ndarray, m: int) -> jnp.ndarray:
    ne = a.shape[0]
    pad = (-ne) % m
    if pad == 0:
        return a
    widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, widths)


class ShardedOperator:
    """Element-sharded elastic operator over a 1D device mesh.

    Supports the two vector layouts from SURVEY.md §2c:
      - replicated DOF vector (default): matvec output psum'd to all devices;
      - use `matvec` inside jit; CG vector algebra stays replicated.
    """

    def __init__(self, system: System, mesh: Optional[Mesh] = None,
                 mode: str = "fused"):
        """mode="fused" shards (dNx, scale, lam, mu) per element and runs the
        fused isotropic internal-force kernel (3x less element data than
        stored k_e, fewer flops); mode="ke" shards the precomputed k_e."""
        self.system = system
        self.mesh = mesh or make_mesh()
        self.axis = self.mesh.axis_names[0]
        self.mode = mode
        nd = self.mesh.devices.size
        self.ndof = system.ndof

        elem_sharding = NamedSharding(self.mesh, P(self.axis))

        def shard(a):
            return jax.device_put(_pad_to_multiple(a, nd), elem_sharding)

        axis = self.axis
        mesh = self.mesh
        ndof = self.ndof
        self.blocks = []
        self._mv_fns = []
        self._diag_fns = []
        if mode == "ke":
            for name, e in system._continuum():
                self.blocks.append((shard(e["ke"]), shard(e["edofs"])))

            def local_mv(ke, edofs, u):
                fe = jnp.einsum("eab,eb->ea", ke, u[edofs])
                out = jnp.zeros(ndof, dtype=u.dtype)
                out = out.at[edofs.reshape(-1)].add(fe.reshape(-1))
                return jax.lax.psum(out, axis)

            def local_diag(ke, edofs):
                d = jnp.diagonal(ke, axis1=1, axis2=2)
                out = jnp.zeros(ndof, dtype=ke.dtype)
                out = out.at[edofs.reshape(-1)].add(d.reshape(-1))
                return jax.lax.psum(out, axis)

            self._mv = shard_map(local_mv, mesh=mesh,
                                 in_specs=(P(axis), P(axis), P()),
                                 out_specs=P())
            self._dg = shard_map(local_diag, mesh=mesh,
                                 in_specs=(P(axis), P(axis)),
                                 out_specs=P())
        else:
            from fem_tpu.ops import operator as op_mod

            # Shard the element-batch-LAST fused blocks along their last axis.
            def shard_last(a):
                ne = a.shape[-1]
                pad = (-ne) % nd
                if pad:
                    widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
                    a = jnp.pad(a, widths)
                spec = P(*([None] * (a.ndim - 1) + [self.axis]))
                return jax.device_put(a, NamedSharding(self.mesh, spec))

            full_op = system.fused_operator()
            for b in full_op.blocks:
                self.blocks.append(
                    op_mod.FusedBlock(
                        edofs_t=shard_last(b.edofs_t),
                        conn_t=shard_last(b.conn_t),
                        dNx=shard_last(b.dNx),
                        scale=shard_last(b.scale),
                        lam=shard_last(b.lam),
                        mu=shard_last(b.mu),
                    )
                )

            def local_mv(b, u):
                fe = op_mod.block_force(b, u)
                out = jnp.zeros(ndof, dtype=u.dtype)
                out = out.at[b.edofs_t.reshape(-1)].add(fe.reshape(-1))
                return jax.lax.psum(out, axis)

            def local_diag(b):
                hd = jnp.einsum("ie,ipae,ipae->pae", b.scale, b.dNx, b.dNx)
                tot = jnp.sum(hd, axis=0)
                dv = (
                    (b.lam + b.mu)[None, None, :] * jnp.swapaxes(hd, 0, 1)
                    + b.mu[None, None, :] * tot[:, None, :]
                )
                out = jnp.zeros(ndof, dtype=b.dNx.dtype)
                out = out.at[b.edofs_t.reshape(-1)].add(dv.reshape(-1))
                return jax.lax.psum(out, axis)

            def block_spec(b):
                return op_mod.FusedBlock(
                    edofs_t=P(None, axis),
                    conn_t=P(None, axis),
                    dNx=P(None, None, None, axis),
                    scale=P(None, axis),
                    lam=P(axis),
                    mu=P(axis),
                )

            self._mv_fns = [
                shard_map(local_mv, mesh=mesh,
                          in_specs=(block_spec(b), P()), out_specs=P())
                for b in self.blocks
            ]
            self._diag_fns = [
                shard_map(local_diag, mesh=mesh,
                          in_specs=(block_spec(b),), out_specs=P())
                for b in self.blocks
            ]

    def matvec(self, u, blocks=None):
        """K @ u. `blocks` lets callers pass the sharded element data as a
        jit ARGUMENT instead of a traced closure constant (embedding the
        arrays in HLO blows up program size)."""
        blocks = self.blocks if blocks is None else blocks
        out = jnp.zeros(self.ndof, dtype=u.dtype)
        if self.mode == "ke":
            for ke, edofs in blocks:
                out = out + self._mv(ke, edofs, u)
        else:
            for fn, b in zip(self._mv_fns, blocks):
                out = out + fn(b, u)
        return out

    def diag(self, blocks=None):
        blocks = self.blocks if blocks is None else blocks
        d = jnp.zeros(self.ndof, dtype=self.system.dtype)
        if self.mode == "ke":
            for ke, edofs in blocks:
                d = d + self._dg(ke, edofs)
        else:
            for fn, b in zip(self._diag_fns, blocks):
                d = d + fn(b)
        return d


def solve_step_sharded(system: System, op: ShardedOperator, t_init,
                       du0=None, rtol: float = 1e-9, maxiter: int = 0):
    """One elastic load increment with the sharded operator: RHS, eliminated
    BCs, Jacobi-PCG, stress recovery. jit-compatible end to end."""
    from fem_tpu.solver import cg

    F = system.rhs(t_init)
    res = cg.solve_eliminated(
        op.matvec,
        F,
        op.diag(),
        system.bc_dofs,
        system.bc_step_vals(),
        x0=du0,
        rtol=rtol,
        maxiter=maxiter,
    )
    stress = system.stress_increment(res.x)
    return res.x, stress, res.iters
