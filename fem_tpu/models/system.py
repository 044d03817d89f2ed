"""Device-side FEM system: assembly, RHS, cohesive residual, stress recovery.

This is the array-first replacement for m_global.F90's PETSc-centric global
layer. The reference scatters per-element dense matrices into a distributed
MatAIJ (main.F90:157-171) and exchanges ghosts through VecScatter
(m_global.F90:549-564); here the whole system lives in device arrays and
assembly is a segment-sum / scatter-add, so "ghost exchange" disappears (or
becomes a psum when sharded — see fem_tpu/parallel).

A System precomputes, per element type block:
  - gathered element coordinates  (ne, nn, pdim)
  - per-element D matrices        (ne, cpdim, cpdim)   [E=0 for mat -1, i.e.
    cohesive elements contribute zero to the elastic K — FormLocalK
    m_global.F90:250-253]
  - batched element stiffness     (ne, ndof, ndof)
  - interleaved dof index arrays  (ne, ndof)
and exposes:
  - dense_K() / matvec(u) / diag()           elastic operator
  - rhs(t_init)                              time-windowed loads (FormRHS)
  - coh_force(u) / coh_stiffness_dense(u)    cohesive terms (applyTract_1 /
                                             applyStiff_1)
  - stress_increment(du)                     nodal-averaged stress recovery
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from fem_tpu.models.problem import Problem
from fem_tpu.ops import cohesive as coh_ops
from fem_tpu.ops import dmat as dmat_ops
from fem_tpu.ops import elements as element_lib
from fem_tpu.ops import stiffness as stiff_ops

PENALTY = 1.0e30  # PENALTY_PARAM (m_global.F90:15)


class System:
    def __init__(self, problem: Problem, dtype=jnp.float64,
                 plane_stress: bool = False):
        """plane_stress: treat 2D elements as plane stress instead of the
        reference's plane strain (a beyond-reference option; the Abaqus
        cross-validation deck uses CPS4 plane-stress elements). Implemented
        exactly via the classical substitution E' = E(1+2nu)/(1+nu)^2,
        nu' = nu/(1+nu), under which every plane-strain formula downstream
        (D, Lame kernels, stress recovery) produces the plane-stress law."""
        self.problem = problem
        self.dtype = dtype
        self.plane_stress = bool(plane_stress) and problem.pdim == 2
        p = problem
        self.pdim = p.pdim
        self.cpdim = 3 if p.pdim == 2 else 6
        self.ndof = p.ndof
        self.nnds = p.nnds

        self.coords = jnp.asarray(p.coords, dtype=dtype)

        # Material table with a zero row appended so mat == -1 (cohesive /
        # unset) indexes E=0, nu=0 — replicating FormLocalK's explicit zeroing.
        mats = np.vstack([p.mats, np.zeros((1, p.mats.shape[1]))])
        if self.plane_stress:
            mats = mats.copy()
            E, nu = mats[:, 0], mats[:, 1]
            mats[:, 0] = E * (1.0 + 2.0 * nu) / (1.0 + nu) ** 2
            mats[:, 1] = nu / (1.0 + nu)
        self._mats = mats

        self.blocks: Dict[str, dict] = {}
        for name, b in p.blocks.items():
            et = b.et
            conn = jnp.asarray(b.conn)
            # Gather element coordinates on the HOST: an eager 10M+-index
            # device gather at setup gains nothing (setup is host-side work
            # per SURVEY.md §2c).
            ecoords = jnp.asarray(p.coords[b.conn], dtype=dtype)
            edofs = stiff_ops.element_dofs(et, conn)
            E = jnp.asarray(mats[b.mat, 0], dtype=dtype)
            nu = jnp.asarray(mats[b.mat, 1], dtype=dtype)
            entry = dict(et=et, conn=conn, ecoords=ecoords, edofs=edofs, E=E, nu=nu)
            if name == "coh":
                # coh elements carry no elastic stiffness (their mat is 0 in
                # the decks -> E=0); skip the kernel entirely instead of
                # assembling a zero block.
                entry["is_coh"] = True
                entry["props"] = jnp.asarray(
                    np.vstack([p.coh_props, np.zeros((1, 6))])[b.nlmat],
                    dtype=dtype,
                )
            else:
                entry["is_coh"] = False
            self.blocks[name] = entry

        # BCs
        self.bc_dofs = jnp.asarray(p.bc_dofs)
        self.bc_vals = jnp.asarray(p.bc_vals, dtype=dtype)
        # Loads
        self.force_dofs = jnp.asarray(p.force_dofs)
        self.force_vec = jnp.asarray(p.force_vec, dtype=dtype)
        self.force_t1 = jnp.asarray(p.force_t1, dtype=dtype)
        self.force_t2 = jnp.asarray(p.force_t2, dtype=dtype)
        self.trac_dofs = jnp.asarray(p.trac_dofs)
        self.trac_nodal_vec = jnp.asarray(p.trac_nodal_vec, dtype=dtype)
        # per-node weights: 0.0 on padding rows of mixed-nps traction tables
        self.trac_node_w = (
            jnp.asarray(p.trac_node_w, dtype=dtype)
            if getattr(p, "trac_node_w", None) is not None
            else jnp.ones(p.trac_dofs.shape[:2], dtype=dtype)
        )
        # FormRHS divides traction windows by dt (m_global.F90:414-415) —
        # a reference quirk, replicated for deck compatibility.
        self.trac_t1 = jnp.asarray(p.trac_t1 / p.dt, dtype=dtype)
        self.trac_t2 = jnp.asarray(p.trac_t2 / p.dt, dtype=dtype)

        self.dt = float(p.dt)
        self.t_total = float(p.t)

    # ---------------- elastic operator ----------------

    def _continuum(self, need_ke: bool = True):
        """Continuum (non-cohesive) blocks with lazily-built per-element
        data. need_ke=False skips materializing the (ne, ndof, ndof)
        element stiffness: stress recovery / creep-state callers only need
        D, and the (ne, ndof, ndof) k_e batch is large (its tiny trailing
        dims can also be padded by the compiler) — at 207k 2D elements it
        once ran a device out of memory after the matrix-free Newton solve
        had already finished without ever needing k_e."""
        out = []
        for name, e in self.blocks.items():
            if e["is_coh"]:
                continue
            if need_ke and "ke" not in e:
                # Lazy: the fused matvec path never materializes k_e; only the
                # dense/stored paths pay for it. Uses the isotropic fast
                # kernel (identical to B^T D B to machine precision).
                e["ke"] = stiff_ops.element_stiffness_isotropic(
                    e["et"], e["ecoords"], e["E"], e["nu"]
                )
            if "D" not in e:
                e["D"] = dmat_ops.dmat(e["E"], e["nu"], self.pdim)
            out.append((name, e))
        return out

    def fused_operator(self):
        """The ops.operator.FusedOperator for this system (cached)."""
        if getattr(self, "_fused_op", None) is None:
            from fem_tpu.ops import operator as op_mod

            self._fused_op = op_mod.build(self)
        return self._fused_op

    def matvec_fused(self, u):
        """K @ u without storing k_e — delegates to ops.operator (sorted
        segment-sum scatter; deterministic reduction order, SURVEY.md §7)."""
        from fem_tpu.ops import operator as op_mod

        return op_mod.matvec(self.fused_operator(), u)

    def diag_fused(self):
        if getattr(self, "_diag_fused", None) is None:
            from fem_tpu.ops import operator as op_mod

            self._diag_fused = op_mod.diag(self.fused_operator())
        return self._diag_fused

    def dense_K(self):
        """Assembled elastic stiffness, no BCs (main.F90:157-168 equivalent).
        Cached: K is constant for the whole run (small-deformation static)."""
        if getattr(self, "_dense_K", None) is None:
            K = jnp.zeros((self.ndof, self.ndof), dtype=self.dtype)
            for _, e in self._continuum():
                edofs = e["edofs"]
                K = K.at[edofs[:, :, None], edofs[:, None, :]].add(e["ke"])
            self._dense_K = K
        return self._dense_K

    def matvec(self, u):
        """Matrix-free K @ u: gather -> batched k_e @ u_e -> scatter-add."""
        out = jnp.zeros(self.ndof, dtype=self.dtype)
        for _, e in self._continuum():
            ue = u[e["edofs"]]  # (ne, ndof_e)
            fe = jnp.einsum("eab,eb->ea", e["ke"], ue)
            out = out.at[e["edofs"].reshape(-1)].add(fe.reshape(-1))
        return out

    def diag(self):
        """Diagonal of K (Jacobi preconditioner)."""
        d = jnp.zeros(self.ndof, dtype=self.dtype)
        for _, e in self._continuum():
            ke_diag = jnp.diagonal(e["ke"], axis1=1, axis2=2)
            d = d.at[e["edofs"].reshape(-1)].add(ke_diag.reshape(-1))
        return d

    # ---------------- loads ----------------

    def rhs(self, t_init):
        """Time-windowed external load vector (FormRHS, m_global.F90:373-436).

        Each step applies the fraction overlap([t_init, t_init+dt], [t1,t2])
        / (t2-t1) of every load (m_global.F90:400-426). BC forcing is NOT
        included here; solvers apply it per bc_mode.
        """
        t_init = jnp.asarray(t_init, dtype=self.dtype)
        t_end = t_init + self.dt
        F = jnp.zeros(self.ndof, dtype=self.dtype)

        if self.force_dofs.shape[0]:
            frac = _window_fraction(t_init, t_end, self.force_t1, self.force_t2)
            contrib = self.force_vec * frac[:, None]
            F = F.at[self.force_dofs.reshape(-1)].add(contrib.reshape(-1))

        if self.trac_dofs.shape[0]:
            frac = _window_fraction(t_init, t_end, self.trac_t1, self.trac_t2)
            contrib = self.trac_nodal_vec * frac[:, None]  # (nt, pdim)
            contrib = contrib[:, None, :] * self.trac_node_w[:, :, None]
            F = F.at[self.trac_dofs.reshape(-1)].add(contrib.reshape(-1))
        return F

    def rhs_cumulative(self, t_end):
        """Total external load applied up to t_end: fraction
        overlap([0, t_end], [t1, t2]) / (t2 - t1) of every load. Used by the
        total-equilibrium formulation (the per-step rhs() fractions sum to
        exactly this)."""
        t_end = jnp.asarray(t_end, dtype=self.dtype)
        zero = jnp.zeros((), dtype=self.dtype)
        F = jnp.zeros(self.ndof, dtype=self.dtype)
        if self.force_dofs.shape[0]:
            frac = _window_fraction(zero, t_end, self.force_t1, self.force_t2)
            contrib = self.force_vec * frac[:, None]
            F = F.at[self.force_dofs.reshape(-1)].add(contrib.reshape(-1))
        if self.trac_dofs.shape[0]:
            frac = _window_fraction(zero, t_end, self.trac_t1, self.trac_t2)
            contrib = self.trac_nodal_vec * frac[:, None]
            contrib = contrib[:, None, :] * self.trac_node_w[:, :, None]
            F = F.at[self.trac_dofs.reshape(-1)].add(contrib.reshape(-1))
        return F

    def bc_step_vals(self):
        """Per-step prescribed displacement: bcval * dt / t — the linear ramp
        (EnforceBCForce, m_global.F90:451)."""
        return self.bc_vals * (self.dt / self.t_total)

    def bc_total_vals(self, t_end):
        """Total prescribed displacement at t_end under the linear ramp."""
        return self.bc_vals * (jnp.asarray(t_end, dtype=self.dtype) / self.t_total)

    # ---------------- cohesive ----------------

    def coh_force(self, u_total, quirks: bool = False):
        """Global cohesive force vector F_coh(u_total) scattered to dofs
        (CalcResidual's applyTract_1 + ApplyNodalForce loop,
        m_global.F90:188-206)."""
        e = self.blocks["coh"]
        ue = u_total[e["edofs"]]
        fe = coh_ops.element_force(e["ecoords"], e["props"], ue, self.dt, quirks)
        out = jnp.zeros(self.ndof, dtype=self.dtype)
        return out.at[e["edofs"].reshape(-1)].add(fe.reshape(-1))

    def coh_stiffness_dense(self, u_total, quirks: bool = False):
        """Dense cohesive tangent contribution (CalcJacobian's applyStiff_1
        scatter, m_global.F90:130-150)."""
        e = self.blocks["coh"]
        ue = u_total[e["edofs"]]
        ke = coh_ops.element_stiffness(e["ecoords"], e["props"], ue, self.dt, quirks)
        K = jnp.zeros((self.ndof, self.ndof), dtype=self.dtype)
        edofs = e["edofs"]
        return K.at[edofs[:, :, None], edofs[:, None, :]].add(ke)

    def coh_matvec(self, u_total, v, quirks: bool = False):
        """Matrix-free cohesive tangent times v."""
        e = self.blocks["coh"]
        ue = u_total[e["edofs"]]
        ke = coh_ops.element_stiffness(e["ecoords"], e["props"], ue, self.dt, quirks)
        fe = jnp.einsum("eab,eb->ea", ke, v[e["edofs"]])
        out = jnp.zeros(self.ndof, dtype=self.dtype)
        return out.at[e["edofs"].reshape(-1)].add(fe.reshape(-1))

    # ---------------- viscoelastic creep ----------------

    def creep_state_init(self):
        """Zero per-integration-point stress state for every continuum block
        with a creeping material (visc > 0): {name: (ne, nip, cpdim)}."""
        state = {}
        for name, e in self._continuum(need_ke=False):
            visc = self._mats[np.asarray(self.problem.blocks[name].mat), 2]
            if (visc > 0).any():
                state[name] = jnp.zeros(
                    (e["conn"].shape[0], e["et"].nip, self.cpdim),
                    dtype=self.dtype,
                )
        return state

    def _creep_D_eff_beta(self, name, sigma_ip):
        """Effective modulus D_eff = (S + dt*beta')^-1 and creep rate beta at
        each ip — the reference's intended implicit creep correction
        (ReformElRHS, m_local.F90:127-145)."""
        from fem_tpu.utils import smallmat

        e = self.blocks[name]
        b = self.problem.blocks[name]
        visc = jnp.asarray(self._mats[np.asarray(b.mat), 2], dtype=self.dtype)
        expn = jnp.asarray(self._mats[np.asarray(b.mat), 3], dtype=self.dtype)
        D = e["D"] if "D" in e else dmat_ops.dmat(e["E"], e["nu"], self.pdim)
        S = jnp.linalg.inv(D)  # (ne, cpdim, cpdim)
        if self.pdim == 2:
            beta = dmat_ops.creep_beta2d(sigma_ip, visc[:, None], expn[:, None])
            betad = dmat_ops.creep_betad2d(sigma_ip, visc[:, None], expn[:, None])
        else:
            beta = dmat_ops.creep_beta3d(sigma_ip, visc[:, None], expn[:, None])
            betad = dmat_ops.creep_betad3d(sigma_ip, visc[:, None], expn[:, None])
        D_eff = jnp.linalg.inv(S[:, None, :, :] + self.dt * betad)
        return D_eff, beta

    def creep_force(self, creep_state):
        """RHS correction f = sum_ip B^T D_eff (dt*beta) w detJ scattered to
        global dofs (the live version of the reference's dead ReformElRHS)."""
        F = jnp.zeros(self.ndof, dtype=self.dtype)
        for name, sigma_ip in creep_state.items():
            e = self.blocks[name]
            et = e["et"]
            D_eff, beta = self._creep_D_eff_beta(name, sigma_ip)
            dNx, detj = stiff_ops.grad_and_detj(et, e["ecoords"])
            B = stiff_ops.bmat(dNx, self.pdim)  # (ne, nip, cpdim, ndof_e)
            w = jnp.asarray(et.weights, dtype=self.dtype)
            scale = detj * w[None, :]
            g = jnp.einsum("eicd,eid->eic", D_eff, self.dt * beta)
            fe = jnp.einsum("eica,eic,ei->ea", B, g, scale)
            F = F.at[e["edofs"].reshape(-1)].add(fe.reshape(-1))
        return F

    def creep_stress_update(self, creep_state, du):
        """Backward-Euler stress update per ip:
        sigma += D_eff (B du - dt beta(sigma))."""
        new_state = {}
        for name, sigma_ip in creep_state.items():
            e = self.blocks[name]
            et = e["et"]
            D_eff, beta = self._creep_D_eff_beta(name, sigma_ip)
            dNx, _ = stiff_ops.grad_and_detj(et, e["ecoords"])
            B = stiff_ops.bmat(dNx, self.pdim)
            ue = du[e["edofs"]]
            eps_inc = jnp.einsum("eica,ea->eic", B, ue)
            dsig = jnp.einsum(
                "eicd,eid->eic", D_eff, eps_inc - self.dt * beta
            )
            new_state[name] = sigma_ip + dsig
        return new_state

    # ---------------- stress ----------------

    def nodal_average_state(self, state_by_block):
        """Nodal average of per-ip stress states {name: (ne, nip, cpdim)}
        (the viscoelastic-mode output field; extrapolation + count-average
        as in stress_increment)."""
        sums = jnp.zeros((self.nnds, self.cpdim), dtype=self.dtype)
        counts = jnp.zeros(self.nnds, dtype=self.dtype)
        for name, sigma_ip in state_by_block.items():
            e = self.blocks[name]
            et = e["et"]
            sig_nodes = stiff_ops.nodal_stress(et, sigma_ip)
            conn_flat = e["conn"].reshape(-1)
            sums = sums.at[conn_flat].add(sig_nodes.reshape(-1, self.cpdim))
            counts = counts.at[conn_flat].add(1.0)
        counts = jnp.maximum(counts, 1.0)
        return sums / counts[:, None]

    def stress_increment(self, du):
        """Nodal-averaged stress from the step increment du.

        Mirrors RecoverStress + RecoverNodalStress + the count/average block
        (m_global.F90:466-515, main.F90:252-291): per-element ip stress from
        the *increment*, extrapolated to nodes, summed per node, divided by
        the number of contributing elements.

        Deviation from the reference (documented): cohesive elements are
        EXCLUDED. The reference runs them through CalcElStress with an
        uninitialized dN (ShapeFuncd has no "coh" branch, m_elems.F90:177-185)
        and an unset stress_at_el (RecoverNodalStress handles neither nip==
        nodecount nor nip==1 for coh) — undefined behavior, not physics.
        Returns (nnds, cpdim).
        """
        sums = jnp.zeros((self.nnds, self.cpdim), dtype=self.dtype)
        counts = jnp.zeros(self.nnds, dtype=self.dtype)
        # Element-sliced: the per-element B/stress intermediates carry tiny
        # trailing dims that a compiler may pad, so one fused pass over a
        # few-hundred-k-element block can demand more device memory than
        # the card has (the k_e sibling of this blowup ran out at 207k 2D
        # elements). Slices
        # bound the padded temp to ~2 GB; at most two program shapes (full
        # slice + remainder) compile.
        CHUNK_E = 65536
        for _, e in self._continuum(need_ke=False):
            et = e["et"]
            ne = e["conn"].shape[0]
            for lo in range(0, ne, CHUNK_E):
                hi = min(lo + CHUNK_E, ne)
                ue = du[e["edofs"][lo:hi]]
                D = e["D"][lo:hi] if e["D"].ndim == 3 else e["D"]
                sig_ip = stiff_ops.element_stress(
                    et, e["ecoords"][lo:hi], ue, D)
                sig_nodes = stiff_ops.nodal_stress(et, sig_ip)
                conn_flat = e["conn"][lo:hi].reshape(-1)
                sums = sums.at[conn_flat].add(
                    sig_nodes.reshape(-1, self.cpdim)
                )
                counts = counts.at[conn_flat].add(1.0)
        counts = jnp.maximum(counts, 1.0)
        return sums / counts[:, None]


def _window_fraction(t_init, t_end, t1, t2):
    """overlap([t_init,t_end],[t1,t2]) / (t2-t1), zero outside the window
    (m_global.F90:400-426). Zero-length windows are guarded to 0 (the
    reference would divide by zero; no shipped deck has them)."""
    applied = jnp.minimum(t2, t_end) - jnp.maximum(t1, t_init)
    width = t2 - t1
    active = jnp.logical_and(t_end >= t1, t_init <= t2)
    frac = jnp.where(
        jnp.logical_and(active, width > 0), applied / jnp.where(width > 0, width, 1.0), 0.0
    )
    return frac
