"""Problem model: struct-of-arrays mesh + loads, host side.

Replaces the reference's array-of-structs `element` type and its global mesh
state (m_elems.F90:6-12, m_global.F90:17-44) with type-batched numpy arrays:
one `Block` per element type holding a dense (ne, nn) connectivity. This is
the layout that vmapped element kernels and segment-sum assembly consume.

Everything here is host-side numpy; `fem_tpu.models.system.System` moves it to
device with the requested dtype/sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from fem_tpu.io import inp
from fem_tpu.ops import elements as element_lib


@dataclasses.dataclass
class Block:
    """All elements of one type, batched."""

    eltype: str
    conn: np.ndarray  # (ne, nn) int32, 0-based global node ids
    mat: np.ndarray  # (ne,) int32, 0-based elastic material id (-1: none)
    nlmat: np.ndarray  # (ne,) int32, 0-based cohesive material id (-1: none)
    eids: np.ndarray  # (ne,) int32, original deck element index

    @property
    def ne(self) -> int:
        return self.conn.shape[0]

    @property
    def et(self) -> element_lib.ElementType:
        return element_lib.get(self.eltype)


@dataclasses.dataclass
class Problem:
    """A parsed, validated, type-batched FEM problem."""

    stype: str
    pdim: int
    t: float
    dt: float
    coords: np.ndarray  # (nnds, pdim)
    blocks: Dict[str, Block]
    mats: np.ndarray  # (nmts, 5)
    coh_laws: np.ndarray
    coh_props: np.ndarray  # (ncohmats, 6)
    # Dirichlet BCs, deduplicated per dof with last-write-wins (the reference
    # INSERTs per bc record: m_global.F90:296,451).
    bc_dofs: np.ndarray  # (nc,) int32 constrained dof ids
    bc_vals: np.ndarray  # (nc,) prescribed total displacement
    # Point forces
    force_dofs: np.ndarray  # (nfrcs, pdim) dof ids per force record
    force_vec: np.ndarray  # (nfrcs, pdim)
    force_t1: np.ndarray
    force_t2: np.ndarray
    # Tractions, precomputed to nodal-force form (ApplyTraction converts a
    # side traction to equal nodal forces vvec*area/nps, m_global.F90:343-368;
    # geometry is static so area/side-nodes are resolved once here).
    trac_dofs: np.ndarray  # (ntrcs, nps, pdim) dof ids
    trac_nodal_vec: np.ndarray  # (ntrcs, pdim) = vec*area/nps
    trac_t1: np.ndarray  # raw deck values (FormRHS divides by dt: m_global.F90:414)
    trac_t2: np.ndarray
    nodal_bw: int = 0
    # Per-record per-node weights (ntrcs, nps_max): 1.0 for real side nodes,
    # 0.0 for padding rows when a deck mixes side node counts (e.g. tet tri
    # faces + hex quad faces). None means "all real" (uniform nps decks and
    # the meshgen builders).
    trac_node_w: Optional[np.ndarray] = None

    @property
    def nnds(self) -> int:
        return self.coords.shape[0]

    @property
    def ndof(self) -> int:
        return self.nnds * self.pdim

    @property
    def nels(self) -> int:
        return sum(b.ne for b in self.blocks.values())

    @property
    def has_cohesive(self) -> bool:
        return self.coh_props.shape[0] > 0 and "coh" in self.blocks

    @property
    def nsteps(self) -> int:
        """Number of load increments: k = 1.. while dt*(k-1) < t
        (main.F90:216-219), replicated with the same float arithmetic."""
        k = 1
        while self.dt * (k - 1) < self.t:
            k += 1
        return k - 1

    @classmethod
    def from_deck(cls, deck: inp.Deck, validate: bool = True) -> "Problem":
        pdim = deck.pdim
        by_type: Dict[str, List[inp.RawElement]] = {}
        ids_by_type: Dict[str, List[int]] = {}
        for i, el in enumerate(deck.elements):
            by_type.setdefault(el.eltype, []).append(el)
            ids_by_type.setdefault(el.eltype, []).append(i)

        blocks: Dict[str, Block] = {}
        for eltype, els in by_type.items():
            et = element_lib.get(eltype)
            if et.pdim != pdim and eltype != "coh":
                raise ValueError(
                    f"{eltype} elements are {et.pdim}D but deck pdim={pdim}"
                )
            blocks[eltype] = Block(
                eltype=eltype,
                conn=np.stack([e.nodes for e in els]).astype(np.int32),
                mat=np.array([e.mat for e in els], dtype=np.int32),
                nlmat=np.array([e.nlmat for e in els], dtype=np.int32),
                eids=np.array(ids_by_type[eltype], dtype=np.int32),
            )

        if validate:
            _validate_mesh(deck.coords, blocks)

        def elem_lookup(eid: int):
            el = deck.elements[eid]
            return el.eltype, el.nodes

        return cls._assemble(
            stype=deck.stype, pdim=pdim, t=deck.t, dt=deck.dt,
            coords=deck.coords, blocks=blocks, mats=deck.mats,
            coh_laws=deck.coh_laws, coh_props=deck.coh_props,
            bc_node=deck.bc_node, bc_flags=deck.bc_flags,
            bc_vals_in=deck.bc_vals,
            force_node=deck.force_node, force_vec=deck.force_vec,
            force_t1=deck.force_t1, force_t2=deck.force_t2,
            trac_el=deck.trac_el, trac_side=deck.trac_side,
            trac_vec=deck.trac_vec, trac_t1=deck.trac_t1,
            trac_t2=deck.trac_t2, nodal_bw=deck.nodal_bw,
            elem_lookup=elem_lookup,
        )

    @classmethod
    def from_flat(cls, f: dict, validate: bool = True) -> "Problem":
        """Build from the native engine's flat arrays (io.native.parse_flat)
        without constructing per-element Python objects."""
        pdim = f["pdim"]
        etypes = f["elem_type"]
        conn = f["elem_conn"]
        blocks: Dict[str, Block] = {}
        from fem_tpu.ops.elements import TYPE_ORDER

        for code, name in enumerate(TYPE_ORDER):
            mask = etypes == code
            if not mask.any():
                continue
            et = element_lib.get(name)
            blocks[name] = Block(
                eltype=name,
                conn=np.ascontiguousarray(conn[mask][:, : et.nnodes]),
                mat=f["elem_mat"][mask],
                nlmat=f["elem_nlmat"][mask],
                eids=np.nonzero(mask)[0].astype(np.int32),
            )
        if validate:
            _validate_mesh(f["coords"], blocks)

        def elem_lookup(eid: int):
            name = TYPE_ORDER[int(etypes[eid])]
            et = element_lib.get(name)
            return name, conn[eid, : et.nnodes]

        return cls._assemble(
            stype=f["stype"], pdim=pdim, t=f["t"], dt=f["dt"],
            coords=f["coords"], blocks=blocks, mats=f["mats"],
            coh_laws=f["coh_laws"], coh_props=f["coh_props"],
            bc_node=f["bc_node"], bc_flags=f["bc_flags"],
            bc_vals_in=f["bc_vals"],
            force_node=f["force_node"], force_vec=f["force_vec"],
            force_t1=f["force_t1"], force_t2=f["force_t2"],
            trac_el=f["trac_el"], trac_side=f["trac_side"],
            trac_vec=f["trac_vec"], trac_t1=f["trac_t1"],
            trac_t2=f["trac_t2"], nodal_bw=f["nodal_bw"],
            elem_lookup=elem_lookup,
        )

    @classmethod
    def _assemble(cls, *, stype, pdim, t, dt, coords, blocks, mats, coh_laws,
                  coh_props, bc_node, bc_flags, bc_vals_in, force_node,
                  force_vec, force_t1, force_t2, trac_el, trac_side, trac_vec,
                  trac_t1, trac_t2, nodal_bw, elem_lookup) -> "Problem":
        # BC dof table, vectorized, last write wins per dof (the reference
        # INSERTs per bc record: m_global.F90:296,451).
        constrained = bc_flags == 0  # BC_PRESENT
        rec, comp = np.nonzero(constrained)
        dofs = bc_node[rec].astype(np.int64) * pdim + comp
        vals = bc_vals_in[rec, comp]
        if dofs.size:
            uniq, inv = np.unique(dofs, return_inverse=True)
            last = np.full(uniq.shape[0], -1)
            np.maximum.at(last, inv, np.arange(dofs.shape[0]))
            bc_dofs = uniq.astype(np.int32)
            bc_vals = vals[last]
        else:
            bc_dofs = np.zeros(0, dtype=np.int32)
            bc_vals = np.zeros(0)

        force_dofs = (
            force_node[:, None].astype(np.int64) * pdim
            + np.arange(pdim)[None, :]
        ).astype(np.int32)

        # Tractions -> static nodal-force form (ApplyTraction converts a side
        # traction to equal nodal forces vvec*area/nps, m_global.F90:343-368).
        ntrcs = trac_el.shape[0]
        trac_node_w = None
        if ntrcs:
            # Size by the MAX side node count over all records: a 3D deck may
            # mix tri faces (3 nodes) and quad faces (4 nodes) (ADVICE r1).
            # Padded rows point at dof 0 with weight 0.0.
            nps_max = max(
                element_lib.get(elem_lookup(int(e))[0]).nps for e in trac_el
            )
            trac_dofs = np.zeros((ntrcs, nps_max, pdim), dtype=np.int32)
            trac_nodal = np.zeros((ntrcs, pdim))
            trac_node_w = np.zeros((ntrcs, nps_max))
            for i in range(ntrcs):
                name, nodes = elem_lookup(int(trac_el[i]))
                et = element_lib.get(name)
                side = int(trac_side[i]) - 1
                snodes = nodes[et.sides[side]]
                area = _side_area(coords[snodes])
                trac_nodal[i] = trac_vec[i] * area / et.nps
                trac_dofs[i, : et.nps] = (
                    snodes[:, None].astype(np.int64) * pdim
                    + np.arange(pdim)[None, :]
                )
                trac_node_w[i, : et.nps] = 1.0
        else:
            trac_dofs = np.zeros((0, 2, pdim), dtype=np.int32)
            trac_nodal = np.zeros((0, pdim))

        return cls(
            stype=stype, pdim=pdim, t=t, dt=dt, coords=coords, blocks=blocks,
            mats=mats, coh_laws=coh_laws, coh_props=coh_props,
            bc_dofs=bc_dofs, bc_vals=bc_vals, force_dofs=force_dofs,
            force_vec=force_vec, force_t1=force_t1, force_t2=force_t2,
            trac_dofs=trac_dofs, trac_nodal_vec=trac_nodal,
            trac_t1=trac_t1, trac_t2=trac_t2, nodal_bw=nodal_bw,
            trac_node_w=trac_node_w,
        )


def _side_area(pts: np.ndarray) -> float:
    """Side measure: edge length (2D, 2 nodes), tri area (3 nodes), quad area
    (4 nodes) — EdgeAreaNodes* (m_elems.F90:282-293,366-378,469-482,583-599)."""
    n, d = pts.shape
    if n == 2:
        return float(np.linalg.norm(pts[0] - pts[1]))
    p = np.pad(pts, ((0, 0), (0, 3 - d))) if d < 3 else pts
    if n == 3:
        return float(0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0])))
    if n == 4:
        a1 = 0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
        a2 = 0.5 * np.linalg.norm(np.cross(p[2] - p[0], p[3] - p[0]))
        return float(a1 + a2)
    raise ValueError(f"unsupported side node count {n}")


def _validate_mesh(coords: np.ndarray, blocks: Dict[str, Block]) -> None:
    """Fail fast on out-of-range ids; warn on inverted/degenerate continuum
    elements (which the reference lets through silently, producing
    negative-definite or NaN stiffness)."""
    import warnings

    nnds = coords.shape[0]
    for b in blocks.values():
        if b.conn.min() < 0 or b.conn.max() >= nnds:
            raise ValueError(
                f"{b.eltype}: node id out of range [1, {nnds}] in deck"
            )
        if b.eltype == "coh":
            continue
        et = b.et
        ecoords = coords[b.conn]  # (ne, nn, pdim)
        dN = et.dN  # (nip, pdim, nn)
        jac = np.einsum("ipn,end->eipd", dN, ecoords)
        detj = np.linalg.det(jac)
        if (detj <= 0).any():
            bad = int((detj.min(axis=1) <= 0).sum())
            warnings.warn(
                f"{bad} {b.eltype} element(s) have non-positive Jacobian "
                "(inverted or degenerate); stiffness will be wrong",
                stacklevel=2,
            )


def load(path_or_text, backend: str = "auto") -> Problem:
    """Parse a deck and build the Problem in one call.

    backend: "auto" uses the native C++ parser (native/libfemmesh.so) when
    built, else the pure-Python one; "python"/"native" force a choice.
    """
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown parser backend {backend!r}")
    if backend != "python":
        from fem_tpu.io import native

        if native.available():
            return Problem.from_flat(native.parse_flat(str(path_or_text)))
        if backend == "native":
            raise RuntimeError("native mesh engine not built (make -C native)")
    return Problem.from_deck(inp.parse(path_or_text))
