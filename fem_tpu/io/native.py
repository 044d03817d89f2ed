"""ctypes bindings for the native mesh engine (native/libfemmesh.so).

The C++ engine covers the reference's host-side native roles — deck parsing
(m_io.F90), METIS partitioning (m_io.F90:137), element (re)ordering — with
flat-array replacements (flat-array parser, Morton ordering, RCB
partitioning). The library is built from the committed sources at first use
(`make -C native`, plain C ABI), on the machine that loads it. Falls back
cleanly: `available()` is False when no compiler can build it, and every
caller has a pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfemmesh.so")

_MAX_NODES = 8
_TYPE_NAMES = ("tri", "qua", "tet", "hex", "coh")
_TYPE_NN = (3, 4, 4, 8, 4)


class _FemDeck(ctypes.Structure):
    _fields_ = [
        ("stype", ctypes.c_int),
        ("pdim", ctypes.c_int),
        ("nodal_bw", ctypes.c_int),
        ("t", ctypes.c_double),
        ("dt", ctypes.c_double),
        ("nels", ctypes.c_int),
        ("nnds", ctypes.c_int),
        ("nmts", ctypes.c_int),
        ("ncohmats", ctypes.c_int),
        ("nceqs", ctypes.c_int),
        ("nfrcs", ctypes.c_int),
        ("ntrcs", ctypes.c_int),
        ("nbcs", ctypes.c_int),
        ("elem_type", ctypes.POINTER(ctypes.c_int)),
        ("elem_conn", ctypes.POINTER(ctypes.c_int)),
        ("elem_mat", ctypes.POINTER(ctypes.c_int)),
        ("elem_nlmat", ctypes.POINTER(ctypes.c_int)),
        ("coords", ctypes.POINTER(ctypes.c_double)),
        ("mats", ctypes.POINTER(ctypes.c_double)),
        ("coh_law", ctypes.POINTER(ctypes.c_int)),
        ("coh_props", ctypes.POINTER(ctypes.c_double)),
        ("bc_node", ctypes.POINTER(ctypes.c_int)),
        ("bc_flags", ctypes.POINTER(ctypes.c_int)),
        ("bc_vals", ctypes.POINTER(ctypes.c_double)),
        ("f_node", ctypes.POINTER(ctypes.c_int)),
        ("f_vec", ctypes.POINTER(ctypes.c_double)),
        ("f_win", ctypes.POINTER(ctypes.c_double)),
        ("t_el", ctypes.POINTER(ctypes.c_int)),
        ("t_side", ctypes.POINTER(ctypes.c_int)),
        ("t_vec", ctypes.POINTER(ctypes.c_double)),
        ("t_win", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char * 256),
    ]


_lib = None


def build(name: str = "libfemmesh.so") -> str | None:
    """Path of native/<name>, built with `make -C native` if it is missing.

    The build writes a per-process temporary name and renames it into place,
    so concurrent first uses (parallel test workers) never load a partly
    written library. Returns None when the build fails (no compiler)."""
    path = os.path.join(_NATIVE_DIR, name)
    if os.path.exists(path):
        return path
    tmp = f"{name}.tmp{os.getpid()}"
    try:
        subprocess.run(
            ["make", "-s", "-C", _NATIVE_DIR, tmp],
            check=True, capture_output=True,
        )
        os.replace(os.path.join(_NATIVE_DIR, tmp), path)
    except (OSError, subprocess.CalledProcessError):
        return None
    return path


def _load():
    global _lib
    if _lib is None and build() is not None:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.fem_parse_deck_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_FemDeck)
        ]
        lib.fem_parse_deck_file.restype = ctypes.c_int
        lib.fem_parse_deck.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_FemDeck)
        ]
        lib.fem_parse_deck.restype = ctypes.c_int
        lib.fem_free_deck.argtypes = [ctypes.POINTER(_FemDeck)]
        lib.fem_morton_order.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.fem_rcb_partition.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_np(ptr, shape, dtype):
    n = int(np.prod(shape))
    if n == 0:
        return np.zeros(shape, dtype=dtype)
    arr = np.ctypeslib.as_array(ptr, shape=(n,))
    return arr.reshape(shape).astype(dtype, copy=True)


def parse_flat(path_or_text: str) -> dict:
    """Parse a deck with the native engine; returns flat numpy arrays
    (no per-element Python objects — the fast path for large decks)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native mesh engine not built (make -C native)")
    d = _FemDeck()
    if "\n" in path_or_text:
        data = path_or_text.encode()
        rc = lib.fem_parse_deck(data, len(data), ctypes.byref(d))
    else:
        rc = lib.fem_parse_deck_file(path_or_text.encode(), ctypes.byref(d))
    if rc != 0:
        msg = d.error.decode()
        lib.fem_free_deck(ctypes.byref(d))
        raise ValueError(f"native deck parse failed: {msg}")
    try:
        pdim = d.pdim
        f_win = _as_np(d.f_win, (d.nfrcs, 2), float)
        t_win = _as_np(d.t_win, (d.ntrcs, 2), float)
        return dict(
            stype={0: "implicit", 1: "explicit"}.get(d.stype, "other"),
            pdim=pdim,
            nodal_bw=d.nodal_bw,
            t=d.t,
            dt=d.dt,
            nceqs=d.nceqs,
            elem_type=_as_np(d.elem_type, (d.nels,), np.int32),
            elem_conn=_as_np(d.elem_conn, (d.nels, _MAX_NODES), np.int32),
            elem_mat=_as_np(d.elem_mat, (d.nels,), np.int32),
            elem_nlmat=_as_np(d.elem_nlmat, (d.nels,), np.int32),
            coords=_as_np(d.coords, (d.nnds, pdim), float),
            mats=_as_np(d.mats, (d.nmts, 5), float),
            coh_laws=_as_np(d.coh_law, (d.ncohmats,), np.int32),
            coh_props=_as_np(d.coh_props, (d.ncohmats, 6), float),
            bc_node=_as_np(d.bc_node, (d.nbcs,), np.int32),
            bc_flags=_as_np(d.bc_flags, (d.nbcs, pdim), np.int32),
            bc_vals=_as_np(d.bc_vals, (d.nbcs, pdim), float),
            force_node=_as_np(d.f_node, (d.nfrcs,), np.int32),
            force_vec=_as_np(d.f_vec, (d.nfrcs, pdim), float),
            force_t1=f_win[:, 0].copy(),
            force_t2=f_win[:, 1].copy(),
            trac_el=_as_np(d.t_el, (d.ntrcs,), np.int32),
            trac_side=_as_np(d.t_side, (d.ntrcs,), np.int32),
            trac_vec=_as_np(d.t_vec, (d.ntrcs, pdim), float),
            trac_t1=t_win[:, 0].copy(),
            trac_t2=t_win[:, 1].copy(),
        )
    finally:
        lib.fem_free_deck(ctypes.byref(d))


def parse(path_or_text: str):
    """Parse a deck with the native engine; returns a fem_tpu.io.inp.Deck."""
    from fem_tpu.io import inp

    lib = _load()
    if lib is None:
        raise RuntimeError("native mesh engine not built (make -C native)")
    d = _FemDeck()
    if "\n" in path_or_text:
        data = path_or_text.encode()
        rc = lib.fem_parse_deck(data, len(data), ctypes.byref(d))
    else:
        rc = lib.fem_parse_deck_file(path_or_text.encode(), ctypes.byref(d))
    if rc != 0:
        msg = d.error.decode()
        lib.fem_free_deck(ctypes.byref(d))
        raise ValueError(f"native deck parse failed: {msg}")
    try:
        pdim = d.pdim
        conn = _as_np(d.elem_conn, (d.nels, _MAX_NODES), np.int32)
        etype = _as_np(d.elem_type, (d.nels,), np.int32)
        emat = _as_np(d.elem_mat, (d.nels,), np.int32)
        enl = _as_np(d.elem_nlmat, (d.nels,), np.int32)
        elems = []
        for e in range(d.nels):
            name = _TYPE_NAMES[etype[e]]
            nn = _TYPE_NN[etype[e]]
            elems.append(
                inp.RawElement(name, conn[e, :nn].copy(), int(emat[e]), int(enl[e]))
            )
        f_win = _as_np(d.f_win, (d.nfrcs, 2), float)
        t_win = _as_np(d.t_win, (d.ntrcs, 2), float)
        return inp.Deck(
            stype={0: "implicit", 1: "explicit"}.get(d.stype, "other"),
            pdim=pdim,
            nodal_bw=d.nodal_bw,
            t=d.t,
            dt=d.dt,
            nceqs=d.nceqs,
            elements=elems,
            coords=_as_np(d.coords, (d.nnds, pdim), float),
            mats=_as_np(d.mats, (d.nmts, 5), float),
            coh_laws=_as_np(d.coh_law, (d.ncohmats,), np.int32),
            coh_props=_as_np(d.coh_props, (d.ncohmats, 6), float),
            bc_node=_as_np(d.bc_node, (d.nbcs,), np.int32),
            bc_flags=_as_np(d.bc_flags, (d.nbcs, pdim), np.int32),
            bc_vals=_as_np(d.bc_vals, (d.nbcs, pdim), float),
            force_node=_as_np(d.f_node, (d.nfrcs,), np.int32),
            force_vec=_as_np(d.f_vec, (d.nfrcs, pdim), float),
            force_t1=f_win[:, 0].copy(),
            force_t2=f_win[:, 1].copy(),
            trac_el=_as_np(d.t_el, (d.ntrcs,), np.int32),
            trac_side=_as_np(d.t_side, (d.ntrcs,), np.int32),
            trac_vec=_as_np(d.t_vec, (d.ntrcs, pdim), float),
            trac_t1=t_win[:, 0].copy(),
            trac_t2=t_win[:, 1].copy(),
        )
    finally:
        lib.fem_free_deck(ctypes.byref(d))


def morton_order(centroids: np.ndarray) -> np.ndarray:
    """Z-order permutation of elements by centroid (locality-preserving)."""
    lib = _load()
    ne, pdim = centroids.shape
    c = np.ascontiguousarray(centroids, dtype=np.float64)
    out = np.empty(ne, dtype=np.int32)
    if lib is None:
        # Python fallback: quantize + interleave bits via sorting tuples
        mins, maxs = c.min(axis=0), c.max(axis=0)
        span = np.where(maxs > mins, maxs - mins, 1.0)
        bits = 21 if pdim == 3 else 32
        q = ((c - mins) / span * ((1 << bits) - 1)).astype(np.uint64)
        key = np.zeros(ne, dtype=np.uint64)
        for b in range(bits):
            for j in range(pdim):
                key |= ((q[:, j] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                    b * pdim + j
                )
        return np.argsort(key, kind="stable").astype(np.int32)
    lib.fem_morton_order(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ne, pdim,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Equal-count recursive coordinate bisection (METIS replacement)."""
    lib = _load()
    ne, pdim = centroids.shape
    c = np.ascontiguousarray(centroids, dtype=np.float64)
    out = np.empty(ne, dtype=np.int32)
    if lib is None:
        # Python fallback: recursive median splits
        def rec(ids, lo_part, n_parts):
            if n_parts <= 1:
                out[ids] = lo_part
                return
            ext = c[ids].max(axis=0) - c[ids].min(axis=0)
            axis = int(np.argmax(ext))
            left = n_parts // 2
            k = len(ids) * left // n_parts
            order = np.argsort(c[ids, axis], kind="stable")
            ids = ids[order]
            rec(ids[:k], lo_part, left)
            rec(ids[k:], lo_part + left, n_parts - left)

        rec(np.arange(ne), 0, nparts)
        return out
    lib.fem_rcb_partition(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), ne, pdim, nparts,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
