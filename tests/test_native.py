"""Native mesh engine (native/libfemmesh.so) vs the pure-Python reference
implementations: deck parsing must agree field-for-field; Morton ordering
and RCB partitioning must be valid and balanced."""

import os

import numpy as np
import pytest

from fem_tpu.io import inp, meshgen, native

from tests.deckpaths import REF

@pytest.fixture
def built_native():
    """Build the engine on first use; decided per test, never at import."""
    if not native.available():
        pytest.skip("native engine cannot be built (make -C native)")


needs_native = pytest.mark.usefixtures("built_native")

DECKS = [
    f"{REF}/SNES_test/elastic/elastic_test.inp",
    f"{REF}/cohesive_test_2.inp",
    f"{REF}/lin_two_quads_qs.inp",
    f"{REF}/SNES_test/cohesive_test/cohesive_test_2.inp",
]


@needs_native
@pytest.mark.parametrize("deck", [d for d in DECKS if os.path.exists(d)])
def test_native_parse_matches_python(deck):
    a = inp.parse(deck)
    b = native.parse(deck)
    assert (a.stype, a.pdim, a.nodal_bw) == (b.stype, b.pdim, b.nodal_bw)
    assert (a.t, a.dt) == (b.t, b.dt)
    assert len(a.elements) == len(b.elements)
    for ea, eb in zip(a.elements, b.elements):
        assert ea.eltype == eb.eltype
        np.testing.assert_array_equal(ea.nodes, eb.nodes)
        assert (ea.mat, ea.nlmat) == (eb.mat, eb.nlmat)
    for field in (
        "coords", "mats", "coh_props", "bc_node", "bc_flags", "bc_vals",
        "force_node", "force_vec", "force_t1", "force_t2",
        "trac_el", "trac_side", "trac_vec", "trac_t1", "trac_t2",
    ):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@needs_native
def test_native_parse_generated_strip():
    text = meshgen.quad_strip_deck(20, 5)
    a = inp.parse(text)
    b = native.parse(text)
    assert len(a.elements) == len(b.elements) == 100
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.force_node, b.force_node)


@needs_native
def test_native_parse_trailing_tokens_per_record():
    """Legal decks may carry trailing extra tokens on any fixed-count record
    line (the reference's list-directed READ advances one record per line) —
    the native parser must not desync on them (ADVICE r1)."""
    deck = (
        "implicit 2 1 extra junk\n"
        "1 4 1 0 0 1 0 2\n"
        "1.0 0.5 10 ascii\n"
        "qua 1 2 3 4 1 0\n"
        "0.0 0.0 999\n"
        "1.0 0.0 888 777\n"
        "1.0 1.0 ! comment\n"
        "0.0 1.0 trailing\n"
        "100.0 0.3 0.0 0.0 1.0 extra-mat-token\n"
        "1 0 0 0.0 0.0 42\n"
        "2 0 1 0.0 0.0 43 44\n"
        "3 1.0 2.0 0.0 1.0 junk\n"
    )
    a = inp.parse(deck)
    b = native.parse(deck)
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.mats, b.mats)
    np.testing.assert_array_equal(a.bc_node, b.bc_node)
    np.testing.assert_array_equal(a.bc_flags, b.bc_flags)
    np.testing.assert_array_equal(a.bc_vals, b.bc_vals)
    np.testing.assert_array_equal(a.force_node, b.force_node)
    np.testing.assert_array_equal(a.force_vec, b.force_vec)
    assert b.coords[1, 0] == 1.0 and b.coords[1, 1] == 0.0


@needs_native
def test_native_parse_error_messages():
    with pytest.raises(ValueError, match="unknown element type"):
        native.parse("implicit 2 1\n1 3 1 0 0 0 0 0\n1.0 1.0\nquux 1 2 3 1 0\n")
    with pytest.raises(ValueError, match="node id out of range"):
        native.parse("implicit 2 1\n1 3 1 0 0 0 0 0\n1.0 1.0\ntri 1 2 9 1 0\n")


def test_morton_order_is_permutation_and_local():
    rng = np.random.default_rng(0)
    c = rng.uniform(size=(500, 3))
    order = native.morton_order(c)
    assert sorted(order.tolist()) == list(range(500))
    # locality: mean distance between Morton-adjacent centroids should be
    # far below that of random ordering
    d_sorted = np.linalg.norm(np.diff(c[order], axis=0), axis=1).mean()
    d_orig = np.linalg.norm(np.diff(c, axis=0), axis=1).mean()
    assert d_sorted < 0.6 * d_orig


@pytest.mark.parametrize("nparts", [2, 3, 8])
def test_rcb_partition_balance(nparts):
    rng = np.random.default_rng(1)
    c = rng.uniform(size=(1000, 2))
    part = native.rcb_partition(c, nparts)
    counts = np.bincount(part, minlength=nparts)
    assert counts.max() - counts.min() <= 1
    # spatial compactness: parts should have smaller bounding boxes than the
    # whole domain
    for p in range(nparts):
        ext = c[part == p].max(axis=0) - c[part == p].min(axis=0)
        assert ext.prod() < 0.75


def test_load_backend_dispatch():
    from fem_tpu.models import problem as pm

    deck = meshgen.quad_strip_deck(3, 1)
    a = pm.load(deck, backend="python")
    b = pm.load(deck, backend="auto")
    assert a.nels == b.nels
    np.testing.assert_array_equal(a.coords, b.coords)
