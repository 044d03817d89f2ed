"""Unit tests for the batched element kernels (stiffness, stress, cohesive).

Checks against closed-form values and reference-derived identities:
  - quad4 unit-square plane-strain stiffness vs an independent dense-loop
    computation (the reference algorithm FormElKE, m_local.F90:21-67,
    re-derived in numpy here — not copied).
  - rigid-body motion produces zero strain energy / zero stress.
  - constant-strain patch test: linear displacement field -> exact stress.
  - cohesive analytic tangent == jacfwd of the traction force.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.ops import cohesive, dmat, elements, stiffness


def _numpy_quad_ke(coords, E, nu):
    """Independent per-ip loop implementation for cross-checking."""
    et = elements.get("qua")
    c = E / ((1 + nu) * (1 - 2 * nu))
    D = c * np.array(
        [[1 - nu, nu, 0], [nu, 1 - nu, 0], [0, 0, (1 - 2 * nu) / 2]]
    )
    ke = np.zeros((8, 8))
    for i in range(et.nip):
        dN = et.dN[i]  # (2,4)
        J = dN @ coords
        detj = np.linalg.det(J)
        dNx = np.linalg.inv(J) @ dN
        B = np.zeros((3, 8))
        for j in range(4):
            B[0, 2 * j] = dNx[0, j]
            B[1, 2 * j + 1] = dNx[1, j]
            B[2, 2 * j] = dNx[1, j]
            B[2, 2 * j + 1] = dNx[0, j]
        ke += B.T @ D @ B * et.weights[i] * detj
    return ke


def test_quad_stiffness_matches_loop_reference():
    et = elements.get("qua")
    coords = np.array([[0.0, 0.0], [2.0, 0.1], [2.2, 1.9], [-0.1, 2.0]])
    E, nu = 3640.0, 0.3
    D = dmat.dmat2d(jnp.array([E]), jnp.array([nu]))
    ke = stiffness.element_stiffness(et, jnp.asarray(coords)[None], D)[0]
    np.testing.assert_allclose(np.asarray(ke), _numpy_quad_ke(coords, E, nu), rtol=1e-12)


def test_stiffness_symmetry_and_rigid_modes():
    et = elements.get("qua")
    coords = jnp.array([[[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]])
    D = dmat.dmat2d(jnp.array([100.0]), jnp.array([0.25]))
    ke = stiffness.element_stiffness(et, coords, D)[0]
    np.testing.assert_allclose(ke, ke.T, atol=1e-12)
    # translations in x and y are null vectors
    tx = jnp.array([1.0, 0.0] * 4)
    ty = jnp.array([0.0, 1.0] * 4)
    np.testing.assert_allclose(ke @ tx, 0.0, atol=1e-10)
    np.testing.assert_allclose(ke @ ty, 0.0, atol=1e-10)
    # small rotation about origin: u = theta * (-y, x)
    rot = jnp.array([0.0, 0.0, 0.0, 1.0, -1.0, 1.0, -1.0, 0.0]) * 1e-3
    np.testing.assert_allclose(ke @ rot, 0.0, atol=1e-10)


@pytest.mark.parametrize("name", ["tri", "qua"])
def test_patch_constant_strain_2d(name):
    # u = (a x + b y, c x + d y) -> eps = (a, d, b + c) exactly at every ip.
    et = elements.get(name)
    if name == "tri":
        coords = np.array([[0.0, 0.0], [1.3, 0.1], [0.2, 1.1]])
    else:
        coords = np.array([[0.0, 0.0], [1.3, 0.1], [1.4, 1.2], [0.1, 1.1]])
    a, b, c, d = 0.1, -0.2, 0.3, 0.05
    u = np.stack([a * coords[:, 0] + b * coords[:, 1],
                  c * coords[:, 0] + d * coords[:, 1]], axis=1).reshape(-1)
    E, nu = 200.0, 0.3
    D = dmat.dmat2d(jnp.array([E]), jnp.array([nu]))
    sig = stiffness.element_stress(
        et, jnp.asarray(coords)[None], jnp.asarray(u)[None], D
    )[0]
    eps = np.array([a, d, b + c])
    expect = np.asarray(dmat.dmat2d(E, nu)) @ eps
    np.testing.assert_allclose(np.asarray(sig), np.tile(expect, (et.nip, 1)), rtol=1e-12)


def test_patch_constant_strain_hex8():
    et = elements.get("hex")
    coords = np.array(
        [
            [0, 0, 0],
            [1.1, 0, 0],
            [1.2, 1.0, 0.1],
            [0, 1.1, 0],
            [0.1, 0, 1.2],
            [1.0, 0.1, 1.1],
            [1.1, 1.2, 1.3],
            [0, 1.0, 1.0],
        ],
        dtype=float,
    )
    G = np.array([[0.1, -0.02, 0.03], [0.04, 0.2, -0.01], [0.02, 0.05, -0.1]])
    u = (coords @ G.T).reshape(-1)
    E, nu = 70.0, 0.33
    D = dmat.dmat3d(jnp.array([E]), jnp.array([nu]))
    sig = stiffness.element_stress(
        et, jnp.asarray(coords)[None], jnp.asarray(u)[None], D
    )[0]
    eps = np.array(
        [
            G[0, 0],
            G[1, 1],
            G[2, 2],
            G[0, 1] + G[1, 0],
            G[1, 2] + G[2, 1],
            G[0, 2] + G[2, 0],
        ]
    )
    expect = np.asarray(dmat.dmat3d(E, nu)) @ eps
    np.testing.assert_allclose(np.asarray(sig), np.tile(expect, (et.nip, 1)), rtol=1e-10)


def test_hex8_stiffness_rigid_modes():
    et = elements.get("hex")
    coords = jnp.array(
        [
            [
                [0, 0, 0],
                [1, 0, 0],
                [1, 1, 0],
                [0, 1, 0],
                [0, 0, 1],
                [1, 0, 1],
                [1, 1, 1],
                [0, 1, 1],
            ]
        ],
        dtype=jnp.float64,
    )
    D = dmat.dmat3d(jnp.array([10.0]), jnp.array([0.3]))
    ke = stiffness.element_stiffness(et, coords, D)[0]
    np.testing.assert_allclose(ke, ke.T, atol=1e-12)
    for axis in range(3):
        t = np.zeros(24)
        t[axis::3] = 1.0
        np.testing.assert_allclose(ke @ jnp.asarray(t), 0.0, atol=1e-10)


def test_element_dofs_interleaving():
    et = elements.get("qua")
    conn = jnp.array([[3, 0, 7, 5]])
    dofs = stiffness.element_dofs(et, conn)[0]
    np.testing.assert_array_equal(
        np.asarray(dofs), [6, 7, 0, 1, 14, 15, 10, 11]
    )


# ---------------- cohesive ----------------


def _coh_setup():
    # unit-length horizontal cohesive element: bottom nodes (0,0),(1,0),
    # top nodes (1,0),(0,0) — mirroring cohesive_test_2.inp's coh 3 7 8 5
    # topology where top/bottom coincide initially.
    ecoords = jnp.array([[[0.0, 0.0], [1.0, 0.0], [1.0, 0.0], [0.0, 0.0]]])
    props = jnp.array([[100.0, 0.01, 0.01, 1.0, 0.0, 0.0]])
    return ecoords, props


def test_cohesive_geometry():
    ecoords, _ = _coh_setup()
    tangent, normal, det = cohesive.geometry(ecoords)
    np.testing.assert_allclose(np.asarray(tangent), [[1.0, 0.0]], atol=1e-15)
    np.testing.assert_allclose(np.asarray(normal), [[0.0, 1.0]], atol=1e-15)
    np.testing.assert_allclose(np.asarray(det), [0.5], atol=1e-15)


def test_cohesive_gap_sign():
    # opening the top by +dy gives a positive normal gap at both ips
    ecoords, _ = _coh_setup()
    dy = 1e-3
    ue = jnp.array([[0.0, 0.0, 0.0, 0.0, 0.0, dy, 0.0, dy]])
    gap_n, gap_t, vgap_n, vgap_t, *_ = cohesive.gaps(ecoords, ue, dt=0.1)
    np.testing.assert_allclose(np.asarray(gap_n), dy, rtol=1e-14)
    np.testing.assert_allclose(np.asarray(gap_t), 0.0, atol=1e-16)
    np.testing.assert_allclose(np.asarray(vgap_n), dy / 0.1, rtol=1e-14)


def test_xu_needleman_peak_traction():
    # T_n(delta_n) = sigma_max for pure normal opening at gap = delta_n
    # (definition of the law: peak stress at the characteristic length).
    props = jnp.array([100.0, 0.01, 0.01, 1.0, 0.0, 0.0])
    t_n, t_t = cohesive.xu_needleman_traction(
        props, jnp.array(0.01), jnp.array(0.0), jnp.array(0.0)
    )
    np.testing.assert_allclose(float(t_n), 100.0, rtol=1e-12)
    np.testing.assert_allclose(float(t_t), 0.0, atol=1e-14)


def test_cohesive_analytic_tangent_matches_autodiff():
    ecoords, props = _coh_setup()
    rng = np.random.default_rng(0)
    ue = jnp.asarray(rng.normal(size=(1, 8)) * 1e-3)
    dt = 0.05
    k_analytic = cohesive.element_stiffness(ecoords, props, ue, dt)
    k_ad = cohesive.element_stiffness_ad(ecoords, props, ue, dt)
    np.testing.assert_allclose(
        np.asarray(k_analytic), np.asarray(k_ad), rtol=1e-9, atol=1e-9
    )


def test_cohesive_tangent_with_viscosity_matches_autodiff():
    ecoords, _ = _coh_setup()
    props = jnp.array([[100.0, 0.01, 0.02, 0.8, 0.0, 0.5]])
    rng = np.random.default_rng(1)
    ue = jnp.asarray(rng.normal(size=(1, 8)) * 1e-3)
    dt = 0.01
    k_analytic = cohesive.element_stiffness(ecoords, props, ue, dt)
    k_ad = cohesive.element_stiffness_ad(ecoords, props, ue, dt)
    np.testing.assert_allclose(
        np.asarray(k_analytic), np.asarray(k_ad), rtol=1e-9, atol=1e-9
    )


def test_cohesive_force_equilibrium():
    # total force on bottom nodes == -(total force on top nodes)
    ecoords, props = _coh_setup()
    ue = jnp.array([[0.0, 0.0, 0.0, 0.0, 1e-3, 2e-3, -1e-3, 2e-3]])
    f = np.asarray(cohesive.element_force(ecoords, props, ue, dt=0.1))[0]
    bottom = f[:4].reshape(2, 2).sum(axis=0)
    top = f[4:].reshape(2, 2).sum(axis=0)
    np.testing.assert_allclose(bottom, -top, atol=1e-15)


def test_cohesive_quirks_stiffness_matches_reference_loop():
    """quirks=True must replicate the reference's precedence bug bit-for-bit
    (m_global.F90:829-831): the UNSCALED term is
    (k_nn n_d1 + k_tn t_d1) * n_d2 — dof1 carries the k-column combination,
    dof2 carries n (not the transpose; ADVICE r1). Checked against a direct
    numpy transcription of the Fortran loop nest."""
    ecoords, props = _coh_setup()
    rng = np.random.default_rng(5)
    ue = jnp.asarray(rng.normal(size=(1, 8)) * 1e-3)
    dt = 0.05

    gap_n, gap_t, _, _, tangent, normal, det = (
        np.asarray(a) for a in cohesive.gaps(ecoords, ue, dt)
    )
    k_nn, k_tt, k_nt = (
        np.asarray(a)
        for a in cohesive.xu_needleman_stiffness(
            props[:, None, :], jnp.asarray(gap_n), jnp.asarray(gap_t), dt
        )
    )
    N = np.asarray(cohesive._COH.N)  # (nip, 4)
    w = np.asarray(cohesive._COH.weights)
    sig = [1.0, 1.0, -1.0, -1.0]
    n, t = normal[0], tangent[0]
    expected = np.zeros((8, 8))
    for j in range(N.shape[0]):
        knn, ktt, knt = k_nn[0, j], k_tt[0, j], k_nt[0, j]
        for a in range(4):
            for b in range(4):
                for d1 in range(2):
                    for d2 in range(2):
                        expected[a * 2 + d1, b * 2 + d2] += (
                            (knn * n[d1] + knt * t[d1]) * n[d2]
                        ) + (
                            (knt * n[d1] + ktt * t[d1]) * t[d2]
                        ) * sig[a] * sig[b] * N[j, a] * N[j, b] * w[j] * det[0]
    ke = np.asarray(
        cohesive.element_stiffness(ecoords, props, ue, dt, quirks=True)
    )[0]
    np.testing.assert_allclose(ke, expected, rtol=1e-12, atol=1e-18)


def test_cohesive_quirks_mode_last_ip_only():
    ecoords, props = _coh_setup()
    rng = np.random.default_rng(2)
    ue = jnp.asarray(rng.normal(size=(1, 8)) * 1e-3)
    full = cohesive.element_force(ecoords, props, ue, dt=0.1, quirks=False)
    quirk = cohesive.element_force(ecoords, props, ue, dt=0.1, quirks=True)
    # quirks drops ip 1: the two must differ for a generic displacement
    assert not np.allclose(np.asarray(full), np.asarray(quirk))


@pytest.mark.parametrize("name", ["hex", "qua"])
def test_stiffness_batchlast_matches_batch_first(name):
    """The batch-last kernel (element_stiffness_lame_batchlast) is
    algebraically identical to the batch-first reference-path kernel."""
    et = elements.get(name)
    rng = np.random.default_rng(7)
    ne = 48
    if name == "hex":
        base = np.array(
            [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
             [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=float)
    else:
        base = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=float)
    ec = base[None] + 0.08 * rng.standard_normal((ne, et.nnodes, et.pdim))
    lam = jnp.asarray(rng.uniform(1, 2, ne))
    mu = jnp.asarray(rng.uniform(0.5, 1.5, ne))
    k_ref = stiffness.element_stiffness_lame(et, jnp.asarray(ec), lam, mu)
    ecl = jnp.asarray(ec.transpose(2, 1, 0))
    kg = np.asarray(stiffness.element_stiffness_lame_batchlast(
        et, ecl, lam, mu))
    kb = kg.transpose(4, 0, 1, 2, 3).reshape(ne, et.ndof, et.ndof)
    np.testing.assert_allclose(
        kb, np.asarray(k_ref), rtol=1e-12,
        atol=1e-12 * np.abs(np.asarray(k_ref)).max())


def test_direct_f64_routes_to_cpu_backend(monkeypatch):
    """The f64 dense direct path no longer routes to the CPU backend: with
    the default backend reported as a GPU, factorize/solve make no device
    transfers and stay f64-exact (cuSOLVER has native f64 LU)."""
    import jax

    from fem_tpu.solver import direct

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    puts = []
    monkeypatch.setattr(jax, "device_put",
                        lambda *a, **k: puts.append(a) or a[0])
    rng = np.random.default_rng(0)
    A = rng.standard_normal((12, 12)) + 12.0 * np.eye(12)
    b = rng.standard_normal(12)
    K, F = jnp.asarray(A, jnp.float64), jnp.asarray(b, jnp.float64)
    x1 = direct.solve_factorized(direct.factorize(K), F)
    x2 = direct.solve(K, F)
    assert puts == []
    assert x1.dtype == jnp.float64 and x2.dtype == jnp.float64
    np.testing.assert_allclose(np.asarray(x1), np.linalg.solve(A, b),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(x2), np.linalg.solve(A, b),
                               rtol=1e-12)
