"""What the code assumes about the device it runs on.

- The compile cache follows JAX_COMPILATION_CACHE_DIR, else a fixed path.
- Every f32 contraction of the stencil, block-stencil and stiffness programs
  runs at HIGHEST precision (a GPU would otherwise use TF32).
- On a GPU backend the 3D lattice hierarchy is built and the dense Newton
  fallback is lstsq: no branch treats every non-CPU backend alike.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.io import meshgen
from fem_tpu.models.system import System
from fem_tpu.utils import jaxcache


def test_jaxcache_honours_env_dir(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    monkeypatch.delenv("FEM_TPU_NO_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert jaxcache.enable() == str(tmp_path / "c")
    assert seen["jax_compilation_cache_dir"] == str(tmp_path / "c")
    assert os.path.isdir(tmp_path / "c")


def test_jaxcache_fixed_path_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert jaxcache.cache_dir() == os.path.join(root, ".jax_cache")


def test_jaxcache_disabled(monkeypatch):
    monkeypatch.setenv("FEM_TPU_NO_CACHE", "1")
    assert jaxcache.enable() is None


def _dot_precisions(closed):
    """(dtype, precision) of every dot_general in a jaxpr, nested included."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append((eqn.invars[0].aval.dtype,
                            eqn.params["precision"]))
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(closed.jaxpr)
    return out


def _assert_f32_highest(closed):
    dots = [(d, p) for d, p in _dot_precisions(closed) if d == jnp.float32]
    assert dots, "program has no f32 dot_general"
    hi = jax.lax.Precision.HIGHEST
    for _, prec in dots:
        assert prec is not None and all(q == hi for q in prec), prec


def test_f32_stencil_matvec_is_highest():
    from fem_tpu.ops import structured
    from fem_tpu.ops.stiffness import lame

    lam, mu = lame(jnp.asarray(200e9, jnp.float32),
                   jnp.asarray(0.3, jnp.float32))
    st = structured.build((0.25,) * 3, (5,) * 3, lam, mu, dtype=jnp.float32)
    u = jnp.ones(st.ndof, jnp.float32)
    _assert_f32_highest(jax.make_jaxpr(structured.matvec)(st, u))


def test_f32_blockstencil_vcycle_is_highest():
    """The f32 grid-state lattice V-cycle the stepper runs: block-stencil
    smoothing at every level and the dense coarse solve, a contraction."""
    from fem_tpu.ops import blockstencil as bs
    from fem_tpu.solver import amg, gmg

    p = meshgen.hex_box_problem(6, 6, 6, jitter=0.2)
    s = System(p, dtype=jnp.float64)
    A = amg.assemble_csr(s)
    dims = bs.detect(A, s.pdim, s.nnds)
    op = bs.build(A, s.pdim, dims).astype(jnp.float32)
    h = gmg.build_lattice(A, s.pdim, dims, bc_dofs=s.bc_dofs,
                          coarse_max=50, dtype=jnp.float32)
    assert len(h.levels) >= 2
    r = jnp.ones((s.pdim,) + tuple(dims), jnp.float32)
    _assert_f32_highest(jax.make_jaxpr(
        lambda r: gmg.v_cycle_g(h, lambda v: bs.matvec_g(op, v), r))(r))


def test_f32_stiffness_is_highest():
    from fem_tpu.ops import elements, stiffness

    et = elements.get("hex")
    ec = jnp.asarray(np.random.default_rng(0).standard_normal((3, 8, 16)),
                     jnp.float32)
    lam, mu = stiffness.lame(jnp.full(16, 200e9, jnp.float32),
                             jnp.full(16, 0.3, jnp.float32))
    _assert_f32_highest(jax.make_jaxpr(
        lambda e: stiffness.element_stiffness_lame_batchlast(et, e, lam, mu)
    )(ec))


@pytest.fixture
def gpu_backend(monkeypatch):
    """Report the default backend as a GPU (arrays stay on the CPU)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_gmg_builds_3d_lattice_on_gpu(gpu_backend):
    from fem_tpu.ops import blockstencil as bs
    from fem_tpu.solver import amg, gmg

    p = meshgen.hex_box_problem(6, 6, 6, jitter=0.2)
    s = System(p, dtype=jnp.float64)
    A = amg.assemble_csr(s)
    dims = bs.detect(A, s.pdim, s.nnds)
    assert len(dims) == 3
    h = gmg.build_lattice(A, s.pdim, dims, bc_dofs=s.bc_dofs, coarse_max=50)
    assert isinstance(h, gmg.GMGPrecond) and len(h.levels) >= 1


def test_dense_newton_fallback_is_lstsq_on_gpu(gpu_backend):
    from fem_tpu.solver import newton

    p = meshgen.cohesive_interface_problem(4, 2, open_disp=0.004, t=1.0,
                                           dt=0.5)
    s = System(p, dtype=jnp.float64)
    n = s.ndof
    bc_mask = jnp.zeros(n, bool).at[s.bc_dofs].set(True)
    ubc = jnp.zeros(n).at[s.bc_dofs].set(s.bc_step_vals())
    e = s.blocks["coh"]
    jaxpr = jax.make_jaxpr(
        lambda du: newton._dense_newton_iterate(
            s.dense_K(), e["ecoords"], e["props"], e["edofs"],
            jnp.asarray(s.dt), s.rhs(0.0), jnp.zeros(n), s.bc_dofs,
            s.bc_step_vals(), bc_mask, ubc, du, jnp.asarray(1.0),
            penalty=False, reference_form=False, quirks=False,
            eliminate=True))(jnp.zeros(n))
    assert "svd" in str(jaxpr)
