"""Small dense matrix helpers (batched, closed form).

Batched replacement for the reference's LAPACK usage (m_utils.F90:45-66:
MatInv via dgetrf/dgetri, MatDet) and the 3D area helpers
(m_utils.F90:25-42). Everything here is jit/vmap-friendly: closed-form 2x2 and
3x3 determinants/inverses (no pivoting, no data-dependent control flow), which
XLA fuses straight into the surrounding element kernels.
"""

from __future__ import annotations

import jax.numpy as jnp


def det2(a):
    """Determinant of a (...,2,2) array."""
    return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]


def det3(a):
    """Determinant of a (...,3,3) array (cofactor expansion, m_utils.F90:64)."""
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def det(a):
    """Determinant of a (...,d,d) array for d in {2,3}."""
    d = a.shape[-1]
    if d == 2:
        return det2(a)
    if d == 3:
        return det3(a)
    raise ValueError(f"det: unsupported size {d}")


def inv2(a):
    """Inverse of a (...,2,2) array, closed form."""
    d = det2(a)[..., None, None]
    row0 = jnp.stack([a[..., 1, 1], -a[..., 0, 1]], axis=-1)
    row1 = jnp.stack([-a[..., 1, 0], a[..., 0, 0]], axis=-1)
    return jnp.stack([row0, row1], axis=-2) / d


def inv3(a):
    """Inverse of a (...,3,3) array via the adjugate."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c02 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c10 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c20 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c21 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj / det3(a)[..., None, None]


def inv(a):
    """Inverse of a (...,d,d) array for d in {2,3}."""
    d = a.shape[-1]
    if d == 2:
        return inv2(a)
    if d == 3:
        return inv3(a)
    raise ValueError(f"inv: unsupported size {d}")


def tri_area3d(p1, p2, p3):
    """Area of a triangle in 3D space (m_utils.F90:25-33).

    Arguments are (...,3) point arrays; the reference computes it from three
    2x2-in-3x3 determinants, equivalent to half the cross-product norm.
    """
    cross = jnp.cross(p2 - p1, p3 - p1)
    return 0.5 * jnp.sqrt(jnp.sum(cross * cross, axis=-1))


def quad_area3d(p1, p2, p3, p4):
    """Area of a (planar) quad in 3D as two triangles (m_utils.F90:36-42)."""
    return tri_area3d(p1, p2, p3) + tri_area3d(p1, p3, p4)


def magnitude(v):
    """Vector 2-norm over the last axis (m_utils.F90:69-81)."""
    return jnp.sqrt(jnp.sum(v * v, axis=-1))
