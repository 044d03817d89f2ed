"""Jaxpr-level collective counting — the DESIGN.md §5b traffic model.

The per-apply communication cost of every sharded operator is validated by
COUNTING the collectives in its traced program (ppermute/psum primitives
and their operand bytes) on the virtual device mesh. Used by
tests/test_comm_model.py (asserts counts == the closed-form model) and by
__graft_entry__.dryrun_multichip (prints the validated inventory into the
multi-device dry run). The analogue of auditing the reference's MPI
ghost-exchange volume (m_global.F90:549-564).
"""

import jax
import jax.numpy as jnp
import numpy as np


def collectives(fn, *args):
    """All (primitive_name, operand_shape, operand_bytes) collective ops in
    fn's jaxpr, recursively through shard_map/scan/cond sub-jaxprs."""
    jaxpr = jax.make_jaxpr(fn)(*args)
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            nm = eqn.primitive.name
            if "ppermute" in nm or "psum" in nm or "all_reduce" in nm:
                for v in eqn.invars:
                    if hasattr(v, "aval") and hasattr(v.aval, "shape"):
                        nb = int(np.prod(v.aval.shape, dtype=np.int64)
                                 * jnp.dtype(v.aval.dtype).itemsize)
                        out.append((nm, tuple(v.aval.shape), nb))
            for val in eqn.params.values():
                for sub in (val if isinstance(val, (list, tuple)) else [val]):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)

    walk(jaxpr.jaxpr)
    return out


def summary(path_name, cols):
    """One printable line: per-collective count and byte totals."""
    agg = {}
    for nm, _, nb in cols:
        c, b = agg.get(nm, (0, 0))
        agg[nm] = (c + 1, b + nb)
    parts = [f"{nm} x{c} ({b} B)" for nm, (c, b) in sorted(agg.items())]
    return (f"[comm] {path_name}: " + (", ".join(parts) if parts
                                       else "no collectives"))
