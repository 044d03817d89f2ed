"""chip_smoke.py --four on 4 of the 8 virtual CPU devices: the sharded
structured and lattice solves (slab stencil with the sharded MG fine level;
DOF-sharded halo block stencil with geometric lattice MG) agree with their
one-device runs in u and iteration counts."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from fem_tpu.config import Config  # noqa: E402


def test_run_four_on_virtual_devices(monkeypatch):
    monkeypatch.setenv("FEM_TPU_GMG_MIN", "1")
    chip_smoke.run_four(4, 4, Config(solver="cg", precond="amg"))
