"""The bundled PVT table (spline knots for the PVT model).

Port of ``srm_tpu/data/pvt_table.py::load_pvt_table``. The table itself is
the reference package's CSV asset (37 pressure points × [Pre, InvBg, InvBo,
Invug, Invuo, Rs, Rv, InvBgd, Invugd, Vro]); it is read from the installed
``srm_tpu`` package's files without importing ``srm_tpu.data``, whose
``__init__`` imports JAX.
"""

from __future__ import annotations

import csv
import os
from typing import Dict

import numpy as np
import srm_tpu

ASSET = os.path.join(os.path.dirname(os.path.abspath(srm_tpu.__file__)),
                     "data", "assets", "pvt_table.csv")


def load_pvt_table(path: str = ASSET) -> Dict[str, np.ndarray]:
    """Column name (lowercased) → float32 vector."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [[float(v) for v in r] for r in reader if r]
    arr = np.asarray(rows, dtype=np.float32)
    return {h.lower(): arr[:, i] for i, h in enumerate(header)}
