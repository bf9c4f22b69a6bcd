"""The bundled PVT table (spline knots for the PVT model).

Port of ``srm_tpu/data/pvt_table.py::load_pvt_table``. The port ships its
own copy of the table, ``srm_tpu_torch/data/assets/pvt_table.csv`` (37
pressure points × [Pre, InvBg, InvBo, Invug, Invuo, Rs, Rv, InvBgd, Invugd,
Vro]), byte for byte the JAX package's asset.
"""

from __future__ import annotations

import csv
import os
from typing import Dict

import numpy as np

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", "pvt_table.csv")


def load_pvt_table(path: str = ASSET) -> Dict[str, np.ndarray]:
    """Column name (lowercased) → float32 vector."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [[float(v) for v in r] for r in reader if r]
    arr = np.asarray(rows, dtype=np.float32)
    return {h.lower(): arr[:, i] for i, h in enumerate(header)}
