"""Iteration-history logs of the well solver.

Port of ``log_tensor_to_file`` (``srm_tpu/utils/profiling.py:68-90``), with
its file format: a ``# name, shape [...]`` header, one ``iter i values:
"..."`` row per iteration (the first ``values_per_line`` values, only the
non-zero ones when ``well_specific``) and a ``final values:`` row. The JAX
package calls it from inside ``jit`` through ``jax.debug.callback``; the
port calls it on host arrays after the step that computed them
(``physics/well_solver.py``).
"""

from __future__ import annotations

import logging
import os
import tempfile
import uuid
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

#: where the logs go unless the caller names a directory
DEFAULT_LOG_DIR = os.path.join(tempfile.gettempdir(), "srm_tpu_logs")


def log_tensor_to_file(tensor, it_final=None, final_tensor=None,
                       tensor_name: str = "tensor", file_prefix: str = "tensor_log",
                       values_per_line: int = 10, directory: Optional[str] = None,
                       well_specific: bool = False) -> str:
    """Write an iteration-history array (iterations first) to a uniquely
    named text file in ``directory``; returns its path. ``it_final`` is
    accepted for the JAX package's signature and not written, as there."""
    directory = directory or DEFAULT_LOG_DIR
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{file_prefix}_{uuid.uuid4().hex[:8]}.txt")
    arr = np.asarray(tensor)
    with open(path, "w") as f:
        f.write(f"# {tensor_name}, shape {list(arr.shape)}\n")
        it_rows = arr.reshape(arr.shape[0], -1) if arr.ndim > 1 else arr.reshape(1, -1)
        for i, row in enumerate(it_rows):
            nz = row[np.nonzero(row)] if well_specific else row
            vals = " ".join(f"{v:.6g}" for v in nz[:values_per_line])
            f.write(f'iter {i} values: "{vals}"\n')
        if final_tensor is not None:
            fin = np.asarray(final_tensor).reshape(-1)
            fin = fin[np.nonzero(fin)] if well_specific else fin
            f.write(f'final values: "{" ".join(f"{v:.6g}" for v in fin[:values_per_line])}"\n')
    log.debug("tensor log written: %s", path)
    return path
