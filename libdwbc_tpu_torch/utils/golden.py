"""Reader and writer of the reference's binary golden-matrix format
(counterpart of ``libdwbc_tpu/utils/golden.py``; numpy only).

Format (tests/dwbc_test_util.h:15-28): int64 rows, int64 cols, then
rows*cols float64 in **column-major** order.
"""

from __future__ import annotations

import numpy as np


def read_golden(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        raw = f.read()
    rows = int(np.frombuffer(raw, dtype=np.int64, count=1, offset=0)[0])
    cols = int(np.frombuffer(raw, dtype=np.int64, count=1, offset=8)[0])
    data = np.frombuffer(raw, dtype=np.float64, count=rows * cols, offset=16)
    return data.reshape((cols, rows)).T.copy()


def write_golden(path: str, mat: np.ndarray) -> None:
    mat = np.atleast_2d(np.asarray(mat, dtype=np.float64))
    with open(path, "wb") as f:
        f.write(np.int64(mat.shape[0]).tobytes())
        f.write(np.int64(mat.shape[1]).tobytes())
        f.write(mat.T.astype(np.float64).tobytes())
