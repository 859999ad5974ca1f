"""Device->host transfer shaping.

``read_back`` materializes a large device array as concurrent row-slice
reads of ``CHUNK_BYTES`` each on ``THREADS`` threads, then concatenates.
Whether that beats one monolithic readback on a given host link is a
measurement for the benchmark; the cost where it does not help is one
extra concatenate.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

CHUNK_BYTES = 32 << 20
THREADS = 4


def read_back(array, chunk_bytes: int = CHUNK_BYTES,
              threads: int = THREADS) -> np.ndarray:
    """Materialize a device array on host via concurrent row-slice reads."""
    shape = array.shape
    if not shape:
        return np.asarray(array)
    row_bytes = int(np.prod(shape[1:], dtype=np.int64)) * array.dtype.itemsize
    rows = max(1, chunk_bytes // max(row_bytes, 1))
    if rows >= shape[0]:
        return np.asarray(array)
    spans = [(s, min(s + rows, shape[0]))
             for s in range(0, shape[0], rows)]
    if threads <= 1:
        parts = [np.asarray(array[s:e]) for s, e in spans]
    else:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            parts = list(ex.map(lambda se: np.asarray(array[se[0]:se[1]]),
                                spans))
    return np.concatenate(parts)
