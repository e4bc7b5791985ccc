"""Lazily-materialised device result views shared by the fused decode
paths: device-resident chunks (LLRs, BP decodings) are pulled only on
first host access, so a caller that never reads them never copies
them."""

import numpy as np


class LazyChunks:
    """np-convertible view over device-resident result chunks."""

    def __init__(self, chunks, total):
        self._chunks = chunks
        self._total = total
        self._np = None

    def _materialize(self):
        if self._np is None:
            self._np = np.concatenate(
                [np.asarray(c) for c in self._chunks], axis=0
            )[: self._total]
        return self._np

    def __array__(self, dtype=None, copy=None):
        arr = self._materialize()
        return arr.astype(dtype) if dtype is not None else arr

    def __getitem__(self, item):
        return self._materialize()[item]

    def __len__(self):
        return self._total

    @property
    def shape(self):
        return (self._total,) + tuple(self._chunks[0].shape[1:])
