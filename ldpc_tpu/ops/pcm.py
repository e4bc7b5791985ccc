"""PCM compiler: scipy sparse parity-check matrix -> padded device layout.

The reference library walks a doubly-linked pointer sparse structure
(reference: src_cpp/sparse_matrix_base.hpp:105-118). On the device we
replace it with static padded index arrays ("ELL" layout) built once per
code and resident in device memory:

- check-major edges: edge ``e = check*dc + slot`` with ``bit_of_edge[e]``
  giving the column (pad slots point at a dummy bit ``n``);
- variable-major views: for each bit, the flat check-major edge ids of its
  column (``var_edges``), the owning check (``var_chks``) and the slot of
  the bit within that check's row (``var_slot``).

All shapes are static so every decoder jits once per code. Messages are
stored batch-minor ``(E, batch)`` so row gathers move contiguous
128-lane-aligned vectors.
"""

from typing import NamedTuple

import numpy as np
import scipy.sparse

from ldpc_tpu.helpers import convert_to_binary_sparse


class PcmGraph(NamedTuple):
    """Static device layout of a parity-check matrix (all numpy, hashable id)."""

    m: int  # checks
    n: int  # bits
    dc: int  # max check (row) degree
    dv: int  # max variable (column) degree
    nnz: int
    # check-major ELL --------------------------------------------------
    chk_bits: np.ndarray  # (m, dc) int32, bit index per slot, pad = n
    chk_mask: np.ndarray  # (m, dc) bool
    # variable-major views over check-major edge ids --------------------
    var_edges: np.ndarray  # (n, dv) int32, flat edge id (check*dc+slot), pad = m*dc
    var_chks: np.ndarray  # (n, dv) int32, check index, pad = m
    var_mask: np.ndarray  # (n, dv) bool
    bit_of_edge: np.ndarray  # (m*dc,) int32, pad = n
    chk_of_edge: np.ndarray  # (m*dc,) int32, pad = m
    # slot of each bit within the rows of its checks (for serial schedules)
    var_slot: np.ndarray  # (n, dv) int32, pad = 0
    # dense copy for mulvec-style ops (uint8); small codes only by design
    dense: np.ndarray  # (m, n) uint8

    @property
    def num_edges(self) -> int:
        return self.m * self.dc


def compile_pcm(pcm) -> PcmGraph:
    """Build the padded ELL layout from a scipy-sparse/numpy PCM."""
    pcm = convert_to_binary_sparse(pcm).tocsr()
    pcm.sort_indices()
    m, n = pcm.shape
    indptr, indices = pcm.indptr, pcm.indices
    row_deg = np.diff(indptr)
    dc = int(row_deg.max()) if m else 0
    col_deg = np.bincount(indices, minlength=n)
    dv = int(col_deg.max()) if n else 0
    if (col_deg == 0).any():
        # zero-weight columns are legal for BP (bit never updates) but the
        # UF decoders reject them; keep dv >= 1 for layout sanity
        dv = max(dv, 1)

    chk_bits = np.full((m, dc), n, dtype=np.int32)
    chk_mask = np.zeros((m, dc), dtype=bool)
    for i in range(m):
        row = indices[indptr[i] : indptr[i + 1]]
        chk_bits[i, : row.size] = row
        chk_mask[i, : row.size] = True

    E = m * dc
    bit_of_edge = chk_bits.reshape(-1).astype(np.int32)
    chk_of_edge = np.where(
        chk_mask.reshape(-1), np.repeat(np.arange(m, dtype=np.int32), dc), m
    ).astype(np.int32)

    var_edges = np.full((n, dv), E, dtype=np.int32)
    var_chks = np.full((n, dv), m, dtype=np.int32)
    var_slot = np.zeros((n, dv), dtype=np.int32)
    var_mask = np.zeros((n, dv), dtype=bool)
    fill = np.zeros(n, dtype=np.int64)
    for i in range(m):
        for slot in range(int(row_deg[i])):
            j = chk_bits[i, slot]
            k = fill[j]
            var_edges[j, k] = i * dc + slot
            var_chks[j, k] = i
            var_slot[j, k] = slot
            var_mask[j, k] = True
            fill[j] += 1

    return PcmGraph(
        m=m,
        n=n,
        dc=dc,
        dv=dv,
        nnz=int(pcm.nnz),
        chk_bits=chk_bits,
        chk_mask=chk_mask,
        var_edges=var_edges,
        var_chks=var_chks,
        var_mask=var_mask,
        bit_of_edge=bit_of_edge,
        chk_of_edge=chk_of_edge,
        var_slot=var_slot,
        dense=np.asarray(pcm.todense(), dtype=np.uint8),
    )
