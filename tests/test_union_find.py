"""Union-find / BeliefFind decoder tests.

Mirrors the reference's exhaustive-syndrome pattern
(reference: cpp_test/TestUnionFind.cpp, python_test/test_qcodes.py) plus
batched-equivalence checks.
"""

import numpy as np
import pytest

from ldpc_tpu import BeliefFindDecoder, UnionFindDecoder
from ldpc_tpu.codes import hamming_code, rep_code, ring_code, surface_code


def all_syndromes(m):
    return (
        (np.arange(2**m)[:, None] >> np.arange(m)[None, :]) & 1
    ).astype(np.uint8)


# ----------------------------------------------------------------------
# standalone UnionFindDecoder
# ----------------------------------------------------------------------
def test_uf_matrix_exhaustive_hamming():
    H = hamming_code(3)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = UnionFindDecoder(H, uf_method=True)
    syn = all_syndromes(3)
    out = dec.decode_batch(syn)
    assert dec.valid_batch.all()
    assert np.array_equal((out @ Hd.T) % 2, syn)


def test_uf_peel_rep_code_exhaustive():
    """rep_code columns have degree <= 2: the peeling fast path."""
    H = rep_code(6)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = UnionFindDecoder(H, uf_method=False)
    syn = all_syndromes(5)
    out = dec.decode_batch(syn)
    assert dec.valid_batch.all()
    assert np.array_equal((out @ Hd.T) % 2, syn)


def test_uf_peel_ring_code():
    """ring_code has no boundary bits: only even-parity syndromes decode."""
    H = ring_code(7)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = UnionFindDecoder(H, uf_method=False)
    syn = all_syndromes(7)
    even = syn[syn.sum(axis=1) % 2 == 0]
    out = dec.decode_batch(even)
    assert dec.valid_batch.all()
    assert np.array_equal((out @ Hd.T) % 2, even)


def test_uf_peel_rejects_high_degree():
    # hamming(3) has columns of degree 3
    with pytest.raises(ValueError):
        UnionFindDecoder(hamming_code(3), uf_method=False)


def test_uf_rejects_zero_weight_column():
    H = np.array([[1, 0, 0], [0, 1, 0]], dtype=np.uint8)
    with pytest.raises(ValueError):
        UnionFindDecoder(H, uf_method=True)


def test_uf_matrix_guided_by_llrs():
    H = rep_code(8)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = UnionFindDecoder(H, uf_method=True)
    e = np.zeros(8, np.uint8)
    e[3] = 1
    s = Hd @ e % 2
    llrs = np.full(8, 5.0)
    llrs[3] = -2.0  # bit 3 most suspect
    out = dec.decode(s, llrs=llrs, bits_per_step=1)
    assert np.array_equal(Hd @ out % 2, s)
    assert out[3] == 1


def test_uf_single_vs_batch():
    H = hamming_code(3)
    dec = UnionFindDecoder(H, uf_method=True)
    syn = all_syndromes(3)
    batch = dec.decode_batch(syn)
    for i, s in enumerate(syn):
        single = dec.decode(s)
        assert np.array_equal(single, batch[i])


# ----------------------------------------------------------------------
# BeliefFindDecoder (BP + UF)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("uf_method", ["inversion", "peeling"])
def test_belief_find_surface_code(uf_method):
    code = surface_code(5)
    Hd = np.asarray(code.hx.todense(), np.uint8)
    dec = BeliefFindDecoder(
        code.hx,
        error_rate=0.05,
        max_iter=5,
        bp_method="minimum_sum",
        ms_scaling_factor=0.625,
        uf_method=uf_method,
        bits_per_step=1,
    )
    rng = np.random.default_rng(149)
    errors = (rng.random((128, Hd.shape[1])) < 0.05).astype(np.uint8)
    syn = (errors @ Hd.T % 2).astype(np.uint8)
    out = dec.decode_batch(syn)
    assert np.array_equal((out @ Hd.T) % 2, syn)
    assert (~dec.converge_batch).any()  # the UF path actually exercised


def test_belief_find_peeling_validation():
    with pytest.raises(ValueError, match="point like"):
        BeliefFindDecoder(hamming_code(3), error_rate=0.1, uf_method="peeling")
    with pytest.raises(ValueError, match="Invalid UF method"):
        BeliefFindDecoder(rep_code(5), error_rate=0.1, uf_method="nonsense")


def test_belief_find_inversion_hamming_exhaustive():
    H = hamming_code(3)
    Hd = np.asarray(H.todense(), np.uint8)
    dec = BeliefFindDecoder(
        H, error_rate=0.1, max_iter=2, uf_method="inversion"
    )
    syn = all_syndromes(3)
    out = dec.decode_batch(syn)
    assert np.array_equal((out @ Hd.T) % 2, syn)


def test_belief_find_zero_syndrome():
    dec = BeliefFindDecoder(rep_code(5), error_rate=0.1, uf_method="peeling")
    x = dec.decode(np.zeros(4, np.uint8))
    assert not x.any() and dec.converge
