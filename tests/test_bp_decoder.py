"""BpDecoder tests: API parity + behavioral checks.

Modeled on the reference test strategy (reference:
python_test/test_bp_decoder.py): constructor/property validation, golden
rep-code decodings, exhaustive small-code sweeps, plus batch
equivalence checks the reference lacks.
"""

import itertools

import numpy as np
import pytest
import scipy.sparse

from ldpc_tpu import BpDecoder, SoftInfoBpDecoder
from ldpc_tpu.codes import hamming_code, rep_code, ring_code


def test_constructor_defaults():
    H = rep_code(3)
    d = BpDecoder(H, error_rate=0.1)
    assert d.check_count == 2
    assert d.bit_count == 3
    assert d.bp_method == "minimum_sum"
    assert d.schedule == "parallel"
    assert d.max_iter == 3  # 0 -> block length
    assert d.ms_scaling_factor == 1.0
    assert np.allclose(d.error_channel, 0.1)


def test_constructor_validation():
    H = rep_code(3)
    with pytest.raises(TypeError):
        BpDecoder("not a matrix", error_rate=0.1)
    with pytest.raises(ValueError):
        BpDecoder(H)  # no channel
    with pytest.raises(ValueError):
        BpDecoder(H, error_rate=0.1, bp_method="nonsense")
    with pytest.raises(ValueError):
        BpDecoder(H, error_rate=0.1, schedule="nonsense")
    with pytest.raises(ValueError):
        BpDecoder(H, error_rate=0.1, max_iter=-1)
    with pytest.raises(ValueError):
        BpDecoder(H, error_rate="0.1")
    with pytest.raises(ValueError):
        BpDecoder(H, error_rate=0.1, error_channel=[0.1, 0.2])  # wrong length
    with pytest.raises(ValueError):
        BpDecoder(H, error_rate=0.1, unknown_kwarg=1)


def test_bp_method_aliases():
    H = rep_code(3)
    for alias in ("ps", "product_sum", "prod_sum", "0"):
        assert BpDecoder(H, error_rate=0.1, bp_method=alias).bp_method == "product_sum"
    for alias in ("ms", "minimum_sum", "min_sum", "1"):
        assert BpDecoder(H, error_rate=0.1, bp_method=alias).bp_method == "minimum_sum"


def test_channel_probs_v1_compat():
    H = rep_code(3)
    d = BpDecoder(H, channel_probs=[0.1, 0.2, 0.3])
    assert np.allclose(d.error_channel, [0.1, 0.2, 0.3])
    d.update_channel_probs([0.3, 0.2, 0.1])
    assert np.allclose(d.channel_probs, [0.3, 0.2, 0.1])


def test_zero_syndrome_short_circuit():
    H = rep_code(5)
    d = BpDecoder(H, error_rate=0.1, input_vector_type="syndrome")
    out = d.decode(np.zeros(4, dtype=np.uint8))
    assert not out.any()
    assert d.converge


def test_rep_code_golden():
    """Single flipped check on a repetition code -> weight-1 error at the end."""
    H = rep_code(3)
    d = BpDecoder(H, error_rate=0.1, input_vector_type="syndrome")
    out = d.decode(np.array([1, 0], dtype=np.uint8))
    assert d.converge
    assert ((H @ out) % 2 == [1, 0]).all()
    assert out.sum() == 1  # minimum-weight solution


@pytest.mark.parametrize("bp_method", ["product_sum", "minimum_sum"])
@pytest.mark.parametrize("schedule", ["parallel", "serial", "serial_relative"])
def test_hamming_exhaustive_valid(bp_method, schedule):
    """All 2^m syndromes of Hamming(3): converged decodings satisfy H@x=s."""
    H = hamming_code(3)
    m = H.shape[0]
    d = BpDecoder(
        H,
        error_rate=0.05,
        max_iter=20,
        bp_method=bp_method,
        schedule=schedule,
        input_vector_type="syndrome",
    )
    n_conv = 0
    for bits in itertools.product([0, 1], repeat=m):
        s = np.array(bits, dtype=np.uint8)
        out = d.decode(s)
        if d.converge:
            n_conv += 1
            assert ((H @ out) % 2 == s).all()
    # serial schedules converge on fewer syndromes than parallel here —
    # verified to match the reference implementation exactly (see
    # test_bp_golden.py); only require the floor observed there
    floor = 2**m - 2 if schedule == "parallel" else 4
    assert n_conv >= floor


@pytest.mark.parametrize("schedule", ["parallel", "serial"])
def test_decode_batch_matches_loop(schedule):
    H = ring_code(8)
    d = BpDecoder(
        H,
        error_rate=0.1,
        max_iter=15,
        schedule=schedule,
        input_vector_type="syndrome",
    )
    rng = np.random.default_rng(7)
    syndromes = rng.integers(0, 2, size=(12, H.shape[0]), dtype=np.uint8)
    batch_out = d.decode_batch(syndromes)
    for i in range(syndromes.shape[0]):
        single = d.decode(syndromes[i])
        assert (batch_out[i] == single).all(), i
        assert d.converge == d.converge_batch[i]


def test_received_vector_mode():
    H = rep_code(5)
    d = BpDecoder(H, error_rate=0.1, input_vector_type="received_vector")
    rv = np.array([0, 0, 1, 0, 0], dtype=np.uint8)  # codeword 00000 + 1 error
    out = d.decode(rv)
    assert ((H @ out) % 2 == 0).all()  # decoding is a codeword estimate
    assert not out.any()


def test_input_vector_length_validation():
    H = rep_code(5)  # 4 x 5
    d = BpDecoder(H, error_rate=0.1, input_vector_type="syndrome")
    with pytest.raises(ValueError):
        d.decode(np.zeros(5, dtype=np.uint8))
    d2 = BpDecoder(H, error_rate=0.1, input_vector_type="received_vector")
    with pytest.raises(ValueError):
        d2.decode(np.zeros(4, dtype=np.uint8))


def test_square_pcm_requires_explicit_input_type():
    H = scipy.sparse.identity(4, dtype=np.uint8, format="csr")
    with pytest.raises(ValueError):
        BpDecoder(H, error_rate=0.1)  # auto is ambiguous when m == n
    d = BpDecoder(H, error_rate=0.1, input_vector_type="syndrome")
    out = d.decode(np.array([0, 1, 0, 1], dtype=np.uint8))
    assert (out == [0, 1, 0, 1]).all()


def test_serial_schedule_order():
    H = rep_code(4)
    order = [3, 2, 1, 0]
    d = BpDecoder(
        H,
        error_rate=0.1,
        schedule="serial",
        serial_schedule_order=order,
        input_vector_type="syndrome",
    )
    assert (d.serial_schedule_order == order).all()
    out = d.decode(np.array([1, 0, 0], dtype=np.uint8))
    assert ((H @ out) % 2 == [1, 0, 0]).all()
    with pytest.raises(Exception):
        d.serial_schedule_order = [0, 1]  # wrong length


def test_dynamic_ms_scaling():
    """ms_scaling_factor=0.0 -> dynamic alpha = 1 - 2^-iter (bp.hpp:223-228)."""
    H = ring_code(10)
    d = BpDecoder(
        H,
        error_rate=0.1,
        max_iter=30,
        ms_scaling_factor=0.0,
        input_vector_type="syndrome",
    )
    s = np.zeros(10, dtype=np.uint8)
    s[0] = 1
    s[3] = 1
    out = d.decode(s)
    assert d.converge
    assert ((H @ out) % 2 == s).all()


def test_log_prob_ratios_exposed():
    H = rep_code(3)
    d = BpDecoder(H, error_rate=0.1, input_vector_type="syndrome")
    d.decode(np.array([1, 0], dtype=np.uint8))
    lpr = d.log_prob_ratios
    assert lpr.shape == (3,)
    assert np.isfinite(lpr).all()


def test_product_sum_matches_minimum_sum_easy_case():
    """On trivially decodable syndromes both methods give the same answer."""
    H = rep_code(7)
    s = np.zeros(6, dtype=np.uint8)
    s[0] = 1
    outs = []
    for method in ("product_sum", "minimum_sum"):
        d = BpDecoder(
            H, error_rate=0.05, bp_method=method, input_vector_type="syndrome"
        )
        outs.append(d.decode(s))
        assert d.converge
    assert (outs[0] == outs[1]).all()


class TestSoftInfoBpDecoder:
    def test_constructor(self):
        H = rep_code(3)
        d = SoftInfoBpDecoder(H, error_rate=0.1, cutoff=10.0)
        assert d.cutoff == 10.0
        assert d.sigma == 2.0
        assert d.bp_method == "minimum_sum"
        with pytest.raises(ValueError):
            SoftInfoBpDecoder(H, error_rate=0.1, sigma=-1.0)

    def test_confident_syndrome_matches_hard_bp(self):
        """Large soft magnitudes (above any message) behave like hard BP."""
        H = rep_code(5)
        hard = BpDecoder(
            H, error_rate=0.1, schedule="serial", input_vector_type="syndrome"
        )
        soft = SoftInfoBpDecoder(H, error_rate=0.1, cutoff=0.0)  # rules disabled
        s = np.array([1, 0, 0, 0], dtype=np.uint8)
        out_hard = hard.decode(s)
        # sign encodes the hard syndrome: negative = flipped check
        soft_s = np.where(s == 1, -20.0, 20.0)
        out_soft = soft.decode(soft_s)
        assert (out_hard == out_soft).all()
        assert soft.converge

    def test_weak_syndrome_flip(self):
        """A barely-negative syndrome bit can be virtually flipped to zero."""
        H = rep_code(5)
        d = SoftInfoBpDecoder(H, error_rate=0.01, cutoff=np.inf, sigma=1.0)
        soft_s = np.array([20.0, -0.01, 20.0, 20.0])
        out = d.decode(soft_s)
        assert d.converge
        assert not out.any()  # cheaper to flip the weak syndrome than 2 bits
        assert d.soft_syndrome.shape == (4,)


def test_single_scan_golden():
    """Reference golden values (reference: cpp_test/TestBPDecoder.cpp:346-389):
    rep_code(3), p=0.1, min-sum alpha=0.625, all 4 syndromes."""
    H = rep_code(3)
    d = BpDecoder(
        H, error_channel=[0.1, 0.1, 0.1], max_iter=3, bp_method="ms",
        ms_scaling_factor=0.625,
    )
    expected = {
        (0, 0): [0, 0, 0],
        (0, 1): [0, 0, 1],
        (1, 0): [1, 0, 0],
        (1, 1): [0, 1, 0],
    }
    for syndrome, want in expected.items():
        out = d.decode_single_scan(np.array(syndrome, dtype=np.uint8))
        assert out.tolist() == want, (syndrome, out)


def test_single_scan_matches_parallel_min_sum():
    """Single-scan's recurrence is the parallel min-sum schedule's
    (see ops/bp.py make_single_scan_decoder) — decisions must agree."""
    H = hamming_code(3)
    d = BpDecoder(H, error_rate=0.05, max_iter=20, bp_method="ms",
                  ms_scaling_factor=0.8)
    m = H.shape[0]
    for s_int in range(2 ** m):
        syndrome = np.array([(s_int >> i) & 1 for i in range(m)], np.uint8)
        out_ss = d.decode_single_scan(syndrome)
        conv_ss = d.converge
        out_par = d.decode(syndrome)
        assert out_ss.tolist() == out_par.tolist()
        assert conv_ss == d.converge


def test_single_scan_zero_alpha_is_fixed():
    """ms_scaling_factor=0 keeps messages at zero in single-scan (no
    dynamic alpha, bp.hpp:399): nothing converges on a nonzero syndrome
    unless the prior already satisfies it."""
    H = rep_code(5)
    d = BpDecoder(H, error_rate=0.1, max_iter=10, ms_scaling_factor=0.0)
    s = np.zeros(4, np.uint8)
    s[0] = 1
    d.decode_single_scan(s)
    assert not d.converge
