"""BpOsdDecoder API and behavior tests (reference: python_test/test_bposd.py)."""

import itertools

import numpy as np
import pytest

import jax

from ldpc_tpu import BpOsdDecoder
from ldpc_tpu.codes import hamming_code, rep_code, surface_code


def test_constructor_defaults():
    H = rep_code(3)
    d = BpOsdDecoder(H, error_rate=0.1)
    assert d.osd_method == "OSD_0"
    assert d.osd_order == 0
    assert d.input_vector_type == "syndrome"


def test_osd_method_aliases():
    H = rep_code(3)
    for alias in ("osd_0", "0", "osd0"):
        assert BpOsdDecoder(H, error_rate=0.1, osd_method=alias).osd_method == "OSD_0"
    for alias in ("osd_e", "e", "exhaustive"):
        d = BpOsdDecoder(H, error_rate=0.1, osd_method=alias, osd_order=2)
        assert d.osd_method == "OSD_E"
    for alias in ("osd_cs", "1", "cs", "combination_sweep"):
        d = BpOsdDecoder(H, error_rate=0.1, osd_method=alias, osd_order=2)
        assert d.osd_method == "OSD_CS"
    for alias in ("off", "osd_off", "deactivated"):
        assert BpOsdDecoder(H, error_rate=0.1, osd_method=alias).osd_method == "OSD_OFF"
    with pytest.raises(ValueError):
        BpOsdDecoder(H, error_rate=0.1, osd_method="nonsense")


def test_osd_order_validation():
    H = rep_code(3)
    with pytest.raises(ValueError):
        BpOsdDecoder(H, error_rate=0.1, osd_method="osd_e", osd_order=-1)
    with pytest.raises(ValueError):
        d = BpOsdDecoder(H, error_rate=0.1, osd_method="osd_0")
        d.osd_order = 2  # OSD_0 requires order 0
    with pytest.warns(UserWarning):
        BpOsdDecoder(H, error_rate=0.1, osd_method="osd_e", osd_order=16)


def test_zero_syndrome():
    H = rep_code(5)
    d = BpOsdDecoder(H, error_rate=0.1)
    out = d.decode(np.zeros(4, dtype=np.uint8))
    assert not out.any()
    assert d.converge


def test_syndrome_length_validation():
    H = rep_code(5)
    d = BpOsdDecoder(H, error_rate=0.1)
    with pytest.raises(ValueError):
        d.decode(np.zeros(5, dtype=np.uint8))


@pytest.mark.parametrize("method,order", [("osd_0", 0), ("osd_e", 4), ("osd_cs", 4)])
def test_hamming_exhaustive_always_valid(method, order):
    """OSD guarantees a valid solution for every in-image syndrome."""
    H = hamming_code(3)
    d = BpOsdDecoder(
        H, error_rate=0.05, max_iter=8, osd_method=method, osd_order=order
    )
    for bits in itertools.product([0, 1], repeat=3):
        s = np.array(bits, dtype=np.uint8)
        out = d.decode(s)
        assert ((H @ out) % 2 == s).all()


def test_result_properties():
    H = hamming_code(3)
    d = BpOsdDecoder(H, error_rate=0.05, max_iter=2, osd_method="osd_cs", osd_order=2)
    s = np.array([1, 1, 1], dtype=np.uint8)
    out = d.decode(s)
    assert d.bp_decoding.shape == (7,)
    assert d.osd0_decoding.shape == (7,)
    assert d.osdw_decoding.shape == (7,)
    assert (d.decoding == out).all()
    if not d.converge:
        # osdw decoding is the returned decoding on BP failure
        assert (d.osdw_decoding == out).all()


def test_batch_matches_loop():
    code = surface_code(3)
    H = code.hx
    d = BpOsdDecoder(
        H, error_rate=0.05, max_iter=4, osd_method="osd_cs", osd_order=3
    )
    rng = np.random.default_rng(11)
    errors = (rng.random((24, H.shape[1])) < 0.08).astype(np.uint8)
    syn = np.asarray(errors @ H.T.todense() % 2, dtype=np.uint8)
    batch_out = d.decode_batch(syn)
    assert ((batch_out @ H.T.todense() % 2) == syn).all()
    for i in range(syn.shape[0]):
        single = d.decode(syn[i])
        assert (single == batch_out[i]).all(), i


def test_osd_beats_bp_on_hard_syndromes():
    """On the quantum code, BP alone fails where BP+OSD succeeds."""
    code = surface_code(5)
    H = code.hx
    rng = np.random.default_rng(5)
    errors = (rng.random((64, H.shape[1])) < 0.06).astype(np.uint8)
    syn = np.asarray(errors @ H.T.todense() % 2, dtype=np.uint8)
    d = BpOsdDecoder(H, error_rate=0.06, max_iter=10, osd_method="osd_0")
    out = d.decode_batch(syn)
    assert ((out @ H.T.todense() % 2) == syn).all()  # OSD always valid
    assert not d.converge_batch.all()  # BP alone failed on some


def test_bit_packed_io_kwargs():
    """decode_batch accepts stim-b8 bit-packed syndromes and can return
    bit-packed decodings, across the BP-family decoders."""
    from ldpc_tpu import BeliefFindDecoder, BpDecoder, BpLsdDecoder

    code = surface_code(5)
    H = code.hx
    rng = np.random.default_rng(3)
    errors = (rng.random((32, H.shape[1])) < 0.04).astype(np.uint8)
    syn = np.asarray(errors @ H.T.todense() % 2, dtype=np.uint8)
    packed_syn = np.packbits(syn, axis=1, bitorder="little")

    for dec in (
        BpOsdDecoder(H, error_rate=0.04, max_iter=12, osd_method="osd_0"),
        BpDecoder(H, error_rate=0.04, max_iter=12),
        BpLsdDecoder(H, error_rate=0.04, max_iter=12, lsd_order=0),
        BeliefFindDecoder(H, error_rate=0.04, max_iter=12),
    ):
        want = dec.decode_batch(syn)
        got = dec.decode_batch(packed_syn, bit_packed_syndromes=True)
        assert np.array_equal(want, got), type(dec).__name__
        got_packed = dec.decode_batch(
            packed_syn, bit_packed_syndromes=True, bit_packed_output=True
        )
        assert np.array_equal(
            np.packbits(want, axis=1, bitorder="little"), got_packed
        ), type(dec).__name__


def test_bit_packed_input_validation():
    code = surface_code(3)
    d = BpOsdDecoder(code.hx, error_rate=0.05, max_iter=5)
    bad = np.zeros((4, 99), np.uint8)
    with pytest.raises(ValueError, match="Bit-packed"):
        d.decode_batch(bad, bit_packed_syndromes=True)


# primitives that move or reshape values without changing them
_VALUE_PRESERVING = {
    "transpose", "reshape", "broadcast_in_dim", "squeeze", "expand_dims",
    "copy", "copy_p", "slice", "dynamic_slice", "gather", "concatenate",
}


def _sub_jaxprs(eqn):
    """``(jaxpr, invars_match_operands)`` for each jaxpr in eqn's params."""
    from jax.extend import core as jcore

    for val in eqn.params.values():
        for item in val if isinstance(val, (tuple, list)) else (val,):
            if isinstance(item, jcore.ClosedJaxpr):
                item = item.jaxpr
            if isinstance(item, jcore.Jaxpr):
                yield item, len(item.invars) == len(eqn.invars)


def _f32_dots_without_highest(jaxpr, exact=frozenset()):
    """float32 dot_generals in ``jaxpr`` (recursively) that may run in
    TF32 and round: precision below HIGHEST, with an operand that is not
    converted from bool or integer 0/1 data (TF32 keeps those exact).
    ``exact`` holds the invars known to be such data."""
    import numpy as onp
    from jax.extend import core as jcore

    exact = set(exact)
    bad = []
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        ins = [v for v in eqn.invars if not isinstance(v, jcore.Literal)]
        if prim == "convert_element_type":
            src = eqn.invars[0].aval.dtype
            if onp.issubdtype(src, onp.integer) or src == onp.bool_:
                exact.add(eqn.outvars[0])
            elif ins and all(v in exact for v in ins):
                exact.add(eqn.outvars[0])
        elif prim in _VALUE_PRESERVING:
            if ins and all(v in exact for v in ins):
                exact.update(eqn.outvars)
        elif prim == "dot_general":
            prec = eqn.params.get("precision")
            precs = prec if isinstance(prec, tuple) else (prec,)
            highest = all(p == jax.lax.Precision.HIGHEST for p in precs)
            f32 = any(v.aval.dtype == onp.float32 for v in eqn.invars)
            both_exact = all(v in exact for v in ins)
            if f32 and not highest and not both_exact:
                bad.append(str(eqn))
            (lhs_c, _), _ = eqn.params["dimension_numbers"]
            depth = int(onp.prod([ins[0].aval.shape[d] for d in lhs_c]))
            if both_exact and depth <= 2048:
                # sums of <= 2048 0/1 products are integers that TF32's
                # 11 significant bits still hold exactly
                exact.update(eqn.outvars)
        for sub, matched in _sub_jaxprs(eqn):
            sub_exact = (
                {
                    iv
                    for iv, ov in zip(sub.invars, eqn.invars)
                    if not isinstance(ov, jcore.Literal) and ov in exact
                }
                if matched
                else set()
            )
            bad += _f32_dots_without_highest(sub, sub_exact)
    return bad


@pytest.mark.parametrize("method", ["osd_e", "osd_cs"])
def test_osd_weight_sums_are_not_tf32(method):
    """On a GPU a float32 matmul at default precision may run in TF32,
    which can reorder OSD-E/CS candidates: every float32 contraction of
    real-valued data in the sweep must ask for HIGHEST precision."""
    import jax.numpy as jnp

    from ldpc_tpu.ops import osd as osd_ops
    from ldpc_tpu.ops.pcm import compile_pcm

    code = surface_code(3)
    graph = compile_pcm(code.hx)
    meth = osd_ops.EXHAUSTIVE if method == "osd_e" else osd_ops.COMBINATION_SWEEP
    fn = osd_ops.make_osd_decoder(graph, np.full(graph.n, 0.05), meth, 3)
    syn = jnp.zeros((4, graph.m), jnp.uint8)
    llr = jnp.zeros((4, graph.n), jnp.float32)
    jaxpr = jax.make_jaxpr(fn)(syn, llr).jaxpr
    assert _f32_dots_without_highest(jaxpr) == []
