"""BpDecoder and SoftInfoBpDecoder.

API parity with the reference
(reference: src_python/ldpc/bp_decoder/_bp_decoder.pyx:580-812), plus a
batched ``decode_batch``.
"""

from typing import List, Optional, Union

import numpy as np
import scipy.sparse

import jax.numpy as jnp

from ldpc_tpu.decoders.base import (
    BpDecoderBase,
    _AUTO,
    _RECEIVED_VECTOR,
    _SYNDROME,
)
from ldpc_tpu.ops import bp as bp_ops


class BpDecoder(BpDecoderBase):
    """Belief propagation decoder for binary linear codes (batched).

    Parameters mirror the reference ``ldpc.BpDecoder``
    (reference: _bp_decoder.pyx:580-640): ``pcm``, ``error_rate``,
    ``error_channel``, ``max_iter`` (0 = block length), ``bp_method``
    ('product_sum'/'minimum_sum' + aliases), ``ms_scaling_factor``
    (0.0 = dynamic 1-2^-iter), ``schedule``
    ('parallel'/'serial'/'serial_relative'), ``omp_thread_count`` (unused),
    ``random_schedule_seed``, ``serial_schedule_order``,
    ``input_vector_type``, ``random_serial_schedule``.

    Addition beyond the reference: ``decode_batch(syndromes)`` decodes a (B, m)
    batch in one device program.
    """

    def __init__(
        self,
        pcm: Union[np.ndarray, scipy.sparse.spmatrix],
        error_rate: Optional[float] = None,
        error_channel: Optional[Union[np.ndarray, List[float]]] = None,
        max_iter: Optional[int] = 0,
        bp_method: Optional[str] = "minimum_sum",
        ms_scaling_factor: Optional[Union[float, int]] = 1.0,
        schedule: Optional[str] = "parallel",
        omp_thread_count: Optional[int] = 1,
        random_schedule_seed: Optional[int] = 0,
        serial_schedule_order: Optional[List[int]] = None,
        input_vector_type: str = "auto",
        random_serial_schedule: bool = False,
        **kwargs,
    ):
        for key in kwargs.keys():
            if key not in ("channel_probs", "dtype"):
                raise ValueError(
                    f"Unknown parameter '{key}' passed to the BpDecoder constructor."
                )
        super().__init__(
            pcm,
            error_rate=error_rate,
            error_channel=error_channel,
            max_iter=max_iter,
            bp_method=bp_method,
            ms_scaling_factor=ms_scaling_factor,
            schedule=schedule,
            omp_thread_count=omp_thread_count,
            random_schedule_seed=random_schedule_seed,
            serial_schedule_order=serial_schedule_order,
            random_serial_schedule=random_serial_schedule,
            **kwargs,
        )
        self.input_vector_type = input_vector_type

    def decode(self, input_vector: np.ndarray) -> np.ndarray:
        """Decode one syndrome (length m) or received vector (length n).

        Zero inputs short-circuit to the all-zero decoding with
        ``converge=True`` (reference: _bp_decoder.pyx:678-681).
        """
        input_vector = np.asarray(input_vector)
        length = len(input_vector)
        if self._input_vector_type == _SYNDROME and length != self.m:
            raise ValueError(
                f"The input_vector must have length {self.m} (for syndrome "
                f"decoding). Not length {length}."
            )
        if self._input_vector_type == _RECEIVED_VECTOR and length != self.n:
            raise ValueError(
                f"The input_vector must have length {self.n} (for received "
                f"vector decoding). Not length {length}."
            )
        if self._input_vector_type == _AUTO and length not in (self.m, self.n):
            raise ValueError(
                f"The input_vector must have length {self.m} (for syndrome "
                f"decoding) or length {self.n} (for received vector decoding). "
                f"Not length {length}."
            )
        dtype = input_vector.dtype

        if not input_vector.any():
            self._converge = True
            return np.zeros(self.n, dtype=dtype)

        as_syndrome = self._input_vector_type == _SYNDROME or (
            self._input_vector_type == _AUTO and length == self.m
        )
        if as_syndrome:
            result = self._run_bp_batch(input_vector[None, :].astype(np.uint8))
            self._store_single_result(result)
            return self._decoding.astype(dtype)

        # received-vector mode: decode the vector's syndrome, then XOR the
        # BP decoding back onto the received vector (bp.hpp:162-180)
        rv = input_vector.astype(np.uint8) % 2
        syndrome = (self.pcm @ rv) % 2
        result = self._run_bp_batch(syndrome[None, :].astype(np.uint8))
        self._store_single_result(result)
        self._decoding = (self._decoding ^ rv).astype(np.uint8)
        return self._decoding.astype(dtype)

    def decode_batch(
        self,
        syndromes: np.ndarray,
        *,
        bit_packed_syndromes: bool = False,
        bit_packed_output: bool = False,
    ) -> np.ndarray:
        """Decode a (B, m) batch of syndromes in one device program.

        Returns the (B, n) decodings; per-element ``converge``/``iter``/
        ``log_prob_ratios`` are exposed as batch arrays on the instance
        (``converge_batch``, ``iter_batch``, ``log_prob_ratios_batch``).
        ``bit_packed_syndromes``/``bit_packed_output`` take/return
        little-endian bit-packed rows (stim b8 layout).
        """
        syndromes = self._coerce_batch_syndromes(
            syndromes, bit_packed_syndromes
        )
        if syndromes.shape[1] != self.m:
            raise ValueError(
                f"The syndromes must have shape (batch, {self.m}). Not {syndromes.shape}."
            )
        if self._fused_ok() and self._max_iter > self._CASCADE_ITERS:
            # single-dispatch two-phase cascade with no postprocessor:
            # failed rows keep their (full-depth) BP decoding, so results
            # are identical to the plain full-batch run
            out, _ = self._decode_batch_fused(
                syndromes,
                syndromes.any(axis=1),
                post_key="bp_only",
                post_builder=None,
                bit_packed_output=bit_packed_output,
            )
            return out
        result = self._run_bp_batch(syndromes.astype(np.uint8))
        # ONE combined device->host pull: [packed decodings | packed
        # converged | iters int32]. The f32 LLR batch is ~10x the payload
        # of everything else, so LLRs stay on device until first access.
        buf_np = np.asarray(self._bp_epilogue_fn()(
            result.decoding, result.converged, result.iterations
        ))
        B = syndromes.shape[0]
        Wb = -(-self.n // 8)
        o1 = B * Wb
        o2 = o1 + (-(-B // 8))
        packed_dec = buf_np[:o1].reshape(B, Wb)
        self.converge_batch = np.unpackbits(
            buf_np[o1:o2], count=B, bitorder="little"
        ).astype(bool)
        self.iter_batch = (
            np.ascontiguousarray(buf_np[o2:]).view(np.int32)[:B].copy()
        )
        self.log_prob_ratios_batch = result.llr_posterior  # device; lazy
        if bit_packed_output:
            return packed_dec
        from ldpc_tpu.ops import gf2

        return gf2.unpack_bits_u8(packed_dec, self.n)

    def _bp_epilogue_fn(self):
        fn = self._decoder_cache.get("bp_epilogue")
        if fn is None:
            import jax
            from ldpc_tpu.ops import gf2

            def epilogue(dec, conv, iters):
                return jnp.concatenate(
                    [
                        gf2.pack_bits_u8(dec).reshape(-1),
                        gf2.pack_bits_u8(
                            conv.astype(jnp.uint8)[None, :]
                        )[0],
                        # int32 layout: max_iter=0 means n iterations
                        # (reference semantics), so codes with n > 65535
                        # must not saturate a u16 count
                        jax.lax.bitcast_convert_type(
                            iters.astype(jnp.int32), jnp.uint8
                        ).reshape(-1),
                    ]
                )

            fn = jax.jit(epilogue)
            self._decoder_cache["bp_epilogue"] = fn
        return fn

    def _single_scan_fn(self):
        key = ("single_scan", self._max_iter, float(self._ms_scaling_factor))
        fn = self._decoder_cache.get(key)
        if fn is None:
            fn = bp_ops.make_single_scan_decoder(
                self.graph,
                self._max_iter,
                self._ms_scaling_factor,
                dtype=self._dtype,
            )
            self._decoder_cache[key] = fn
        return fn

    def decode_single_scan(self, syndrome: np.ndarray) -> np.ndarray:
        """Min-sum single-scan BP decode (reference: src_cpp/bp.hpp:327-449,
        exposed there only to the C++ tests). Ignores ``bp_method``/
        ``schedule``: single-scan is min-sum with the fixed
        ``ms_scaling_factor`` by construction."""
        syndrome = np.asarray(syndrome)
        if len(syndrome) != self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        dtype = syndrome.dtype
        if not syndrome.any():
            self._converge = True
            return np.zeros(self.n, dtype=dtype)
        fn = self._single_scan_fn()
        result = fn(
            jnp.asarray(syndrome[None, :], dtype=jnp.uint8),
            jnp.asarray(self._init_llr()),
        )
        self._store_single_result(result)
        return self._decoding.astype(dtype)


class SoftInfoBpDecoder(BpDecoderBase):
    """Soft-syndrome min-sum BP decoder (arXiv:2205.02341).

    Accounts for uncertainty in the syndrome readout with a serial schedule
    and virtual syndrome-update rules below the ``cutoff`` magnitude
    (reference: _bp_decoder.pyx:712-812; core: bp.hpp:547-665).
    """

    def __init__(
        self,
        pcm: Union[np.ndarray, scipy.sparse.spmatrix],
        error_rate: Optional[float] = None,
        error_channel: Optional[List[float]] = None,
        max_iter: Optional[int] = 0,
        bp_method: Optional[str] = "minimum_sum",
        ms_scaling_factor: Optional[float] = 1.0,
        cutoff: Optional[float] = np.inf,
        sigma: float = 2.0,
        **kwargs,
    ):
        super().__init__(
            pcm,
            error_rate=error_rate,
            error_channel=error_channel,
            max_iter=max_iter,
            bp_method=bp_method,
            ms_scaling_factor=ms_scaling_factor,
            **kwargs,
        )
        self.cutoff = cutoff
        if not isinstance(sigma, float) or sigma <= 0:
            raise ValueError("The sigma value must be a float greater than 0.")
        self.sigma = sigma
        self.schedule = "serial"
        self.bp_method = "minimum_sum"
        self.input_vector_type = "syndrome"
        self._soft_syndrome = np.zeros(self.m)

    def _soft_decode_fn(self):
        key = ("soft", self._max_iter, float(self._ms_scaling_factor))
        fn = self._decoder_cache.get(key)
        if fn is None:
            fn = bp_ops.make_soft_info_decoder(
                self.graph,
                self._max_iter,
                self._ms_scaling_factor,
                dtype=self._dtype,
            )
            self._decoder_cache[key] = fn
        return fn

    def decode(self, soft_info_syndrome: np.ndarray) -> np.ndarray:
        """Decode a single soft syndrome (length m, log-likelihood values)."""
        out = self.decode_batch(np.asarray(soft_info_syndrome, dtype=np.float64)[None, :])
        return out[0]

    def decode_batch(self, soft_syndromes: np.ndarray) -> np.ndarray:
        soft_syndromes = np.atleast_2d(np.asarray(soft_syndromes, dtype=np.float64))
        if soft_syndromes.shape[1] != self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {soft_syndromes.shape[1]}."
            )
        fn = self._soft_decode_fn()
        init_llr = jnp.asarray(self._init_llr())
        result, soft_out = fn(
            jnp.asarray(soft_syndromes, dtype=self._dtype),
            init_llr,
            float(self.cutoff),
            float(self.sigma),
        )
        self.converge_batch = np.asarray(result.converged)
        self.iter_batch = np.asarray(result.iterations)
        self.log_prob_ratios_batch = np.asarray(result.llr_posterior)
        self._converge = bool(self.converge_batch[0])
        self._iter = int(self.iter_batch[0])
        self._log_prob_ratios = self.log_prob_ratios_batch[0]
        self.soft_syndrome_batch = np.asarray(soft_out)
        self._soft_syndrome = self.soft_syndrome_batch[0]
        decodings = np.asarray(result.decoding)
        self._decoding = decodings[0]
        return decodings.astype(np.uint8)

    @property
    def soft_syndrome(self) -> np.ndarray:
        """The updated soft syndrome after decoding (reference: _bp_decoder.pyx:793)."""
        return np.asarray(self._soft_syndrome)
