"""BeliefFindDecoder: BP with a union-find fallback guided by BP LLRs.

API parity with the reference
(reference: src_python/ldpc/belief_find_decoder/_belief_find_decoder.pyx):
BP runs first; on non-convergence the union-find decoder grows clusters
guided by the BP posterior LLRs (arXiv:1709.06218 + arXiv:2103.08049).
``uf_method`` is 'peeling' (default, column degree <= 2 only) or
'inversion' (_belief_find_decoder.pyx:62-71).
"""

from typing import List, Optional, Union

import numpy as np
import scipy.sparse

import jax.numpy as jnp

from ldpc_tpu.decoders.base import BpDecoderBase
from ldpc_tpu.ops import uf as uf_ops


class BeliefFindDecoder(BpDecoderBase):
    """BP + union-find (BeliefFind) decoder, batched."""

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
        uf_method: str = "peeling",
        bits_per_step: int = 0,
        input_vector_type: str = "syndrome",
        **kwargs,
    ):
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
            **kwargs,
        )
        self.uf_method = uf_method  # validates + checks column degrees
        self.bits_per_step = bits_per_step if bits_per_step != 0 else self.n
        self._uf_fn = None

    @property
    def uf_method(self) -> str:
        return self._uf_method

    @uf_method.setter
    def uf_method(self, value: str) -> None:
        sval = str(value).lower()
        if sval in ("inversion", "invert", "matrix"):
            self._uf_method = "inversion"
        elif sval in ("peeling", "peel"):
            col_deg = np.asarray((self._pcm != 0).sum(axis=0)).ravel()
            bad = np.flatnonzero(col_deg > 2)
            if bad.size:
                raise ValueError(
                    "The 'peeling' method is only suitable for LDPC codes "
                    "with point like syndromes. Each column of the PCM must "
                    f"have at most 2 entries. Column {bad[0]} has degree "
                    f"{col_deg[bad[0]]}."
                )
            self._uf_method = "peeling"
        else:
            raise ValueError(
                f"Invalid UF method: {value}. Must be one of 'inversion' "
                "or 'peeling'."
            )
        self._uf_fn = None

    def _uf_decode_fn(self):
        if self._uf_fn is None:
            maker = (
                uf_ops.make_uf_decoder
                if self._uf_method == "inversion"
                else uf_ops.make_peel_decoder
            )
            self._uf_fn = maker(self.graph, bits_per_step=self.bits_per_step)
        return self._uf_fn

    def decode(self, syndrome: np.ndarray) -> np.ndarray:
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        out = self.decode_batch(syndrome[None, :].astype(np.uint8))[0]
        return out.astype(syndrome.dtype)

    def decode_batch(
        self,
        syndromes: np.ndarray,
        *,
        bit_packed_syndromes: bool = False,
        bit_packed_output: bool = False,
    ) -> np.ndarray:
        """Batched BP, then one union-find program over the compacted
        non-converged subset (the reference decodes the UF fallback one
        syndrome at a time: _belief_find_decoder.pyx:125-136)."""
        syndromes = self._coerce_batch_syndromes(
            syndromes, bit_packed_syndromes
        )
        if syndromes.shape[1] != self.m:
            raise ValueError(
                f"The syndromes must have shape (batch, {self.m}). "
                f"Not {syndromes.shape}."
            )
        nonzero = syndromes.any(axis=1)
        fn = self._uf_decode_fn()
        if self._fused_ok():
            # single-dispatch fused cascade: phase-1 BP, device top-K
            # compaction, full-depth BP + union-find, ONE D2H pull
            out, _bpd = self._decode_batch_fused(
                syndromes,
                nonzero,
                post_key=("uf", self._uf_method, self.bits_per_step),
                post_builder=lambda: (lambda s, l: fn(s, l)[0]),
                bit_packed_output=bit_packed_output,
            )
            self._decoding = (
                out[0]
                if not bit_packed_output
                else np.unpackbits(
                    out[:1], axis=1, count=self.n, bitorder="little"
                )[0]
            )
            return out
        # device-compacted cascade: full-depth BP + union-find run only
        # on the non-converged bucket, one combined D2H pull
        # (base.py:_postprocess_cascade_batch)
        info = self._postprocess_cascade_batch(
            syndromes, nonzero, lambda s, l: fn(s, l)[0]
        )
        from ldpc_tpu.ops import gf2

        out = gf2.unpack_bits_u8(info["out_packed"], self.n)
        conv = info["conv"]
        self.converge_batch = conv
        self.iter_batch = info["iters"]
        self.log_prob_ratios_batch = info["llr_batch"]  # device; lazy
        self._converge = bool(conv[0])
        self._iter = int(self.iter_batch[0])
        self._log_prob_ratios = np.asarray(info["llr_row0"])
        self._decoding = out[0]
        if bit_packed_output:
            return info["out_packed"]
        return out
