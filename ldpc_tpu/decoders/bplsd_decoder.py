"""BpLsdDecoder: BP with localized-statistics-decoding fallback.

API parity with the reference
(reference: src_python/ldpc/bplsd_decoder/_bplsd_decoder.pyx): BP first,
on non-convergence LSD guided by the BP posterior LLRs
(_bplsd_decoder.pyx:144-155); ``lsd_method``/``lsd_order`` accept the
``osd_method``/``osd_order`` compatibility kwargs (:69-78);
``always_run_lsd`` bypasses the BP short-circuit.
"""

import time
import warnings
from typing import List, Optional, Union

import numpy as np
import scipy.sparse

import jax.numpy as jnp

from ldpc_tpu.decoders.base import BpDecoderBase
from ldpc_tpu.decoders.lsd_common import (
    METHOD_NAMES,
    Statistics,
    parse_lsd_method,
)
from ldpc_tpu.ops import lsd as lsd_ops


class BpLsdDecoder(BpDecoderBase):
    """BP + LSD decoder, batched (arXiv:2406.18655)."""

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
        bits_per_step: int = 1,
        input_vector_type: str = "syndrome",
        lsd_order: int = 0,
        lsd_method: Union[str, int] = 0,
        always_run_lsd: bool = False,
        **kwargs,
    ):
        # osd_method / osd_order compatibility (_bplsd_decoder.pyx:69-78)
        if "osd_method" in kwargs:
            lsd_method = kwargs.pop("osd_method")
        if "osd_order" in kwargs:
            lsd_order = kwargs.pop("osd_order")
        if lsd_order < 0:
            raise ValueError(
                f"lsd_order must be greater than or equal to 0. Not {lsd_order}."
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
            **kwargs,
        )
        self._lsd_method = 0
        self._lsd_order = 0
        self.lsd_method = lsd_method
        self.lsd_order = lsd_order
        self.always_run_lsd = always_run_lsd
        self.bits_per_step = bits_per_step if bits_per_step != 0 else self.n
        self._do_stats = False
        self._statistics = Statistics()
        self._lsd_fn = None

    # ------------------------------------------------------------------
    @property
    def lsd_method(self) -> Optional[str]:
        return METHOD_NAMES.get(self._lsd_method)

    @lsd_method.setter
    def lsd_method(self, method: Union[str, int, float]) -> None:
        self._lsd_method = parse_lsd_method(method)
        if self._lsd_method == lsd_ops.LSD_0:
            self._lsd_order = 0
        self._lsd_fn = None

    @property
    def lsd_order(self) -> int:
        return self._lsd_order

    @lsd_order.setter
    def lsd_order(self, order: int) -> None:
        if order < 0:
            raise ValueError(
                f"ERROR: OSD order '{order}' invalid. Please choose a "
                "positive integer."
            )
        if self._lsd_method == lsd_ops.LSD_0 and order != 0:
            raise ValueError(
                f"ERROR: OSD order '{order}' invalid. The 'osd_method' is "
                "set to 'OSD_0'. The osd order must therefore be set to 0."
            )
        if self._lsd_method == lsd_ops.LSD_E and order > 15:
            warnings.warn(
                "WARNING: Running the 'OSD_E' (Exhaustive method) with "
                "search depth greater than 15 is not recommended. Use the "
                "'osd_cs' method instead."
            )
        self._lsd_order = order
        self._lsd_fn = None

    # ------------------------------------------------------------------
    # statistics plumbing (reference: _bplsd_decoder.pyx:174-321)
    # ------------------------------------------------------------------
    @property
    def statistics(self) -> Statistics:
        return self._statistics

    @property
    def do_stats(self) -> bool:
        return self._do_stats

    def set_do_stats(self, value: bool, row: int = 0) -> None:
        """Enable statistics collection. ``row`` selects which batch
        element a subsequent ``decode_batch`` records statistics for
        (the reference's single-syndrome ``decode`` semantics correspond
        to row 0; ``statistics.stats_row`` records the choice)."""
        self._do_stats = bool(value)
        if row < 0:
            raise ValueError(f"stats row must be >= 0, not {row}")
        self._stats_row = int(row)

    @property
    def stats_row(self) -> int:
        """The batch row the next decode's statistics will describe."""
        return getattr(self, "_stats_row", 0)

    def set_additional_stat_fields(self, error, syndrome, compare_recover):
        self._statistics.error = list(np.asarray(error).astype(int))
        self._statistics.syndrome = list(np.asarray(syndrome).astype(int))
        self._statistics.compare_recover = list(
            np.asarray(compare_recover).astype(int)
        )

    def reset_cluster_stats(self) -> None:
        self._statistics = Statistics()

    # ------------------------------------------------------------------
    def _lsd_decode_fn(self):
        if self._lsd_fn is None:
            self._lsd_fn = lsd_ops.make_lsd_decoder(
                self.graph,
                lsd_method=max(self._lsd_method, 0),
                lsd_order=self._lsd_order,
                bits_per_step=self.bits_per_step,
            )
        return self._lsd_fn

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
        """Batched BP, then one LSD program over the compacted
        non-converged subset (always the full batch when
        ``always_run_lsd``)."""
        syndromes = self._coerce_batch_syndromes(
            syndromes, bit_packed_syndromes
        )
        if syndromes.shape[1] != self.m:
            raise ValueError(
                f"The syndromes must have shape (batch, {self.m}). "
                f"Not {syndromes.shape}."
            )
        t0 = time.perf_counter()
        nonzero = syndromes.any(axis=1)

        if self.always_run_lsd:
            # LSD on every nonzero element: keep the plain full-batch path
            bp = self._run_bp_batch(syndromes)
            out = np.array(bp.decoding)
            conv = np.asarray(bp.converged) | ~nonzero
            out[~nonzero] = 0
            llrs = np.asarray(bp.llr_posterior)
            failed = np.flatnonzero(nonzero)
            if failed.size:
                fn = self._lsd_decode_fn()
                bucket = 1 << int(failed.size - 1).bit_length()
                pad = bucket - failed.size
                syn_f = np.concatenate(
                    [syndromes[failed], np.zeros((pad, self.m), np.uint8)]
                )
                llr_f = np.concatenate(
                    [llrs[failed], np.zeros((pad, self.n), llrs.dtype)]
                )
                dec, _ = fn(jnp.asarray(syn_f), jnp.asarray(llr_f))
                out[failed] = np.asarray(dec)[: failed.size]
            self.converge_batch = conv
            self.iter_batch = np.asarray(bp.iterations)
            llr_row0 = llrs[0]
            self.log_prob_ratios_batch = llrs
            self._bp_decoding = np.asarray(bp.decoding)[0]
            self._converge = bool(conv[0])
            self._iter = int(self.iter_batch[0])
            self._log_prob_ratios = llr_row0
            self._decoding = out[0]
        else:
            fused = None
            if self._fused_ok():
                # single-dispatch fused cascade (base.py): ONE D2H pull
                fn = self._lsd_decode_fn()
                fused, bpd_lazy = self._decode_batch_fused(
                    syndromes,
                    nonzero,
                    post_key=(
                        "lsd",
                        self._lsd_method,
                        self._lsd_order,
                        self.bits_per_step,
                    ),
                    post_builder=lambda: (lambda s, l: fn(s, l)[0]),
                    bit_packed_output=bit_packed_output,
                )
                out = fused
                conv = self.converge_batch
                llr_row0 = self._log_prob_ratios  # device row; lazy
                self._bp_decoding_lazy = bpd_lazy
                self._bp_decoding = None
                if bit_packed_output:
                    self._decoding = np.unpackbits(
                        out[:1], axis=1, count=self.n, bitorder="little"
                    )[0]
                else:
                    self._decoding = out[0]
            if fused is None:
                # device-compacted cascade: one combined D2H pull
                # (base.py:_postprocess_cascade_batch)
                fn = self._lsd_decode_fn()
                info = self._postprocess_cascade_batch(
                    syndromes, nonzero, lambda s, l: fn(s, l)[0]
                )
                from ldpc_tpu.ops import gf2

                out = gf2.unpack_bits_u8(info["out_packed"], self.n)
                conv = info["conv"]
                self.converge_batch = conv
                self.iter_batch = info["iters"]
                llr_row0 = np.asarray(info["llr_row0"])
                self.log_prob_ratios_batch = info["llr_batch"]  # device; lazy
                self._bp_decoding = np.asarray(info["bp_dec_row0"])
                self._converge = bool(conv[0])
                self._iter = int(self.iter_batch[0])
                self._log_prob_ratios = llr_row0
                self._decoding = out[0]
            llrs = None

        # the LSD result is live for the stats row iff full-depth BP did
        # not converge there (conv is full-depth: the cascade scatters
        # bucket convergence back) — phase-1 failures that later converge
        # get their stats cleared, as the reference's converge branch
        # does — or when always_run_lsd forces the LSD stage regardless
        r = min(self.stats_row, syndromes.shape[0] - 1)
        lsd_ran = bool(nonzero[r]) and (
            self.always_run_lsd or not bool(conv[r])
        )
        if not lsd_ran:
            # BP converged: stats reset, as the reference's converge
            # branch does (_bplsd_decoder.pyx:146-150)
            self._statistics.clear()
        else:
            self._statistics.clear()
            if self._do_stats:
                # per-cluster growth history of the selected element's
                # LSD decode, replayed with the decoder's own growth
                # primitives (lsd.hpp:652-816 semantics)
                from ldpc_tpu.decoders.lsd_stats import compute_lsd_statistics

                llr_r = (
                    np.asarray(llr_row0)
                    if r == 0
                    else np.asarray(self.log_prob_ratios_batch[r])
                )
                dec_r = (
                    self._decoding
                    if r == 0
                    else np.unpackbits(
                        out[r : r + 1],
                        axis=1,
                        count=self.n,
                        bitorder="little",
                    )[0]
                    if out.shape[1] == -(-self.n // 8)
                    else out[r]
                )
                self._statistics.stats_row = r
                self._statistics.bit_llrs = list(map(float, llr_r))
                self._statistics.syndrome = list(map(int, syndromes[r]))
                compute_lsd_statistics(
                    self.graph,
                    scipy.sparse.csc_matrix(self.pcm),
                    syndromes[r],
                    llr_r,
                    self.bits_per_step,
                    dec_r,
                    dtype=self._dtype,
                    stats=self._statistics,
                )
        self._statistics.elapsed_time = (time.perf_counter() - t0) * 1e6
        self._statistics.lsd_order = self._lsd_order
        # stats carry the reference's OsdMethod enum value, where
        # OSD_OFF=0 and OSD_0=1 (osd.hpp:18-23; the constructor's
        # 0/1/2 aliases map to 1/2/3 there)
        self._statistics.lsd_method = max(self._lsd_method, -1) + 1
        if bit_packed_output and out.shape[1] != -(-self.n // 8):
            return np.packbits(out, axis=1, bitorder="little")
        return out

    @property
    def bp_decoding(self) -> np.ndarray:
        if self._bp_decoding is None and hasattr(self, "_bp_decoding_lazy"):
            self._bp_decoding = np.asarray(self._bp_decoding_lazy[0])
        return np.asarray(self._bp_decoding).astype(int)
