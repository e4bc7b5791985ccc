"""BpOsdDecoder: belief propagation + ordered-statistics fallback.

API parity with the reference
(reference: src_python/ldpc/bposd_decoder/_bposd_decoder.pyx), with a
batched ``decode_batch``: BP runs on the whole batch, then the OSD program
runs once on the compacted non-converged subset.
"""

import warnings
from typing import List, Optional, Union

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp

from ldpc_tpu.decoders import base as _base
from ldpc_tpu.decoders.base import BpDecoderBase
from ldpc_tpu.decoders.bp_decoder import SoftInfoBpDecoder
from ldpc_tpu.ops import osd as osd_ops

_METHOD_NAMES = {
    osd_ops.OSD_0: "OSD_0",
    osd_ops.EXHAUSTIVE: "OSD_E",
    osd_ops.COMBINATION_SWEEP: "OSD_CS",
    osd_ops.OSD_OFF: "OSD_OFF",
}


from ldpc_tpu.decoders.lazy import LazyChunks as _LazyChunks


class BpOsdDecoder(BpDecoderBase):
    """BP decoding with OSD post-processing (batched).

    Runs belief propagation first; on non-convergence falls back to
    ordered-statistics decoding guided by the BP posterior LLRs
    (reference: _bposd_decoder.pyx:78-137). ``osd_method`` is one of
    'OSD_0' | 'OSD_E' | 'OSD_CS' | 'OSD_OFF' (plus the reference's
    aliases); ``osd_order`` is the search depth.
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
        osd_method: Union[str, int, float] = 0,
        osd_order: int = 0,
        input_vector_type: str = "syndrome",
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
        self._osd_method = 0
        self._osd_order = 0
        self.osd_method = osd_method
        self.osd_order = osd_order
        self._osd0_decoding = np.zeros(self.n, dtype=np.uint8)
        self._osdw_decoding = np.zeros(self.n, dtype=np.uint8)
        self._bp_decoding = np.zeros(self.n, dtype=np.uint8)

    # ------------------------------------------------------------------
    # OSD configuration (reference: _bposd_decoder.pyx:141-233)
    # ------------------------------------------------------------------
    @property
    def osd_method(self) -> Optional[str]:
        return _METHOD_NAMES[self._osd_method]

    @osd_method.setter
    def osd_method(self, method: Union[str, int, float]) -> None:
        sval = str(method).lower()
        if sval in ("osd_0", "0", "osd0"):
            self._osd_method = osd_ops.OSD_0
            self._osd_order = 0
        elif sval in ("osd_e", "e", "exhaustive"):
            self._osd_method = osd_ops.EXHAUSTIVE
        elif sval in ("osd_cs", "1", "cs", "combination_sweep"):
            self._osd_method = osd_ops.COMBINATION_SWEEP
        elif sval in ("off", "osd_off", "deactivated", "-1"):
            self._osd_method = osd_ops.OSD_OFF
        else:
            raise ValueError(
                f"ERROR: OSD method '{method}' invalid. Please choose from "
                "the following methods: 'OSD_0', 'OSD_E' or 'OSD_CS'."
            )
        self._invalidate_osd()

    @property
    def osd_order(self) -> int:
        return self._osd_order

    @osd_order.setter
    def osd_order(self, order: int) -> None:
        if order < 0:
            raise ValueError(
                f"ERROR: OSD order '{order}' invalid. Please choose a "
                "positive integer."
            )
        if self._osd_method == osd_ops.OSD_0 and order != 0:
            raise ValueError(
                f"ERROR: OSD order '{order}' invalid. The 'osd_method' is "
                "set to 'OSD_0'. The osd order must therefore be set to 0."
            )
        if self._osd_method == osd_ops.EXHAUSTIVE and order > 15:
            warnings.warn(
                "WARNING: Running the 'OSD_E' (Exhaustive method) with "
                "search depth greater than 15 is not recommended. Use the "
                "'osd_cs' method instead."
            )
        self._osd_order = order
        self._invalidate_osd()

    def _invalidate_osd(self):
        for key in [key for key in self._decoder_cache if key and key[0] == "osd"]:
            del self._decoder_cache[key]

    def _osd_decode_fn(self):
        key = ("osd", self._osd_method, self._osd_order, tuple(self._channel))
        fn = self._decoder_cache.get(key)
        if fn is None:
            fn = osd_ops.make_osd_decoder(
                self.graph,
                self._channel,
                self._osd_method,
                self._osd_order,
                dtype=jnp.float64 if self._dtype == jnp.float64 else jnp.float32,
            )
            fn = jax.jit(_base._scoped("osd", fn))
            self._decoder_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    # decoding
    # ------------------------------------------------------------------
    def decode(self, syndrome: np.ndarray) -> np.ndarray:
        """BP decode; on non-convergence fall back to OSD
        (reference: _bposd_decoder.pyx:78-137)."""
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        out = self.decode_batch(syndrome[None, :].astype(np.uint8))[0]
        return out.astype(syndrome.dtype)

    # _CASCADE_ITERS / _cascade_fns / _pack_fn inherited from
    # BpDecoderBase (shared with BpLsd/BeliefFind)

    def _epilogue_fn(self):
        """Fused device epilogue: pick BP-vs-OSD per element, scatter the
        subset back into the full batch, bit-pack outputs and metadata
        into ONE uint8 buffer, so everything the host needs travels in a
        single row-major array. The OSD-0 decodings stay on device
        (second return) and are pulled lazily on property access."""
        fn = self._decoder_cache.get("epilogue")
        if fn is None:
            import jax

            def epilogue(dec1, conv1, iters1, idx, rowvalid,
                         dec2, conv2, iters2, d0, dw):
                B = dec1.shape[0]
                out_f = jnp.where(conv2[:, None], dec2, dw)
                osd0_f = jnp.where(conv2[:, None], dec2, d0)
                idxs = jnp.where(rowvalid, idx, B)  # sentinel row
                sent = jnp.zeros((1, dec1.shape[1]), dec1.dtype)
                base = jnp.concatenate([dec1, sent])
                outw = base.at[idxs].set(out_f)[:B]
                out0 = base.at[idxs].set(osd0_f)[:B]
                conv = jnp.concatenate([conv1, jnp.zeros(1, bool)])
                conv = conv.at[idxs].set(conv2)[:B]
                iters = jnp.concatenate([iters1, jnp.zeros(1, jnp.int32)])
                iters = iters.at[idxs].set(iters2)[:B]
                # combined row: [packed decoding | conv byte | iters int32]
                combined = jnp.concatenate(
                    [
                        osd_ops.gf2.pack_bits_u8(outw),
                        conv.astype(jnp.uint8)[:, None],
                        jax.lax.bitcast_convert_type(iters, jnp.uint8),
                    ],
                    axis=1,
                )
                return combined, osd_ops.gf2.pack_bits_u8(out0)

            fn = jax.jit(epilogue)
            self._decoder_cache["epilogue"] = fn
        return fn

    def _merge_pack_fn(self):
        """Jitted merge of the OSD-failed-subset results into the BP
        output plus bit-packing — one device dispatch, one small pull."""
        fn = self._decoder_cache.get("merge_pack")
        if fn is None:

            def merge_pack(out, idx, d0, dw, rowvalid):
                # scatter through a sentinel row so padded idx slots
                # can't race a real row-0 write
                B = out.shape[0]
                sent = jnp.full((1,) + out.shape[1:], 0, out.dtype)
                idx = jnp.where(rowvalid, idx, B)
                merged = jnp.concatenate([out, sent])
                osdw = merged.at[idx].set(dw)[:B]
                osd0 = merged.at[idx].set(d0)[:B]
                return (
                    osd_ops.gf2.pack_bits_u8(osdw),
                    osd_ops.gf2.pack_bits_u8(osd0),
                )

            import jax

            fn = jax.jit(merge_pack)
            self._decoder_cache["merge_pack"] = fn
        return fn

    # ------------------------------------------------------------------
    # fused single-dispatch chunk loop (BP + OSD in one program per chunk)
    # ------------------------------------------------------------------
    def _osd_fused_fn(self, Bpad: int, K: int, sparse_plan=None, K2=0):
        """One jitted program per chunk: unpack packed syndromes -> BP
        -> device top-K compaction of non-converged elements -> OSD ->
        merge + bit-pack. The host pulls ONE uint8 buffer per chunk —
        packed decodings, packed converged bits, the failure counts and
        iteration counts back-to-back — and never syncs inside the
        chunk to build a bucket. BP LLRs/decodings stay on device and
        are pulled lazily on property access. The failure count lets
        the host detect (rare) bucket overflow without an extra sync."""
        key = (
            "osd_fused", self._osd_method, self._osd_order,
            self._channel.tobytes(), self._config_key(), Bpad, K,
            sparse_plan, K2,
        )
        fn = self._decoder_cache.get(key)
        if fn is not None:
            return fn
        from ldpc_tpu.ops.gf2 import pack_bits_u8, unpack_bits_u8_device

        m = self.m
        # Two-phase cascade inside one program (mirrors
        # ``_decode_batch_cascade``): cheap phase-1 BP over the whole
        # chunk, then full-depth BP + OSD only on the compacted top-K
        # non-converged bucket. Per-element BP is deterministic, so
        # bucket elements reproduce exactly what a single full-depth run
        # would give; elements that converged in phase 1 are already
        # frozen at their final state. The host redoes the chunk with
        # K=Bpad if phase-1 failures overflow the bucket, so outputs
        # are exact in every case.
        p1 = min(self._CASCADE_ITERS, self._max_iter)
        two_phase = K > 0 and p1 < self._max_iter
        bp_fn = _base._scoped(
            "phase1_bp",
            self._make_parallel_bp(p1 if two_phase else self._max_iter),
        )
        bp2_fn = (
            _base._scoped("bucket_bp", self._make_parallel_bp(self._max_iter))
            if two_phase
            else None
        )
        osd_fn = (
            self._osd_decode_fn()
            if K > 0 and self._osd_method != osd_ops.OSD_OFF
            else None
        )
        # OSD-E/CS at order > 0: the OSD-0 decodings differ from OSD-w's
        # and are exported beside them
        sweep = (
            self._osd_method in (osd_ops.EXHAUSTIVE, osd_ops.COMBINATION_SWEEP)
            and self._osd_order > 0
        )
        init_llr = jnp.asarray(self._init_llr())

        def program(packed_syn):
            syn = unpack_bits_u8_device(packed_syn, m)  # (Bpad, m) uint8
            bp = bp_fn(syn, init_llr)
            nonzero = syn.any(axis=1)
            conv_eff = bp.converged | ~nonzero
            dec, llrs, iters = bp.decoding, bp.llr_posterior, bp.iterations
            nfail = (~conv_eff).sum().astype(jnp.int32)
            if two_phase or osd_fn is not None:
                order = jnp.argsort(conv_eff, stable=True)  # failed first
                idx = order[:K]
                syn_f = jnp.take(syn, idx, axis=0)
                if two_phase:
                    bp2 = bp2_fn(syn_f, init_llr)
                    sub_dec = bp2.decoding
                    sub_conv = bp2.converged | ~syn_f.any(axis=1)
                    sub_llr, sub_iters = bp2.llr_posterior, bp2.iterations
                    llrs = llrs.at[idx].set(sub_llr)
                    dec = dec.at[idx].set(sub_dec)
                    conv_eff = conv_eff.at[idx].set(sub_conv)
                    iters = iters.at[idx].set(sub_iters)
                else:
                    sub_dec = jnp.take(dec, idx, axis=0)
                    sub_conv = jnp.take(conv_eff, idx)
                    sub_llr = jnp.take(llrs, idx, axis=0)
                has_post = osd_fn is not None
                nfail2 = (
                    (~sub_conv).sum().astype(jnp.int32)
                    if has_post
                    else jnp.int32(0)  # no post: overflow is meaningless
                )
                use_k2 = 0 < K2 < K and has_post
                if use_k2:
                    # second-level compaction: OSD only matters on rows
                    # full-depth BP failed (~1%); the host redispatches
                    # with a full post bucket on nfail2 overflow
                    order2 = jnp.argsort(sub_conv, stable=True)
                    idx2 = order2[:K2]
                    syn_p = jnp.take(syn_f, idx2, axis=0)
                    llr_p = jnp.take(sub_llr, idx2, axis=0)
                else:
                    syn_p, llr_p = syn_f, sub_llr
                if osd_fn is not None:
                    d0, dw, _ = osd_fn(syn_p, llr_p)
                else:
                    d0 = dw = None
                if d0 is not None and use_k2:
                    dw = (
                        jnp.zeros_like(sub_dec).at[idx2]
                        .set(dw.astype(sub_dec.dtype))
                    )
                    d0 = (
                        jnp.zeros_like(sub_dec).at[idx2]
                        .set(d0.astype(sub_dec.dtype))
                    )
                if d0 is not None:
                    merged = jnp.where(
                        sub_conv[:, None], sub_dec, dw.astype(sub_dec.dtype)
                    )
                    merged0 = jnp.where(
                        sub_conv[:, None], sub_dec, d0.astype(sub_dec.dtype)
                    )
                else:
                    merged = merged0 = sub_dec
                out = dec.at[idx].set(merged)
                out0 = dec.at[idx].set(merged0) if sweep else out
            else:
                nfail2 = jnp.int32(0)
                out = out0 = dec
            out = out * nonzero[:, None].astype(out.dtype)
            packed_d0 = (
                pack_bits_u8(out0 * nonzero[:, None].astype(out0.dtype))
                if sweep
                else None
            )
            if sparse_plan is not None:
                # segmented index-coded export (see
                # base._sparse_export_plan): per-segment sorted set-bit
                # positions + count byte; host redispatches dense if any
                # segment count exceeds K
                S, Ks = sparse_plan
                L = _base._SEG_L
                flat = out.reshape(-1)
                xp = jnp.pad(
                    flat, (0, S * L - flat.shape[0])
                ).reshape(S, L)
                mask = xp != 0
                keys = jnp.where(
                    mask, jnp.arange(L, dtype=jnp.int32)[None, :], L
                )
                sk = jax.lax.sort(keys, dimension=1)[:, :Ks]
                cnts = jnp.minimum(mask.sum(axis=1), 255).astype(jnp.uint8)
                head = jnp.concatenate(
                    [
                        jnp.minimum(sk, 255).astype(jnp.uint8).reshape(-1),
                        cnts,
                    ]
                )
            else:
                head = pack_bits_u8(out).reshape(-1)
            it_jdt = _base._iters_dtype(self._max_iter)[0]
            buf = jnp.concatenate(
                [
                    head,
                    pack_bits_u8(conv_eff[None, :].astype(jnp.uint8))[0],
                    jax.lax.bitcast_convert_type(nfail, jnp.uint8),
                    jax.lax.bitcast_convert_type(nfail2, jnp.uint8),
                    jax.lax.bitcast_convert_type(
                        iters.astype(it_jdt), jnp.uint8
                    ).reshape(-1),
                ]
            )  # (head + Bpad/8 + 8 + it_size*Bpad,) uint8
            if packed_d0 is None:
                # OSD-0/off: osdw==osd0, the host never reads d0p (see
                # _decode_batch_chunked) — a dense re-pack of `out` here
                # forces XLA to materialize a second consumer of the
                # merge and tripled the sparse-export path on HGP
                packed_d0 = jnp.zeros((1, 1), jnp.uint8)
            return buf, llrs, dec, packed_d0

        fn = jax.jit(program)
        self._decoder_cache[key] = fn
        return fn

    @staticmethod
    def _round_up(x: int, mult: int) -> int:
        return -(-x // mult) * mult

    def _decode_batch_chunked(
        self,
        packed_all: np.ndarray,
        B0: int,
        nonzero,
        bit_packed_output: bool = False,
    ) -> np.ndarray:
        """Chunked pipeline over the fused program: each chunk's
        H2D/compute/D2H overlaps the neighbours' via JAX async dispatch +
        ``copy_to_host_async``, and every chunk costs exactly ONE D2H pull
        (all results ride one uint8 buffer)."""
        CH = self._FUSED_CHUNK
        Wb = -(-self.n // 8)
        wbar = float(np.sum(self._channel))
        it_ndt, it_size = _base._iters_dtype(self._max_iter)[1:]
        starts = list(range(0, B0, CH)) or [0]
        launches = []
        for st in starts:
            chunk = packed_all[st : st + CH]
            Bc = chunk.shape[0]
            Bpad = (
                self._round_up(Bc, 512)
                if Bc >= 512
                else max(128, self._round_up(Bc, 128))
            )
            # bucket sized from the worst failure fraction seen so far
            # (surface ~9%; HGP-family codes fail BP far more often —
            # without the hint every chunk overflows and redispatches)
            frac = getattr(self, "_nfail_frac_hint", 0.0)
            K = min(
                Bpad,
                max(
                    128,
                    self._round_up(Bpad // 8, 128),
                    self._round_up(int(frac * Bpad * 1.3) + 1, 128),
                ),
            )
            # second-level post bucket from the observed FULL-DEPTH
            # failure fraction: surface codes fail BP on ~9% of
            # syndromes (K2 grows to K -> compaction naturally off),
            # while e.g. the [[400,16,6]] HGP fails on ~0.6% — there the
            # OSD stage runs on 8x fewer rows (the n=400 elimination is
            # ~13 us/row, the dominant stage otherwise)
            frac2 = getattr(self, "_nfail2_frac_hint", 1.0 / 64.0)
            K2 = min(
                K,
                max(128, self._round_up(int(frac2 * Bpad * 1.5) + 1, 128)),
            )
            plan = _base._plan_unless_disabled(self, Bpad, Wb, wbar)
            if Bpad != Bc:
                chunk = np.concatenate(
                    [chunk, np.zeros((Bpad - Bc, chunk.shape[1]), np.uint8)]
                )
            dev = jnp.asarray(chunk)
            buf, llrs, bpd, d0p = self._osd_fused_fn(Bpad, K, plan, K2)(dev)
            buf.copy_to_host_async()
            launches.append(
                (st, Bc, Bpad, K, K2, plan, dev, buf, llrs, bpd, d0p)
            )

        out_packed = np.empty((B0, Wb), np.uint8)
        out = None if bit_packed_output else np.empty((B0, self.n), np.uint8)
        conv = np.empty(B0, bool)
        iters = np.empty(B0, np.int32)
        llr_chunks, bpd_chunks, d0_chunks = [], [], []
        for st, Bc, Bpad, K, K2, plan, dev, buf, llrs, bpd, d0p in launches:
            # overflow redispatch loop (see base._decode_batch_fused)
            for _ in range(4):
                buf_np = np.asarray(buf)
                o1 = plan[0] * (plan[1] + 1) if plan else Bpad * Wb
                o2 = o1 + Bpad // 8
                o3 = o2 + 8
                nfail, nfail2 = (
                    np.ascontiguousarray(buf_np[o2:o3]).view(np.int32)[:2]
                )
                seg_over = bool(
                    plan and buf_np[plan[0] * plan[1] : o1].max() > plan[1]
                )
                self._nfail_frac_hint = max(
                    getattr(self, "_nfail_frac_hint", 0.0),
                    float(nfail) / max(Bpad, 1),
                )
                self._nfail2_frac_hint = max(
                    getattr(self, "_nfail2_frac_hint", 0.0),
                    float(nfail2) / max(Bpad, 1),
                )
                if seg_over:
                    self._seg_plan_off = True  # see _plan_unless_disabled
                if not (nfail > K or 0 < K2 < nfail2 or seg_over):
                    break
                K2 = K if 0 < K2 < nfail2 else K2
                K = Bpad if nfail > K else K
                K2 = min(K2, K)
                plan = None if seg_over else plan
                buf, llrs, bpd, d0p = self._osd_fused_fn(
                    Bpad, K, plan, K2
                )(dev)
            conv_bits = np.unpackbits(
                buf_np[o1:o2], count=Bc, bitorder="little"
            ).astype(bool)
            it_np = np.ascontiguousarray(buf_np[o3:]).view(it_ndt)[:Bc].copy()
            if plan:
                outc = _base._reconstruct_segments(
                    buf_np, plan, Bpad, self.n
                )[:Bc]
                out_packed[st : st + Bc] = np.packbits(
                    outc, axis=1, bitorder="little"
                )
                if out is not None:
                    out[st : st + Bc] = outc
            else:
                pd_np = buf_np[:o1].reshape(Bpad, Wb)
                out_packed[st : st + Bc] = pd_np[:Bc]
                if out is not None:
                    out[st : st + Bc] = osd_ops.gf2.unpack_bits_u8(
                        pd_np[:Bc], self.n
                    )
            conv[st : st + Bc] = conv_bits
            iters[st : st + Bc] = it_np
            llr_chunks.append(llrs)
            bpd_chunks.append(bpd)
            d0_chunks.append(d0p)

        conv |= ~nonzero
        out_packed[~nonzero] = 0
        if out is not None:
            out[~nonzero] = 0

        self.converge_batch = conv
        self.iter_batch = iters
        self._converge = bool(conv[0])
        self._iter = int(iters[0])
        # device-resident per-chunk results; concatenated lazily on access
        self._llr_chunks = llr_chunks
        self._bpd_chunks = bpd_chunks
        self._llr_batch_cache = None
        self.log_prob_ratios_batch = _LazyChunks(llr_chunks, B0)
        self._bp_decoding_dev = _LazyChunks(bpd_chunks, B0)
        self._bp_decoding = None
        self._log_prob_ratios = llr_chunks[0][0]
        self._nonzero_mask = nonzero
        if self._osd_method in (osd_ops.OSD_0, osd_ops.OSD_OFF):
            # OSD-0 == OSD-w at order 0; unpacked lazily when packed out
            self._osd0_batch = out
            self._osd0_packed_dev = out_packed if out is None else None
        else:
            # separate device-resident OSD-0 decodings; pulled lazily
            self._osd0_batch = None
            self._osd0_packed_dev = _LazyChunks(d0_chunks, B0)
        row0 = (
            out[0]
            if out is not None
            else osd_ops.gf2.unpack_bits_u8(out_packed[:1], self.n)[0]
        )
        self._osdw_decoding = row0
        self._decoding = row0
        # None -> the property unpacks from the packed copy on first access
        self.osdw_decoding_batch = out
        return out_packed if bit_packed_output else out

    def decode_batch(
        self,
        syndromes: np.ndarray,
        *,
        bit_packed_syndromes: bool = False,
        bit_packed_output: bool = False,
    ) -> np.ndarray:
        """Decode a (B, m) batch: batched BP, then one OSD program over the
        compacted non-converged subset.

        Device<->host traffic is kept small: the failed-subset gather,
        result merge and bit-packing all run on device; only the
        converged flags and packed decodings cross.
        ``bit_packed_syndromes`` accepts little-endian bit-packed input
        (``(B, ceil(m/8))`` uint8, stim b8 layout) and
        ``bit_packed_output`` returns ``(B, ceil(n/8))`` packed decodings
        — together they cut the transfer bytes 8x and skip the host-side
        pack/unpack entirely (the device programs already work on packed
        words)."""
        Wm = -(-self.m // 8)
        if bit_packed_syndromes:
            packed_all = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
            if packed_all.shape[1] != Wm:
                raise ValueError(
                    f"Bit-packed syndromes must have shape (batch, {Wm}). "
                    f"Not {packed_all.shape}."
                )
            if self.m % 8:
                packed_all = packed_all.copy()
                packed_all[:, -1] &= (1 << (self.m % 8)) - 1
            syndromes = None
        else:
            syndromes = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
            if syndromes.shape[1] != self.m:
                raise ValueError(
                    f"The syndromes must have shape (batch, {self.m}). "
                    f"Not {syndromes.shape}."
                )
            packed_all = None
        B = (packed_all if syndromes is None else syndromes).shape[0]
        nonzero = (
            packed_all.any(axis=1)
            if syndromes is None
            else syndromes.any(axis=1)
        )

        from ldpc_tpu.ops import bp as bp_ops

        if self._fused_ok():
            if packed_all is None:
                packed_all = np.packbits(syndromes, axis=1, bitorder="little")
            return self._decode_batch_chunked(
                packed_all, B, nonzero, bit_packed_output
            )

        if syndromes is None:
            syndromes = np.unpackbits(
                packed_all, axis=1, count=self.m, bitorder="little"
            )
        if bit_packed_output:
            out = self.decode_batch(syndromes)
            return np.packbits(out, axis=1, bitorder="little")

        syn_dev = jnp.asarray(syndromes)
        use_cascade = (
            self._schedule == bp_ops.PARALLEL
            and self._max_iter > self._CASCADE_ITERS
            and self._osd_method != osd_ops.OSD_OFF
            and self._dtype == jnp.float32
        )
        if use_cascade:
            return self._decode_batch_cascade(syndromes, syn_dev, nonzero)

        bp = self._run_bp_batch(syn_dev)
        conv = np.asarray(bp.converged) | ~nonzero
        self.iter_batch = np.asarray(bp.iterations)

        failed = np.flatnonzero(~conv)
        run_osd = failed.size and self._osd_method != osd_ops.OSD_OFF
        if run_osd:
            fn = self._osd_decode_fn()
            # bucket the failed-subset size to powers of two so the jitted
            # program re-compiles only O(log B) times
            bucket = 1 << (int(failed.size - 1).bit_length())
            idx = np.zeros(bucket, np.int32)
            idx[: failed.size] = failed
            idx_dev = jnp.asarray(idx)
            rowvalid = jnp.asarray(np.arange(bucket) < failed.size)
            syn_f = jnp.take(syn_dev, idx_dev, axis=0) * rowvalid[
                :, None
            ].astype(jnp.uint8)
            llr_f = jnp.take(bp.llr_posterior, idx_dev, axis=0)
            d0, dw, _ = fn(syn_f, llr_f)
            packed_w, packed_0 = self._merge_pack_fn()(
                bp.decoding, idx_dev, d0, dw, rowvalid
            )
            osdw = osd_ops.gf2.unpack_bits_u8(np.asarray(packed_w), self.n)
            osd0 = osd_ops.gf2.unpack_bits_u8(np.asarray(packed_0), self.n)
        else:
            packed = np.asarray(self._pack_fn()(bp.decoding))
            osdw = osd_ops.gf2.unpack_bits_u8(packed, self.n)
            osd0 = osdw.copy()
        osdw[~nonzero] = 0
        osd0[~nonzero] = 0
        out = osdw

        self.converge_batch = conv
        self.log_prob_ratios_batch = bp.llr_posterior  # device; np-convertible
        self._bp_decoding_dev = bp.decoding  # device; pulled on demand
        self._converge = bool(conv[0])
        self._iter = int(self.iter_batch[0])
        self._log_prob_ratios = bp.llr_posterior[0]
        self._bp_decoding = None
        self._nonzero_mask = nonzero
        self._osd0_batch = osd0
        self._osd0_packed_dev = None
        self._osdw_decoding = osdw[0]
        self._decoding = out[0]
        self.osdw_decoding_batch = osdw
        return out

    def _decode_batch_cascade(
        self, syndromes: np.ndarray, syn_dev, nonzero
    ) -> np.ndarray:
        """The host cascade: cheap full-batch BP, then full-depth BP and
        OSD on the host-compacted non-converged bucket, fused device
        epilogue.

        Per-element results are identical to the plain path: each
        element's BP trajectory is deterministic, so re-running the
        stragglers from scratch at full depth reproduces what a single
        full-depth batched run would produce for them, and OSD results
        for elements that converge later are discarded on device.
        """
        B = syndromes.shape[0]
        bp1 = self._cascade_fns()(syn_dev, jnp.asarray(self._init_llr()))
        conv1 = np.asarray(bp1.converged) | ~nonzero
        failed = np.flatnonzero(~conv1)
        if failed.size == 0:
            packed = np.asarray(self._pack_fn()(bp1.decoding))
            out = osd_ops.gf2.unpack_bits_u8(packed, self.n)
            out[~nonzero] = 0
            conv = conv1
            iters = np.asarray(bp1.iterations)
            osd0 = out.copy()
            osdw = out
            self._osd0_packed_dev = None
            llrs = bp1.llr_posterior
        else:
            bucket = 1 << (int(failed.size - 1).bit_length())
            idx = np.zeros(bucket, np.int32)
            idx[: failed.size] = failed
            idx_dev = jnp.asarray(idx)
            rowvalid = jnp.asarray(np.arange(bucket) < failed.size)
            syn_f = jnp.take(syn_dev, idx_dev, axis=0) * rowvalid[
                :, None
            ].astype(jnp.uint8)
            bp2 = self._run_bp_batch(syn_f)

            def _osd_pair(s, l):
                # [osd0 | osdw] side by side so the second compaction
                # (base.py:_compacted_post) scatters both in one pass
                a, b, _ = self._osd_decode_fn()(s, l)
                return jnp.concatenate([a, b], axis=1)

            both = self._compacted_post(
                _osd_pair, syn_f, bp2.converged, bp2.llr_posterior
            )
            d0, dw = both[:, : self.n], both[:, self.n :]
            combined, packed_0 = self._epilogue_fn()(
                bp1.decoding, bp1.converged, bp1.iterations,
                idx_dev, rowvalid,
                bp2.decoding, bp2.converged, bp2.iterations, d0, dw,
            )
            combined = np.asarray(combined)  # the ONE device->host pull
            Wb = -(-self.n // 8)
            conv = combined[:, Wb].astype(bool) | ~nonzero
            iters = (
                np.ascontiguousarray(combined[:, Wb + 1 : Wb + 5])
                .view(np.int32)
                .ravel()
            )
            osdw = osd_ops.gf2.unpack_bits_u8(combined[:, :Wb], self.n)
            osdw[~nonzero] = 0
            self._osd0_packed_dev = packed_0  # pulled lazily
            osd0 = None
            llrs = bp1.llr_posterior
        out = osdw

        self.converge_batch = conv
        self.iter_batch = iters
        self._converge = bool(conv[0])
        self._iter = int(iters[0])
        # full-batch llrs/bp-decodings are phase-1's (converged rows are
        # final there; failed rows' full-depth values live in the bucket)
        self.log_prob_ratios_batch = bp1.llr_posterior
        self._bp_decoding_dev = bp1.decoding
        self._bp_decoding = None
        if failed.size and failed[0] == 0 and not conv1[0]:
            # row 0 was a straggler: its final BP state is bucket slot 0
            self._log_prob_ratios = bp2.llr_posterior[0]
            self._bp_decoding = bp2.decoding[0]
        else:
            self._log_prob_ratios = bp1.llr_posterior[0]
        self._nonzero_mask = nonzero
        self._osd0_batch = osd0  # None when only the packed device copy exists
        self._osdw_decoding = osdw[0]
        self._decoding = out[0]
        self.osdw_decoding_batch = osdw
        return out

    @property
    def bp_decoding_batch(self) -> np.ndarray:
        return np.asarray(self._bp_decoding_dev)

    # ------------------------------------------------------------------
    # result properties (reference: _bposd_decoder.pyx:236-300)
    # ------------------------------------------------------------------
    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(int)

    @property
    def bp_decoding(self) -> np.ndarray:
        if self._bp_decoding is None:  # pulled from device on demand
            self._bp_decoding = np.asarray(self._bp_decoding_dev[0])
        return np.asarray(self._bp_decoding).astype(int)

    @property
    def osd0_decoding_batch(self) -> np.ndarray:
        """OSD-0 decodings for the whole batch (pulled from the device
        packed copy / unpacked from the packed host copy on first access)."""
        if self._osd0_batch is None:
            arr = osd_ops.gf2.unpack_bits_u8(
                np.asarray(self._osd0_packed_dev), self.n
            )
            arr[~self._nonzero_mask] = 0
            self._osd0_batch = arr
        return self._osd0_batch

    @property
    def osdw_decoding_batch(self) -> np.ndarray:
        """OSD-w decodings for the whole batch (lazily unpacked when the
        decode returned bit-packed output)."""
        if self._osdw_batch is None:
            self._osdw_batch = self.osd0_decoding_batch
        return self._osdw_batch

    @osdw_decoding_batch.setter
    def osdw_decoding_batch(self, value) -> None:
        self._osdw_batch = value

    @property
    def osd0_decoding(self) -> np.ndarray:
        if self._converge:
            return self.bp_decoding
        return np.asarray(self.osd0_decoding_batch[0]).astype(int)

    @property
    def osdw_decoding(self) -> np.ndarray:
        if self._converge:
            return np.asarray(self._bp_decoding).astype(int)
        return np.asarray(self._osdw_decoding).astype(int)


class SoftInfoBpOsdDecoder(SoftInfoBpDecoder):
    """Soft-syndrome BP with an OSD fallback.

    The reference declares this class (bposd_decoder/__init__.py:1,
    _bposd_decoder.pxd:31) but its implementation is commented out
    (_bposd_decoder.pyx:302-582); this is a live implementation of that
    commented spec: serial min-sum soft-info BP (arXiv:2205.02341), and
    on non-convergence the final soft syndrome is hardened
    (value <= 0 -> 1, _bposd_decoder.pyx:425-429) and OSD runs on it
    guided by the BP posterior LLRs.
    """

    def __init__(
        self,
        pcm: Union[np.ndarray, scipy.sparse.spmatrix],
        error_rate: Optional[float] = None,
        error_channel: Optional[List[float]] = None,
        max_iter: Optional[int] = 0,
        ms_scaling_factor: Optional[float] = 1.0,
        osd_method: Union[str, int, float] = 0,
        osd_order: int = 0,
        cutoff: Optional[float] = np.inf,
        sigma: float = 2.0,
        **kwargs,
    ):
        super().__init__(
            pcm,
            error_rate=error_rate,
            error_channel=error_channel,
            max_iter=max_iter,
            ms_scaling_factor=ms_scaling_factor,
            cutoff=cutoff,
            sigma=sigma,
            **kwargs,
        )
        self._osd_method = 0
        self._osd_order = 0
        self.osd_method = osd_method
        self.osd_order = osd_order

    osd_method = BpOsdDecoder.osd_method
    osd_order = BpOsdDecoder.osd_order
    _invalidate_osd = BpOsdDecoder._invalidate_osd
    _osd_decode_fn = BpOsdDecoder._osd_decode_fn

    def decode_batch(self, soft_syndromes: np.ndarray) -> np.ndarray:
        bp_out = super().decode_batch(soft_syndromes)
        conv = self.converge_batch
        if conv.all() or self._osd_method == osd_ops.OSD_OFF:
            return bp_out
        # harden the post-BP soft syndrome: <= 0 means violated
        soft_all = np.atleast_2d(np.asarray(self.soft_syndrome_batch))
        failed = np.flatnonzero(~conv)
        # pad the failed bucket to powers of two so the jitted OSD
        # program compiles O(log B) times, not once per failure count
        bucket = 1 << int(failed.size - 1).bit_length()
        pad = bucket - failed.size
        hard = np.zeros((bucket, self.m), np.uint8)
        hard[: failed.size] = soft_all[failed] <= 0
        llrs = np.asarray(self.log_prob_ratios_batch)
        llr_f = np.zeros((bucket, self.n), llrs.dtype)
        llr_f[: failed.size] = llrs[failed]
        d0, dw, _ = self._osd_decode_fn()(
            jnp.asarray(hard), jnp.asarray(llr_f)
        )
        out = bp_out.copy()
        out[failed] = np.asarray(dw, np.uint8)[: failed.size]
        self._decoding = out[0]
        return out
