"""BpDecoderBase: configuration, validation and property surface.

API parity with the reference Cython base class
(reference: src_python/ldpc/bp_decoder/_bp_decoder.pyx:86-580): same
constructor kwargs, property names, string aliases, validation errors and
the ldpc-v1 ``channel_probs`` compatibility hook.

Additions beyond the reference:
- ``decode_batch(syndromes)``: decode a whole (B, m) batch in one jitted
  device call — the performance path.
- decoder programs are cached per configuration; changing a property
  invalidates the cache and triggers a re-jit on next decode.
"""

import time
import warnings
from typing import List, Optional, Union

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp

from ldpc_tpu.helpers import convert_to_binary_sparse
from ldpc_tpu.ops import bp as bp_ops
from ldpc_tpu.ops.pcm import PcmGraph, compile_pcm

_SYNDROME = 0
_RECEIVED_VECTOR = 1
_AUTO = 2


# segment length for the sparse (index-coded) decoding export; 256 keeps
# local indices in uint8 and per-segment occupancy in the Poisson regime
_SEG_L = 256


def _sparse_export_plan(Bpad: int, n: int, Wb: int, wbar: float):
    """Segment plan ``(S, K)`` for the sparse decoding export, or None.

    Decodings at QEC-relevant error rates are ~1% dense, so shipping
    per-segment nonzero positions instead of the bit-packed rows cuts the
    dominant D2H bytes ~2x. The flattened (Bpad*n) decoding chunk is
    split into S segments of ``_SEG_L`` bits; each exports its first K
    set-bit positions (uint8) plus a count byte. K covers the Poisson(lam) occupancy tail to
    ~1e-9 per segment (lam = expected set bits per segment from the
    channel weight ``wbar``); heavier segments — e.g. a pathological
    non-converged row — make the host redispatch the chunk with the
    dense layout, so outputs are exact in every case. The compaction is
    a batched per-segment sort rather than a 2.5M-element flat-index
    scatter. Returns None when segments wouldn't save at least 25% over
    the dense layout.
    """
    lam = _SEG_L * wbar / max(n, 1)
    K = int(np.ceil(lam + 5.0 * np.sqrt(lam) + 5.0))
    S = -(-(Bpad * n) // _SEG_L)
    if S * (K + 1) > (3 * Bpad * Wb) // 4:
        return None
    return (S, K)


def _scoped(name: str, fn):
    """``fn`` traced under ``jax.named_scope(name)``, so the device
    kernels it emits carry the stage name in a profiler trace."""

    def run(*args):
        with jax.named_scope(name):
            return fn(*args)

    run.__name__ = run.__qualname__ = name  # jit module name in traces
    return run


def _iters_dtype(max_iter: int):
    """Narrowest dtype that holds iteration counts <= max_iter."""
    if max_iter <= 255:
        return jnp.uint8, np.uint8, 1
    if max_iter <= 65535:
        return jnp.uint16, np.uint16, 2
    return jnp.int32, np.int32, 4


def _plan_unless_disabled(dec, Bpad: int, Wb: int, wbar: float):
    """The sparse export plan, or None once this decoder has seen a
    segment overflow: codes with heavy postprocess corrections (e.g.
    weight-30+ OSD outputs on HGP) overflow on nearly every chunk, and
    each overflow costs a full dense redispatch — remembering beats
    re-discovering per chunk (measured 3x on the [[400,16,6]] HGP)."""
    if getattr(dec, "_seg_plan_off", False):
        return None
    return _sparse_export_plan(Bpad, dec.n, Wb, wbar)


def _reconstruct_segments(buf_np, plan, Bpad: int, n: int):
    """Rebuild the (Bpad, n) uint8 decodings from a segmented sparse
    export buffer (layout: S*K local uint8 indices, then S count bytes)."""
    S, K = plan
    sk = buf_np[: S * K].reshape(S, K)
    cnts = buf_np[S * K : S * (K + 1)]
    valid = np.arange(K, dtype=np.uint8)[None, :] < cnts[:, None]
    glob = (
        np.arange(S, dtype=np.int64)[:, None] * _SEG_L + sk
    )[valid]
    flat = np.zeros(S * _SEG_L, np.uint8)
    flat[glob] = 1
    return flat[: Bpad * n].reshape(Bpad, n)


class BpDecoderBase:
    """Belief-propagation decoder base: owns the PCM, channel and BP config."""

    def __init__(self, pcm, **kwargs):
        error_rate = kwargs.pop("error_rate", None)
        error_channel = kwargs.pop("error_channel", None)
        max_iter = kwargs.pop("max_iter", 0)
        bp_method = kwargs.pop("bp_method", 0)
        ms_scaling_factor = kwargs.pop("ms_scaling_factor", 1.0)
        schedule = kwargs.pop("schedule", 0)
        omp_thread_count = kwargs.pop("omp_thread_count", 1)
        random_serial_schedule = kwargs.pop("random_serial_schedule", False)
        random_schedule_seed = kwargs.pop("random_schedule_seed", 0)
        serial_schedule_order = kwargs.pop("serial_schedule_order", None)
        channel_probs = kwargs.pop("channel_probs", [None])
        self._dtype = kwargs.pop("dtype", jnp.float32)
        self._extra_kwargs = kwargs

        if not isinstance(pcm, (np.ndarray, scipy.sparse.spmatrix)):
            raise TypeError(
                "The input matrix is of an invalid type. Please input "
                f"a np.ndarray or scipy.sparse.spmatrix object, not {type(pcm)}"
            )
        self._pcm = convert_to_binary_sparse(pcm)
        self.m, self.n = self._pcm.shape
        self._graph: Optional[PcmGraph] = None

        self._channel = np.zeros(self.n, dtype=np.float64)
        self._converge = False
        self._iter = 0
        self._log_prob_ratios = np.zeros(self.n)
        self._decoding = np.zeros(self.n, dtype=np.uint8)
        self._input_vector_type = _AUTO

        self._bp_method = 0
        self._schedule = 0
        self._max_iter = 0
        self._ms_scaling_factor = 1.0
        self._serial_schedule_order = None
        self._random_serial_schedule = False
        self._random_schedule_seed = 0
        self._omp_thread_count = 1
        self._decoder_cache = {}

        self.bp_method = bp_method
        self.max_iter = max_iter
        self.ms_scaling_factor = ms_scaling_factor
        self.schedule = schedule
        self.serial_schedule_order = serial_schedule_order
        if random_schedule_seed != 0 or random_serial_schedule:
            self.random_schedule_seed = random_schedule_seed
        self.omp_thread_count = omp_thread_count
        self.random_serial_schedule = random_serial_schedule

        # ldpc v1 backwards compatibility
        if isinstance(channel_probs, (list, np.ndarray)):
            if len(channel_probs) > 0 and channel_probs[0] is not None:
                error_channel = channel_probs

        if error_channel is not None:
            self.error_channel = error_channel
        elif error_rate is not None:
            self.error_rate = error_rate
        else:
            raise ValueError(
                "Please specify the error channel. Either: 1) error_rate: float "
                "or 2) error_channel: list of floats of length equal to the "
                f"block length of the code {self.n}."
            )

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    @property
    def pcm(self) -> scipy.sparse.csr_matrix:
        return self._pcm

    @property
    def graph(self) -> PcmGraph:
        if self._graph is None:
            self._graph = compile_pcm(self._pcm)
        return self._graph

    def _invalidate(self):
        self._decoder_cache.clear()

    def _config_key(self):
        return (
            self._bp_method,
            self._schedule,
            self._max_iter,
            float(self._ms_scaling_factor),
            self._random_serial_schedule,
        )

    def _make_parallel_bp(self, iters: int):
        """A batched parallel-schedule BP program at ``iters`` depth."""
        return bp_ops.make_parallel_decoder(
            self.graph,
            self._bp_method,
            iters,
            self._ms_scaling_factor,
            dtype=self._dtype,
        )

    def _bp_decode_fn(self):
        """The jitted batched BP program for the current configuration."""
        key = self._config_key()
        fn = self._decoder_cache.get(key)
        if fn is None:
            if self._schedule == bp_ops.PARALLEL:
                fn = jax.jit(
                    _scoped("bp", self._make_parallel_bp(self._max_iter))
                )
            else:
                mode = (
                    bp_ops.SERIAL_RELATIVE
                    if self._schedule == bp_ops.SERIAL_RELATIVE
                    else bp_ops.SERIAL
                )
                fn = bp_ops.make_serial_decoder(
                    self.graph,
                    self._bp_method,
                    self._max_iter,
                    self._ms_scaling_factor,
                    schedule_mode=mode,
                    random_serial_schedule=self._random_serial_schedule,
                    dtype=self._dtype,
                )
            self._decoder_cache[key] = fn
        return fn

    def _schedule_array(self) -> np.ndarray:
        if self._serial_schedule_order is not None:
            return np.asarray(self._serial_schedule_order, dtype=np.int32)
        return np.arange(self.n, dtype=np.int32)

    def _prng_key(self):
        seed = self._random_schedule_seed
        if seed == 0:
            seed = time.time_ns() & 0x7FFFFFFF
        return jax.random.key(seed)

    def _init_llr(self) -> np.ndarray:
        dtype = np.float64 if self._dtype == jnp.float64 else np.float32
        return bp_ops.channel_llr(self._channel, dtype=dtype)

    def _run_bp_batch(self, syndromes: np.ndarray) -> bp_ops.BpResult:
        """Run batched BP on (B, m) syndromes; returns device results."""
        fn = self._bp_decode_fn()
        init_llr = jnp.asarray(self._init_llr())
        syndromes = jnp.asarray(syndromes, dtype=jnp.uint8)
        if self._schedule == bp_ops.PARALLEL:
            return fn(syndromes, init_llr)
        return fn(syndromes, init_llr, jnp.asarray(self._schedule_array()), self._prng_key())

    # ------------------------------------------------------------------
    # shared two-phase (cascade) postprocessing machinery: cheap
    # full-batch BP -> device-compacted full-depth BP + postprocess on
    # the non-converged bucket -> ONE combined device->host pull. Used
    # by BpOsd/BpLsd/BeliefFind batch paths; per-element results are
    # identical to a single full-depth run because per-lane BP
    # trajectories are deterministic.
    # ------------------------------------------------------------------
    _CASCADE_ITERS = 6

    def _cascade_fns(self):
        """Phase-1 (cheap, full-batch) BP program for the cascade."""
        key = ("bp_cascade", self._config_key())
        fn = self._decoder_cache.get(key)
        if fn is None:
            fn = jax.jit(
                _scoped(
                    "phase1_bp",
                    self._make_parallel_bp(
                        min(self._CASCADE_ITERS, self._max_iter)
                    ),
                )
            )
            self._decoder_cache[key] = fn
        return fn

    def _pack_fn(self):
        fn = self._decoder_cache.get("pack")
        if fn is None:
            from ldpc_tpu.ops import gf2

            fn = jax.jit(lambda out: gf2.pack_bits_u8(out))
            self._decoder_cache["pack"] = fn
        return fn

    def _post_epilogue_fn(self):
        """Jitted device epilogue for the generic cascade: pick BP-vs-
        postprocessor output per bucket element, scatter the bucket back
        into the full batch, and bit-pack decodings + converged flags +
        iteration counts into ONE uint8 buffer, so everything the host
        needs travels in one device->host copy."""
        fn = self._decoder_cache.get("post_epilogue")
        if fn is None:
            from ldpc_tpu.ops import gf2

            def epilogue(dec1, conv1, iters1, idx, rowvalid,
                         dec2, conv2, iters2, post_dec):
                B = dec1.shape[0]
                out_f = jnp.where(conv2[:, None], dec2, post_dec)
                idxs = jnp.where(rowvalid, idx, B)  # sentinel row
                sent = jnp.zeros((1, dec1.shape[1]), dec1.dtype)
                out = jnp.concatenate([dec1, sent]).at[idxs].set(out_f)[:B]
                conv = jnp.concatenate([conv1, jnp.zeros(1, bool)])
                conv = conv.at[idxs].set(conv2)[:B]
                iters = jnp.concatenate([iters1, jnp.zeros(1, jnp.int32)])
                iters = iters.at[idxs].set(iters2)[:B]
                combined = jnp.concatenate(
                    [
                        gf2.pack_bits_u8(out),
                        conv.astype(jnp.uint8)[:, None],
                        jax.lax.bitcast_convert_type(iters, jnp.uint8),
                    ],
                    axis=1,
                )  # (B, Wb + 1 + 4)
                return combined

            fn = jax.jit(epilogue)
            self._decoder_cache["post_epilogue"] = fn
        return fn

    def _compacted_post(self, post_fn, syn_f, sub_conv, sub_llr):
        """Run ``post_fn`` only on bucket elements that failed FULL-depth
        BP. The phase-1 bucket is sized by 6-iteration failures — often
        ~10x the number of final failures — and the epilogue discards
        postprocessor output for every element that converges by
        ``max_iter``, so running the (expensive) candidate sweeps on the
        whole bucket wastes most of their work. Costs one extra small
        D2H pull of the bucket's converged flags; skipped for tiny
        buckets where the pull latency would dominate."""
        bucket = syn_f.shape[0]
        if bucket <= 256:
            return post_fn(syn_f, sub_llr)
        conv2 = np.asarray(sub_conv)
        failed2 = np.flatnonzero(~conv2)
        if failed2.size == 0 or failed2.size > bucket // 2:
            return post_fn(syn_f, sub_llr)
        b2 = 1 << int(failed2.size - 1).bit_length()
        idx2 = np.zeros(b2, np.int32)
        idx2[: failed2.size] = failed2
        idx2_dev = jnp.asarray(idx2)
        rv2 = jnp.asarray(np.arange(b2) < failed2.size)
        syn_ff = jnp.take(syn_f, idx2_dev, axis=0) * rv2[:, None].astype(
            jnp.uint8
        )
        llr_ff = jnp.take(sub_llr, idx2_dev, axis=0)
        pd = post_fn(syn_ff, llr_ff)
        # scatter back to bucket coords through a sentinel row
        scat = jnp.where(rv2, idx2_dev, bucket)
        base = jnp.zeros((bucket + 1, pd.shape[1]), pd.dtype)
        return base.at[scat].set(pd)[:bucket]

    def _postprocess_cascade_batch(self, syndromes, nonzero, post_fn):
        """Run the generic cascade; ``post_fn(syn_f, llr_f) -> dec_f`` is
        the jittable device postprocessor applied to the compacted
        non-converged bucket with the full-depth BP posterior LLRs.

        Returns a dict: ``out_packed`` (B, ceil(n/8)) np.uint8,
        ``conv``/``iters`` np arrays, ``llr_batch``/``bp_dec`` device
        arrays (phase-1 values — final for converged rows), ``llr_row0``/
        ``bp_dec_row0`` device rows with full-depth values for row 0,
        and ``failed`` (np indices)."""
        from ldpc_tpu.ops import gf2

        B = syndromes.shape[0]
        Wb = -(-self.n // 8)
        syn_dev = jnp.asarray(syndromes)
        init_llr = jnp.asarray(self._init_llr())
        use_cascade = (
            self._schedule == bp_ops.PARALLEL
            and self._max_iter > self._CASCADE_ITERS
        )
        bp1 = (
            self._cascade_fns()(syn_dev, init_llr)
            if use_cascade
            else self._run_bp_batch(syndromes)
        )
        conv1 = np.asarray(bp1.converged) | ~nonzero
        failed = np.flatnonzero(~conv1)
        if failed.size == 0:
            out_packed = np.array(self._pack_fn()(bp1.decoding))
            out_packed[~nonzero] = 0
            return {
                "out_packed": out_packed,
                "conv": conv1,
                "iters": np.asarray(bp1.iterations),
                "llr_batch": bp1.llr_posterior,
                "bp_dec": bp1.decoding,
                "llr_row0": bp1.llr_posterior[0],
                "bp_dec_row0": bp1.decoding[0],
                "failed": failed,
            }
        bucket = 1 << int(failed.size - 1).bit_length()
        idx = np.zeros(bucket, np.int32)
        idx[: failed.size] = failed
        idx_dev = jnp.asarray(idx)
        rowvalid = jnp.asarray(np.arange(bucket) < failed.size)
        syn_f = jnp.take(syn_dev, idx_dev, axis=0) * rowvalid[
            :, None
        ].astype(jnp.uint8)
        if use_cascade:
            bp2 = self._run_bp_batch(syn_f)
            sub_dec, sub_conv = bp2.decoding, bp2.converged
            sub_llr, sub_iters = bp2.llr_posterior, bp2.iterations
            # expose FULL-depth LLRs/decodings for bucket rows (the
            # reference's post-max_iter values), not phase-1 state —
            # device-side scatter, no extra pull (arrays stay lazy)
            sent = jnp.where(rowvalid, idx_dev, B)
            llr_batch = jnp.concatenate(
                [bp1.llr_posterior, jnp.zeros_like(bp1.llr_posterior[:1])]
            ).at[sent].set(sub_llr)[:B]
            bp_dec_batch = jnp.concatenate(
                [bp1.decoding, jnp.zeros_like(bp1.decoding[:1])]
            ).at[sent].set(sub_dec)[:B]
        else:
            sub_dec = jnp.take(bp1.decoding, idx_dev, axis=0)
            sub_conv = jnp.take(bp1.converged, idx_dev)
            sub_llr = jnp.take(bp1.llr_posterior, idx_dev, axis=0)
            sub_iters = jnp.take(bp1.iterations, idx_dev)
            llr_batch = bp1.llr_posterior
            bp_dec_batch = bp1.decoding
        post_dec = self._compacted_post(post_fn, syn_f, sub_conv, sub_llr)
        combined = np.asarray(
            self._post_epilogue_fn()(
                bp1.decoding, bp1.converged, bp1.iterations,
                idx_dev, rowvalid,
                sub_dec, sub_conv, sub_iters, post_dec,
            )
        )  # the ONE device->host pull
        conv = combined[:, Wb].astype(bool) | ~nonzero
        iters = (
            np.ascontiguousarray(combined[:, Wb + 1 : Wb + 5])
            .view(np.int32)
            .ravel()
        )
        out_packed = np.array(combined[:, :Wb])  # writable copy
        out_packed[~nonzero] = 0
        row0_failed = not conv1[0]
        return {
            "out_packed": out_packed,
            "conv": conv,
            "iters": iters,
            "llr_batch": llr_batch,
            "bp_dec": bp_dec_batch,
            "llr_row0": sub_llr[0] if row0_failed else bp1.llr_posterior[0],
            "bp_dec_row0": sub_dec[0] if row0_failed else bp1.decoding[0],
            "failed": failed,
        }

    # ------------------------------------------------------------------
    # generic fused single-dispatch cascade: the whole phase-1 BP ->
    # device top-K compaction -> full-depth BP -> postprocess -> merge
    # pipeline is ONE jitted program per chunk, and the host pulls ONE
    # uint8 buffer per chunk, where `_postprocess_cascade_batch` syncs
    # with the host to build its buckets. BpOsdDecoder's
    # `_osd_fused_fn` is the same program with the OSD-0 output tracked
    # beside OSD-w; this one serves any `post(syn_f, llr_f) -> dec_f`.
    # ------------------------------------------------------------------
    _FUSED_CHUNK = 8192
    # Off on every backend: on the H100 the host cascade decodes the d=13
    # flagship batch faster than this loop at every chunk size tried
    # (PERF.md, PR 1), and the CPU's exact-parity tests pin the cascade.
    # Tests and chip_smoke.py turn it on per instance, until one
    # ``decode_batch`` path replaces both.
    _USE_FUSED = False

    def _fused_ok(self) -> bool:
        """Whether ``decode_batch`` takes the fused chunk loop."""
        return self._USE_FUSED and self._schedule == bp_ops.PARALLEL

    def _fused_cascade_fn(
        self, Bpad: int, K: int, post_key, post_builder, sparse_plan=None,
        K2: int = 0,
    ):
        key = (
            "fused_cascade", post_key, self._channel.tobytes(),
            self._config_key(), Bpad, K, sparse_plan, K2,
        )
        fn = self._decoder_cache.get(key)
        if fn is not None:
            return fn
        from ldpc_tpu.ops.gf2 import pack_bits_u8, unpack_bits_u8_device

        m = self.m
        p1 = min(self._CASCADE_ITERS, self._max_iter)
        two_phase = K > 0 and p1 < self._max_iter
        bp_fn = _scoped(
            "phase1_bp",
            self._make_parallel_bp(p1 if two_phase else self._max_iter),
        )
        bp2_fn = (
            _scoped("bucket_bp", self._make_parallel_bp(self._max_iter))
            if two_phase
            else None
        )
        post_fn = (
            _scoped("post", post_builder())
            if (K > 0 and post_builder is not None)
            else None
        )
        init_llr = jnp.asarray(self._init_llr())

        def program(packed_syn):
            syn = unpack_bits_u8_device(packed_syn, m)  # (Bpad, m) uint8
            bp = bp_fn(syn, init_llr)
            nonzero = syn.any(axis=1)
            conv_eff = bp.converged | ~nonzero
            dec, llrs, iters = bp.decoding, bp.llr_posterior, bp.iterations
            nfail = (~conv_eff).sum().astype(jnp.int32)
            if K > 0:
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
                if post_fn is not None:
                    nfail2 = (~sub_conv).sum().astype(jnp.int32)
                    if 0 < K2 < K:
                        # second-level compaction: the postprocessor only
                        # matters on rows full-depth BP failed (~1% here)
                        # — run it on the top-K2 non-converged rows and
                        # let the host redispatch on nfail2 overflow
                        order2 = jnp.argsort(sub_conv, stable=True)
                        idx2 = order2[:K2]
                        pd2 = post_fn(
                            jnp.take(syn_f, idx2, axis=0),
                            jnp.take(sub_llr, idx2, axis=0),
                        )
                        post_dec = (
                            jnp.zeros_like(sub_dec)
                            .at[idx2]
                            .set(pd2.astype(sub_dec.dtype))
                        )
                    else:
                        post_dec = post_fn(syn_f, sub_llr).astype(
                            sub_dec.dtype
                        )
                    merged = jnp.where(sub_conv[:, None], sub_dec, post_dec)
                else:  # plain BP: failed rows keep their BP decoding
                    nfail2 = jnp.int32(0)
                    merged = sub_dec
                out = dec.at[idx].set(merged)
            else:
                nfail2 = jnp.int32(0)
                out = dec
            out = out * nonzero[:, None].astype(out.dtype)
            it_jdt = _iters_dtype(self._max_iter)[0]
            it_bytes = jax.lax.bitcast_convert_type(
                iters.astype(it_jdt), jnp.uint8
            ).reshape(-1)
            if sparse_plan is not None:
                # segmented index-coded export (see _sparse_export_plan):
                # per-segment sorted set-bit positions + count byte; the
                # host redispatches dense if any count exceeds K
                S, Ks = sparse_plan
                flat = out.reshape(-1)
                xp = jnp.pad(
                    flat, (0, S * _SEG_L - flat.shape[0])
                ).reshape(S, _SEG_L)
                mask = xp != 0
                keys = jnp.where(
                    mask,
                    jnp.arange(_SEG_L, dtype=jnp.int32)[None, :],
                    _SEG_L,
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
            buf = jnp.concatenate(
                [
                    head,
                    pack_bits_u8(conv_eff[None, :].astype(jnp.uint8))[0],
                    jax.lax.bitcast_convert_type(nfail, jnp.uint8),
                    jax.lax.bitcast_convert_type(nfail2, jnp.uint8),
                    it_bytes,
                ]
            )  # (head + Bpad/8 + 8 + it_size*Bpad,) uint8
            return buf, llrs, dec

        fn = jax.jit(program)
        self._decoder_cache[key] = fn
        return fn

    def _decode_batch_fused(
        self,
        syndromes: np.ndarray,
        nonzero: np.ndarray,
        post_key,
        post_builder,
        bit_packed_output: bool = False,
    ):
        """Chunked single-pull decode over the fused cascade. Returns the
        decodings ((B, n) or bit-packed) and stores the standard batch
        attributes (converge_batch, iter_batch, lazy LLRs/BP decodings)."""
        from ldpc_tpu.decoders.lazy import LazyChunks
        from ldpc_tpu.ops import gf2

        B0 = syndromes.shape[0]
        Wb = -(-self.n // 8)
        packed_all = np.packbits(syndromes, axis=1, bitorder="little")
        CH = self._FUSED_CHUNK
        wbar = float(np.sum(self._channel))
        it_ndt, it_size = _iters_dtype(self._max_iter)[1:]
        starts = list(range(0, B0, CH)) or [0]
        launches = []
        for st in starts:
            chunk = packed_all[st : st + CH]
            Bc = chunk.shape[0]
            Bpad = (
                -(-Bc // 512) * 512 if Bc >= 512 else max(128, -(-Bc // 128) * 128)
            )
            # bucket sized from the worst failure fraction seen so far
            # (surface ~9%; HGP-family codes fail BP far more often —
            # without the hint every chunk overflows and redispatches)
            frac = getattr(self, "_nfail_frac_hint", 0.0)
            K = min(
                Bpad,
                max(
                    128,
                    -(-(Bpad // 8) // 128) * 128,
                    -(-(int(frac * Bpad * 1.3) + 1) // 128) * 128,
                ),
            )
            # second-level post bucket from the observed FULL-DEPTH
            # failure fraction (see bposd_decoder._decode_batch_chunked):
            # ~9% on surface codes (K2 -> K, compaction naturally off),
            # ~0.6% on HGP — there the postprocessor runs on 8x fewer
            # rows and stops dominating
            frac2 = getattr(self, "_nfail2_frac_hint", 1.0 / 64.0)
            K2 = (
                min(
                    K,
                    max(
                        128,
                        -(-(int(frac2 * Bpad * 1.5) + 1) // 128) * 128,
                    ),
                )
                if post_builder is not None
                else 0
            )
            plan = _plan_unless_disabled(self, Bpad, Wb, wbar)
            if Bpad != Bc:
                chunk = np.concatenate(
                    [chunk, np.zeros((Bpad - Bc, chunk.shape[1]), np.uint8)]
                )
            dev = jnp.asarray(chunk)
            buf, llrs, bpd = self._fused_cascade_fn(
                Bpad, K, post_key, post_builder, plan, K2
            )(dev)
            buf.copy_to_host_async()
            launches.append(
                (st, Bc, Bpad, K, K2, plan, dev, buf, llrs, bpd)
            )

        out_packed = np.empty((B0, Wb), np.uint8)
        out = None if bit_packed_output else np.empty((B0, self.n), np.uint8)
        conv = np.empty(B0, bool)
        iters = np.empty(B0, np.int32)
        llr_chunks, bpd_chunks = [], []
        for st, Bc, Bpad, K, K2, plan, dev, buf, llrs, bpd in launches:
            # bucket/post-bucket/segment overflows redispatch the chunk;
            # a widened bucket can reveal a wider post bucket, so loop
            # (each round only ever widens something — terminates)
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
                buf, llrs, bpd = self._fused_cascade_fn(
                    Bpad, K, post_key, post_builder, plan, K2
                )(dev)
            if plan:
                outc = _reconstruct_segments(buf_np, plan, Bpad, self.n)[:Bc]
                out_packed[st : st + Bc] = np.packbits(
                    outc, axis=1, bitorder="little"
                )
                if out is not None:
                    out[st : st + Bc] = outc
            else:
                pd_np = buf_np[:o1].reshape(Bpad, Wb)
                out_packed[st : st + Bc] = pd_np[:Bc]
                if out is not None:
                    out[st : st + Bc] = gf2.unpack_bits_u8(pd_np[:Bc], self.n)
            conv[st : st + Bc] = np.unpackbits(
                buf_np[o1:o2], count=Bc, bitorder="little"
            ).astype(bool)
            iters[st : st + Bc] = (
                np.ascontiguousarray(buf_np[o3:]).view(it_ndt)[:Bc]
            )
            llr_chunks.append(llrs)
            bpd_chunks.append(bpd)

        conv |= ~nonzero
        out_packed[~nonzero] = 0
        if out is not None:
            out[~nonzero] = 0
        self.converge_batch = conv
        self.iter_batch = iters
        self._converge = bool(conv[0])
        self._iter = int(iters[0])
        self.log_prob_ratios_batch = LazyChunks(llr_chunks, B0)
        self._log_prob_ratios = llr_chunks[0][0]
        return (out_packed if out is None else out), LazyChunks(
            bpd_chunks, B0
        )

    def _coerce_batch_syndromes(
        self, syndromes: np.ndarray, bit_packed: bool
    ) -> np.ndarray:
        """Normalise a syndrome batch to (B, m) uint8, unpacking
        little-endian bit-packed input (stim b8 layout) when asked."""
        if bit_packed:
            Wm = -(-self.m // 8)
            packed = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
            if packed.shape[1] != Wm:
                raise ValueError(
                    f"Bit-packed syndromes must have shape (batch, {Wm}). "
                    f"Not {packed.shape}."
                )
            return np.unpackbits(
                packed, axis=1, count=self.m, bitorder="little"
            )
        return np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))

    def _store_single_result(self, result: bp_ops.BpResult):
        self._converge = bool(np.asarray(result.converged)[0])
        self._iter = int(np.asarray(result.iterations)[0])
        self._log_prob_ratios = np.asarray(result.llr_posterior)[0]
        self._decoding = np.asarray(result.decoding)[0]

    # ------------------------------------------------------------------
    # properties (reference parity)
    # ------------------------------------------------------------------
    @property
    def error_rate(self) -> np.ndarray:
        return self._channel.astype(float).copy()

    @error_rate.setter
    def error_rate(self, value: Optional[float]) -> None:
        if value is not None:
            if not isinstance(value, float):
                raise ValueError(
                    "The `error_rate` parameter must be specified as a single float value."
                )
            self._channel[:] = value

    @property
    def error_channel(self) -> np.ndarray:
        return self._channel.astype(float).copy()

    @error_channel.setter
    def error_channel(self, value) -> None:
        if value is not None:
            if len(value) != self.n:
                raise ValueError(
                    f"The error channel vector must have length {self.n}, not {len(value)}."
                )
            self._channel[:] = np.asarray(value, dtype=np.float64)

    def update_channel_probs(self, value) -> None:
        self.error_channel = value

    @property
    def channel_probs(self) -> np.ndarray:
        return self._channel.astype(float).copy()

    @property
    def input_vector_type(self) -> str:
        if self._input_vector_type == _SYNDROME:
            return "syndrome"
        if self._input_vector_type == _RECEIVED_VECTOR:
            return "received_vector"
        return "auto"

    @input_vector_type.setter
    def input_vector_type(self, input_type: str):
        if input_type.lower() in ("auto", "a", "2"):
            if self.m == self.n:
                raise ValueError(
                    "Please specify the input vector type. Either: 1) "
                    "input_vector_type: 'syndrome' or 2) input_vector_type: "
                    "'received_vector'."
                )
            self._input_vector_type = _AUTO
        elif input_type.lower() in ("syndrome", "s", "0"):
            self._input_vector_type = _SYNDROME
        elif input_type.lower() in ("received_vector", "r", "1"):
            self._input_vector_type = _RECEIVED_VECTOR
        else:
            raise ValueError(
                f"The input vector type '{input_type}' is invalid. Please choose "
                "from the following methods: 'input_vector_type=syndrome', "
                "'input_vector_type=received_vector'"
            )

    @property
    def log_prob_ratios(self) -> np.ndarray:
        return np.asarray(self._log_prob_ratios)

    @property
    def converge(self) -> bool:
        return self._converge

    @property
    def iter(self) -> int:
        return self._iter

    @property
    def check_count(self) -> int:
        return self.m

    @property
    def bit_count(self) -> int:
        return self.n

    @property
    def max_iter(self) -> int:
        return self._max_iter

    @max_iter.setter
    def max_iter(self, value: int) -> None:
        if not isinstance(value, int):
            raise ValueError(
                "max_iter input parameter is invalid. This must be specified as a positive int."
            )
        if value < 0:
            raise ValueError(
                f"max_iter input parameter must be a positive int. Not {value}."
            )
        self._max_iter = value if value != 0 else self.n
        self._invalidate()

    @property
    def bp_method(self) -> str:
        return "product_sum" if self._bp_method == bp_ops.PRODUCT_SUM else "minimum_sum"

    @bp_method.setter
    def bp_method(self, value: Union[str, int]) -> None:
        sval = str(value).lower()
        if sval in ("prod_sum", "product_sum", "ps", "0", "prod sum"):
            self._bp_method = bp_ops.PRODUCT_SUM
        elif sval in ("min_sum", "minimum_sum", "ms", "1", "minimum sum", "min sum"):
            self._bp_method = bp_ops.MINIMUM_SUM
        else:
            raise ValueError(
                f"BP method '{value}' is invalid. Please choose from the "
                "following methods: 'product_sum', 'minimum_sum'"
            )
        self._invalidate()

    @property
    def schedule(self) -> str:
        return {0: "serial", 1: "parallel", 2: "serial_relative"}[self._schedule]

    @schedule.setter
    def schedule(self, value: Union[str, int]) -> None:
        sval = str(value).lower()
        if sval in ("parallel", "p", "0"):
            self._schedule = bp_ops.PARALLEL
        elif sval in ("serial", "s", "1"):
            self._schedule = bp_ops.SERIAL
        elif sval in ("serial_relative", "sr", "2"):
            self._schedule = bp_ops.SERIAL_RELATIVE
        else:
            raise ValueError(
                f"The BP schedule method '{value}' is invalid. Please choose "
                "from the following methods: 'schedule=parallel', "
                "'schedule=serial', 'schedule=serial_relative'"
            )
        self._invalidate()

    @property
    def serial_schedule_order(self) -> Union[None, np.ndarray]:
        if self._serial_schedule_order is None:
            return None
        return np.asarray(self._serial_schedule_order).astype(int)

    @serial_schedule_order.setter
    def serial_schedule_order(self, value) -> None:
        if value is None:
            self._serial_schedule_order = None
            self._invalidate()
            return
        if not len(value) == self.n:
            raise Exception(
                "Input error. The `serial_schedule_order` input parameter must "
                "have length equal to the length of the code."
            )
        arr = np.zeros(self.n, dtype=np.int32)
        for i in range(self.n):
            if (
                not isinstance(value[i], (int, np.int64, np.int32))
                or value[i] < 0
                or value[i] >= self.n
            ):
                raise ValueError(
                    f"serial_schedule_order[{i}] is invalid. It must be a "
                    f"non-negative integer less than {self.n}."
                )
            arr[i] = value[i]
        self._serial_schedule_order = arr
        self._random_serial_schedule = False
        self._invalidate()

    @property
    def ms_scaling_factor(self) -> float:
        return self._ms_scaling_factor

    @ms_scaling_factor.setter
    def ms_scaling_factor(self, value: float) -> None:
        if not isinstance(value, (float, int)):
            raise TypeError("The ms_scaling factor must be specified as a float")
        self._ms_scaling_factor = float(value)
        self._invalidate()

    @property
    def omp_thread_count(self) -> int:
        # setter-only warning (reference: _bp_decoder.pyx:508-527) — reading
        # the property must not spam warnings
        return self._omp_thread_count

    @omp_thread_count.setter
    def omp_thread_count(self, value: int) -> None:
        if not isinstance(value, int) or value < 1:
            raise TypeError(
                "The omp_thread_count must be specified as a positive integer."
            )
        self._omp_thread_count = value
        if self._omp_thread_count != 1:
            warnings.warn(
                "The OpenMP functionality is not implemented: device "
                "parallelism comes from batching, not threads."
            )

    @property
    def random_schedule_seed(self) -> int:
        return self._random_schedule_seed

    @random_schedule_seed.setter
    def random_schedule_seed(self, value: int) -> None:
        if not isinstance(value, int) or value < -2:
            raise ValueError(
                "The value of random_schedule_seed must be a positive integer. "
                "Set as -1 to disable to the random schedule. Set as 0 to use "
                "the system clock."
            )
        self._random_serial_schedule = True
        self._random_schedule_seed = value
        self._invalidate()

    @property
    def random_serial_schedule(self) -> bool:
        return self._random_serial_schedule

    @random_serial_schedule.setter
    def random_serial_schedule(self, value: bool) -> None:
        self._random_serial_schedule = value
        self._invalidate()

    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(int)
