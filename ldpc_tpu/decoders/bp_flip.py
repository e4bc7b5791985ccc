"""FlipDecoder and BpFlipDecoder.

API parity with the reference (reference:
src_python/ldpc/bp_flip/_bp_flip.pyx): ``BpFlipDecoder.decode`` runs flip
*first*, then BP on the residual syndrome, and XORs the two corrections
(_bp_flip.pyx:44-61 — note the inverted order vs the class name).
``FlipDecoder`` is the standalone greedy flip / p-flip decoder
(reference: src_cpp/flip.hpp).
"""

import time
from typing import List, Optional, Union

import numpy as np
import scipy.sparse

import jax
import jax.numpy as jnp

from ldpc_tpu.decoders.base import BpDecoderBase
from ldpc_tpu.helpers import convert_to_binary_sparse
from ldpc_tpu.ops import flip as flip_ops
from ldpc_tpu.ops.pcm import compile_pcm


class FlipDecoder:
    """Standalone batched flip / p-flip decoder (flip.hpp:61-137).

    Unlike the reference's C++-only class, a zero syndrome converges
    immediately (the reference only reaches flip through BpFlipDecoder,
    which short-circuits zero syndromes before the flip stage).
    """

    def __init__(self, pcm, max_iter: int = 0, pfreq: int = 0, seed: int = 0):
        if not isinstance(pcm, (np.ndarray, scipy.sparse.spmatrix)):
            raise TypeError(
                "The input matrix is of an invalid type. Please input "
                f"a np.ndarray or scipy.sparse.spmatrix object, not {type(pcm)}"
            )
        self._pcm = convert_to_binary_sparse(pcm)
        self.m, self.n = self._pcm.shape
        self.max_iter = max_iter if max_iter != 0 else self.n
        self.pfreq = pfreq
        self.seed = seed
        self._graph = compile_pcm(self._pcm)
        self._fn = flip_ops.make_flip_decoder(self._graph, self.max_iter, self.pfreq)
        self.converge = False
        self.iterations = 0
        self._decoding = np.zeros(self.n, dtype=np.uint8)

    def _key(self):
        seed = self.seed if self.seed != 0 else time.time_ns() & 0x7FFFFFFF
        return jax.random.key(seed)

    def decode(self, syndrome: np.ndarray) -> np.ndarray:
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        out = self.decode_batch(syndrome[None, :].astype(np.uint8))[0]
        return out.astype(syndrome.dtype)

    def decode_batch(self, syndromes: np.ndarray) -> np.ndarray:
        syndromes = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        dec, conv, iters = self._fn(jnp.asarray(syndromes), self._key())
        self.converge_batch = np.asarray(conv)
        self.iter_batch = np.asarray(iters)
        self.converge = bool(self.converge_batch[0])
        self.iterations = int(self.iter_batch[0])
        dec = np.asarray(dec)
        self._decoding = dec[0]
        return dec

    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(int)


class BpFlipDecoder(BpDecoderBase):
    """Flip pre-decoding followed by BP on the residual syndrome
    (reference: _bp_flip.pyx:10-61)."""

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
        flip_iterations: int = 0,
        pflip_frequency: int = 0,
        pflip_seed: int = 0,
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
        self.flip_iterations = flip_iterations
        self._flip = FlipDecoder(
            self._pcm, max_iter=flip_iterations, pfreq=pflip_frequency, seed=pflip_seed
        )

    def decode(self, syndrome: np.ndarray) -> np.ndarray:
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        out = self.decode_batch(syndrome[None, :].astype(np.uint8))[0]
        return out.astype(syndrome.dtype)

    def _fused_fn(self, sparse_plan=None):
        """One device program per chunk: unpack packed syndromes -> flip
        -> residual (0/1 matmul) -> BP -> XOR -> ONE packed export, so
        the flip decodings never round-trip through the host for the
        residual."""
        if getattr(self, "_bpf_cache", None) is None:
            self._bpf_cache = {}
        key = (sparse_plan, self._channel.tobytes(), self._config_key())
        fn = self._bpf_cache.get(key)
        if fn is not None:
            return fn
        import jax

        from ldpc_tpu.decoders import base as _base
        from ldpc_tpu.ops import gf2

        m, n = self.m, self.n
        flip_inner = self._flip._fn
        bp_fn = self._make_parallel_bp(self._max_iter)
        Hf = jnp.asarray(self.graph.dense.astype(np.float32))  # (m, n)
        init_llr = jnp.asarray(self._init_llr())
        it_jdt = _base._iters_dtype(self._max_iter)[0]

        def program(syn_packed, key):
            syn = gf2.unpack_bits_u8_device(syn_packed, m)
            fdec, _, _ = flip_inner(syn, key)
            fsyn = jax.lax.dot_general(
                fdec.astype(jnp.float32),
                Hf,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            residual = syn ^ (fsyn.astype(jnp.int32) & 1).astype(jnp.uint8)
            bp = bp_fn(residual, init_llr)
            nonzero = syn.any(axis=1)
            out = (bp.decoding ^ fdec) * nonzero[:, None].astype(jnp.uint8)
            conv = bp.converged | ~nonzero
            if sparse_plan is not None:
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
                head = gf2.pack_bits_u8(out).reshape(-1)
            return jnp.concatenate(
                [
                    head,
                    gf2.pack_bits_u8(conv[None, :].astype(jnp.uint8))[0],
                    jax.lax.bitcast_convert_type(
                        bp.iterations.astype(it_jdt), jnp.uint8
                    ).reshape(-1),
                ]
            )

        fn = jax.jit(program)
        self._bpf_cache[key] = fn
        return fn

    def decode_batch(self, syndromes: np.ndarray) -> np.ndarray:
        syndromes = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        nonzero = syndromes.any(axis=1)
        if not self._fused_ok():
            return self._decode_batch_host(syndromes, nonzero)
        return self._decode_batch_fused_flip(syndromes, nonzero)

    def _decode_batch_fused_flip(self, syndromes, nonzero):
        """Chunked single-pull decode over :meth:`_fused_fn`."""
        from ldpc_tpu.decoders import base as _base

        B0 = syndromes.shape[0]
        Wb = -(-self.n // 8)
        wbar = float(np.sum(self._channel))
        it_ndt, it_size = _base._iters_dtype(self._max_iter)[1:]
        packed_all = np.packbits(syndromes, axis=1, bitorder="little")
        key = self._flip._key()
        CH = 8192
        launches = []
        import jax

        for st in range(0, B0, CH) or [0]:
            chunk = packed_all[st : st + CH]
            Bc = chunk.shape[0]
            Bpad = (
                -(-Bc // 512) * 512
                if Bc >= 512
                else max(128, -(-Bc // 128) * 128)
            )
            if Bpad != Bc:
                chunk = np.concatenate(
                    [chunk, np.zeros((Bpad - Bc, chunk.shape[1]), np.uint8)]
                )
            # BP failures keep their (possibly heavier) decodings: pad
            # the segment budget vs the channel-weight estimate
            plan = _base._plan_unless_disabled(self, Bpad, Wb, wbar * 1.5)
            dev = jnp.asarray(chunk)
            ck = jax.random.fold_in(key, st)
            buf = self._fused_fn(plan)(dev, ck)
            if hasattr(buf, "copy_to_host_async"):
                buf.copy_to_host_async()
            launches.append((st, Bc, Bpad, plan, dev, ck, buf))

        out = np.empty((B0, self.n), np.uint8)
        conv = np.empty(B0, bool)
        iters = np.empty(B0, np.int32)
        for st, Bc, Bpad, plan, dev, ck, buf in launches:
            buf_np = np.asarray(buf)
            o1 = plan[0] * (plan[1] + 1) if plan else Bpad * Wb
            seg_over = bool(
                plan and buf_np[plan[0] * plan[1] : o1].max() > plan[1]
            )
            if seg_over:
                self._seg_plan_off = True  # see base._plan_unless_disabled
                plan = None
                buf_np = np.asarray(self._fused_fn(None)(dev, ck))
                o1 = Bpad * Wb
            o2 = o1 + Bpad // 8
            if plan:
                out[st : st + Bc] = _base._reconstruct_segments(
                    buf_np, plan, Bpad, self.n
                )[:Bc]
            else:
                out[st : st + Bc] = np.unpackbits(
                    buf_np[:o1].reshape(Bpad, Wb)[:Bc],
                    axis=1,
                    count=self.n,
                    bitorder="little",
                )
            conv[st : st + Bc] = np.unpackbits(
                buf_np[o1:o2], count=Bc, bitorder="little"
            ).astype(bool)
            iters[st : st + Bc] = (
                np.ascontiguousarray(buf_np[o2:]).view(it_ndt)[:Bc]
            )
        conv |= ~nonzero
        out[~nonzero] = 0
        self.converge_batch = conv
        self.iter_batch = iters
        self._converge = bool(conv[0])
        self._iter = int(iters[0])
        self._decoding = out[0]
        return out

    def _decode_batch_host(self, syndromes, nonzero):
        """Flip on the device, residual and XOR on the host."""
        flip_dec = self._flip.decode_batch(syndromes)
        residual = (
            syndromes
            ^ (self._pcm.dot(flip_dec.T).T % 2).astype(np.uint8)
        )
        bp = self._run_bp_batch(residual)
        out = (np.asarray(bp.decoding) ^ flip_dec).astype(np.uint8)
        out[~nonzero] = 0
        conv = np.asarray(bp.converged) | ~nonzero
        self.converge_batch = conv
        self.iter_batch = np.asarray(bp.iterations)
        self._converge = bool(conv[0])
        self._iter = int(np.asarray(bp.iterations)[0])
        self._log_prob_ratios = np.asarray(bp.llr_posterior)[0]
        self._decoding = out[0]
        return out

    def _graph_dense_T(self) -> np.ndarray:
        return self.graph.dense.T
