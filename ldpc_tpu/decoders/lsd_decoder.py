"""LsdDecoder: standalone localized-statistics decoding (no BP stage).

API parity with the reference
(reference: src_python/ldpc/lsd_decoder/_lsd_decoder.pyx): the user
supplies per-bit weights (soft information) to guide cluster growth
(_lsd_decoder.pyx:129-175).
"""

from typing import Optional, Union
import warnings

import numpy as np
import scipy.sparse

import jax.numpy as jnp

from ldpc_tpu.decoders.lsd_common import METHOD_NAMES, parse_lsd_method
from ldpc_tpu.helpers import convert_to_binary_sparse
from ldpc_tpu.ops import lsd as lsd_ops
from ldpc_tpu.ops.pcm import compile_pcm


class LsdDecoder:
    """Standalone batched LSD decoder (lsd.hpp:683-784)."""

    def __init__(
        self,
        pcm,
        bits_per_step: int = 1,
        lsd_order: int = 0,
        lsd_method: Union[str, int] = 0,
    ):
        if not isinstance(pcm, (np.ndarray, scipy.sparse.spmatrix)):
            raise TypeError(
                "The input matrix is of an invalid type. Please input "
                f"a np.ndarray or spmatrix object, not {type(pcm)}"
            )
        self._pcm = convert_to_binary_sparse(pcm)
        self.m, self.n = self._pcm.shape
        self.bits_per_step = bits_per_step if bits_per_step != 0 else self.n
        self._lsd_method = 0
        self._lsd_order = 0
        self.lsd_method = lsd_method
        self.lsd_order = lsd_order
        self._graph = compile_pcm(self._pcm)
        self._fn = None
        self._decoding = np.zeros(self.n, dtype=np.uint8)

    @property
    def lsd_method(self) -> Optional[str]:
        return METHOD_NAMES.get(self._lsd_method)

    @lsd_method.setter
    def lsd_method(self, method) -> None:
        self._lsd_method = parse_lsd_method(method)
        if self._lsd_method == lsd_ops.LSD_0:
            self._lsd_order = 0
        self._fn = None
        self._pfn_cache = None

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
        self._fn = None
        self._pfn_cache = None

    def _decode_fn(self):
        if self._fn is None:
            self._fn = lsd_ops.make_lsd_decoder(
                self._graph,
                lsd_method=max(self._lsd_method, 0),
                lsd_order=self._lsd_order,
                bits_per_step=self.bits_per_step,
            )
        return self._fn

    def decode(self, syndrome: np.ndarray, bit_weights: np.ndarray) -> np.ndarray:
        syndrome = np.asarray(syndrome)
        if not len(syndrome) == self.m:
            raise ValueError(
                f"The syndrome must have length {self.m}. Not {len(syndrome)}."
            )
        bit_weights = np.asarray(bit_weights, dtype=np.float64)
        if not len(bit_weights) == self.n:
            raise ValueError(
                f"The bit weights must have length {self.n}. Not {len(bit_weights)}."
            )
        out = self.decode_batch(
            syndrome[None, :].astype(np.uint8), bit_weights[None, :]
        )[0]
        return out.astype(syndrome.dtype)

    def _packed_fn(self, sparse_plan=None):
        """One-dispatch program per chunk: bit-packed syndromes in, ONE
        packed uint8 buffer (decodings + validity bits) out. 1-D weights
        broadcast ON DEVICE instead of uploading a (B, n) float block.
        ``sparse_plan`` selects the segmented index-coded decoding
        export (decoders.base)."""
        if getattr(self, "_pfn_cache", None) is None:
            self._pfn_cache = {}
        fn = self._pfn_cache.get(sparse_plan)
        if fn is None:
            import jax

            from ldpc_tpu.decoders import base as _base
            from ldpc_tpu.ops import gf2

            inner = self._decode_fn()
            m, n = self.m, self.n

            def program(syn_packed, weights):
                syn = gf2.unpack_bits_u8_device(syn_packed, m)
                if weights.ndim == 1:
                    weights_b = jnp.broadcast_to(
                        weights, (syn.shape[0], n)
                    )
                else:
                    weights_b = weights
                dec, valid = inner(syn, weights_b)
                nonzero = syn.any(axis=1)
                dec = dec * nonzero[:, None].astype(dec.dtype)
                valid = valid | ~nonzero
                if sparse_plan is not None:
                    S, Ks = sparse_plan
                    L = _base._SEG_L
                    flat = dec.reshape(-1)
                    xp = jnp.pad(
                        flat, (0, S * L - flat.shape[0])
                    ).reshape(S, L)
                    mask = xp != 0
                    keys = jnp.where(
                        mask, jnp.arange(L, dtype=jnp.int32)[None, :], L
                    )
                    sk = jax.lax.sort(keys, dimension=1)[:, :Ks]
                    cnts = jnp.minimum(mask.sum(axis=1), 255).astype(
                        jnp.uint8
                    )
                    head = jnp.concatenate(
                        [
                            jnp.minimum(sk, 255)
                            .astype(jnp.uint8)
                            .reshape(-1),
                            cnts,
                        ]
                    )
                else:
                    head = gf2.pack_bits_u8(dec).reshape(-1)
                return jnp.concatenate(
                    [
                        head,
                        gf2.pack_bits_u8(
                            valid[None, :].astype(jnp.uint8)
                        )[0],
                    ]
                )

            fn = jax.jit(program)
            self._pfn_cache[sparse_plan] = fn
        return fn

    def decode_batch(
        self, syndromes: np.ndarray, bit_weights: np.ndarray
    ) -> np.ndarray:
        from ldpc_tpu.decoders import base as _base

        syndromes = np.atleast_2d(np.asarray(syndromes, dtype=np.uint8))
        bit_weights = np.asarray(bit_weights, dtype=np.float32)
        B0 = syndromes.shape[0]
        shared_w = None
        if bit_weights.ndim == 1 or bit_weights.shape[0] == 1:
            # one weight vector for every row: broadcast on device
            shared_w = jnp.asarray(bit_weights.reshape(-1))
        else:
            bit_weights = np.atleast_2d(bit_weights)
        Wb = -(-self.n // 8)
        # the decoding weight tracks the syndrome weight (matching-like
        # corrections); overflow redispatches dense — a hint, not a bound
        wbar_est = max(2.0, float(syndromes.sum()) / max(B0, 1))
        syn_packed_all = np.packbits(syndromes, axis=1, bitorder="little")
        CH = 8192
        launches = []
        for st in range(0, B0, CH) or [0]:
            chunk = syn_packed_all[st : st + CH]
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
            if shared_w is not None:
                w_c = shared_w
            else:
                w_c = bit_weights[st : st + Bc]
                if Bpad != Bc:
                    w_c = np.concatenate(
                        [w_c, np.zeros((Bpad - Bc, self.n), np.float32)]
                    )
                w_c = jnp.asarray(w_c)
            plan = _base._plan_unless_disabled(self, Bpad, Wb, wbar_est)
            buf = self._packed_fn(plan)(jnp.asarray(chunk), w_c)
            if hasattr(buf, "copy_to_host_async"):
                buf.copy_to_host_async()
            launches.append((st, Bc, Bpad, plan, chunk, w_c, buf))

        dec = np.empty((B0, self.n), np.uint8)
        valid = np.empty(B0, bool)
        for st, Bc, Bpad, plan, chunk, w_c, buf in launches:
            buf_np = np.asarray(buf)
            o1 = plan[0] * (plan[1] + 1) if plan else Bpad * Wb
            seg_over = bool(
                plan and buf_np[plan[0] * plan[1] : o1].max() > plan[1]
            )
            if seg_over:  # overflow: redo the chunk with the dense layout
                self._seg_plan_off = True  # see base._plan_unless_disabled
                plan = None
                buf_np = np.asarray(
                    self._packed_fn(None)(jnp.asarray(chunk), w_c)
                )
                o1 = Bpad * Wb
            if plan:
                dec[st : st + Bc] = _base._reconstruct_segments(
                    buf_np, plan, Bpad, self.n
                )[:Bc]
            else:
                dec[st : st + Bc] = np.unpackbits(
                    buf_np[:o1].reshape(Bpad, Wb)[:Bc],
                    axis=1,
                    count=self.n,
                    bitorder="little",
                )
            valid[st : st + Bc] = np.unpackbits(
                buf_np[o1 : o1 + Bpad // 8], count=Bc, bitorder="little"
            ).astype(bool)
        self.valid_batch = valid
        self._decoding = dec[0]
        return dec

    @property
    def decoding(self) -> np.ndarray:
        return np.asarray(self._decoding).astype(np.uint8)
