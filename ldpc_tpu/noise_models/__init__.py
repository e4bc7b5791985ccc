"""Noise models (reference: src_python/ldpc/noise_models/bsc.py).

Host numpy samplers for the simulation harnesses plus device-side
``jax.random`` equivalents for on-device Monte-Carlo loops.
"""

import numpy as np

import jax
import jax.numpy as jnp


def generate_bsc_error(n: int, error_rate: float) -> np.ndarray:
    """Sample a binary-symmetric-channel error vector
    (reference: bsc.py:4-25)."""
    return np.random.binomial(1, error_rate, n).astype(np.uint8)


def generate_bsc_error_batch(
    key, batch: int, n: int, error_rate
) -> jnp.ndarray:
    """Device-side batched BSC sampler: (batch, n) uint8 errors.

    The device path for Monte-Carlo loops — errors are drawn with
    ``jax.random`` on device so the sampling joins the decode program
    and nothing crosses the host boundary.
    """
    u = jax.random.uniform(key, (batch, n))
    return (u < error_rate).astype(jnp.uint8)


def generate_depolarizing_error_batch(
    key, batch: int, n: int, error_rate
) -> jnp.ndarray:
    """Device-side batched depolarizing sampler: (batch, n) uint8 GF(4)
    errors (0=I, 1=X, 2=Y, 3=Z each with p/3).

    The reference ships only a commented-out stub for depolarising
    noise (reference: noise_models/depolarising_noise.py:1-24); this is
    the working equivalent for the MBP decoder.
    """
    u = jax.random.uniform(key, (batch, n))
    kinds = jax.random.randint(key, (batch, n), 1, 4)
    return jnp.where(u < error_rate, kinds, 0).astype(jnp.uint8)


__all__ = [
    "generate_bsc_error",
    "generate_bsc_error_batch",
    "generate_depolarizing_error_batch",
]
