"""Test configuration.

The CPU suite (every run but ``-m gpu``) pins JAX to the CPU backend with
8 virtual devices, which stand in for a mesh in the sharding tests, and
enables float64 for the exact-parity mode of the golden reference tests;
decoders still default to float32.

The GPU lane (``pytest -m gpu``, run on the card by ``chip_smoke.py``)
leaves the backend and float64 alone: x64 stays off on the card, as the
float32 programs under test expect. Its tests skip themselves when no GPU
is present (tests/test_gpu_hardware.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    if (config.option.markexpr or "").strip() == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
