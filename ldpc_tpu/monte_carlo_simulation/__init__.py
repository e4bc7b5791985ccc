"""Monte-Carlo simulation harnesses.

API parity with ``ldpc.monte_carlo_simulation`` (reference:
src_python/ldpc/monte_carlo_simulation/), re-designed batch-first: the
device decode path wants thousands of syndromes per dispatch, so the BSC
simulation samples and decodes whole batches instead of the reference's
one-syndrome-per-loop (mcs.py:116-149).
"""

from ldpc_tpu.monte_carlo_simulation.mcs import (  # noqa: F401
    MonteCarloBscSimulation,
)
from ldpc_tpu.monte_carlo_simulation.data_utils import BpParams  # noqa: F401
from ldpc_tpu.monte_carlo_simulation.memory_experiment import (  # noqa: F401
    build_multiround_pcm,
    decode_multiround,
    move_syndrome,
)
from ldpc_tpu.monte_carlo_simulation import simulation_utils  # noqa: F401
from ldpc_tpu.monte_carlo_simulation.device_mc import (  # noqa: F401
    DeviceMonteCarlo,
    make_mc_decoder_step,
    make_sharded_mc_step,
)
from ldpc_tpu.monte_carlo_simulation.quasi_single_shot import (  # noqa: F401
    QssSimulator,
    QSS_SimulatorV2,
)
from ldpc_tpu.monte_carlo_simulation.device_qss import (  # noqa: F401
    DeviceQss,
    make_qss_step,
    make_sharded_qss_step,
)

__all__ = [
    "MonteCarloBscSimulation",
    "DeviceMonteCarlo",
    "make_mc_decoder_step",
    "make_sharded_mc_step",
    "BpParams",
    "build_multiround_pcm",
    "decode_multiround",
    "move_syndrome",
    "simulation_utils",
    "QssSimulator",
    "QSS_SimulatorV2",
    "DeviceQss",
    "make_qss_step",
    "make_sharded_qss_step",
]
