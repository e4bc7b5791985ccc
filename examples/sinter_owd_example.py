"""Overlapping-window sinter example (requires stim + sinter installed;
reference workload: examples/sinter_example_owd.py — repetition-code
memory circuits decoded in sliding windows with BPOSD/LSD/PyMatching).

The OWD sinter wrappers decode every window batch through the batched
``decode_batch`` path, so each sinter worker streams its whole shot file
through the accelerator instead of looping shot by shot.
"""

import numpy as np


def generate_decoders(ds, decodings):
    from ldpc_tpu.ckt_noise.sinter_overlapping_window_decoder import (
        SinterDecoder_BPOSD_OWD,
        SinterDecoder_LSD_OWD,
    )

    decoders = {}
    for d in ds:
        for r in decodings:
            common = dict(
                decodings=int(r),
                window=int(2 * d),
                commit=int(d),
                num_checks=int(d - 1),
            )
            decoders[f"bposd_owd_d{d}_r{r}"] = SinterDecoder_BPOSD_OWD(
                **common
            )
            decoders[f"lsd_owd_d{d}_r{r}"] = SinterDecoder_LSD_OWD(**common)
    return decoders


def generate_tasks(ds, decodings, probabilities):
    import sinter
    import stim

    from ldpc_tpu.ckt_noise.not_an_arb_ckt_simulator import (
        get_stabilizer_time_steps,
        stim_circuit_from_time_steps,
    )
    from ldpc_tpu.codes import rep_code

    import scipy.sparse

    tasks = []
    for d in ds:
        pcm = rep_code(d)
        # logical observable: a single data bit (minimal-weight rep-code
        # logical; the circuit and the decoder share the same observable)
        logicals = scipy.sparse.csr_matrix(
            ([1], ([0], [0])), shape=(1, pcm.shape[1]), dtype=np.uint8
        )
        timesteps, measured_bits = get_stabilizer_time_steps(pcm)
        for r in decodings:
            rounds = int(r * d + d)
            for p in probabilities:
                circuit = stim_circuit_from_time_steps(
                    pcm,
                    logicals,
                    timesteps,
                    measured_bits,
                    after_clifford_depolarization=p,
                    after_reset_flip_probability=p,
                    before_measure_flip_probability=p,
                    before_round_data_depolarization=p,
                    rounds=rounds,
                )
                for name in (f"bposd_owd_d{d}_r{r}", f"lsd_owd_d{d}_r{r}"):
                    tasks.append(
                        sinter.Task(
                            circuit=circuit,
                            decoder=name,
                            json_metadata={"d": int(d), "r": int(r),
                                           "p": float(p)},
                        )
                    )
    return tasks


def main():
    import sinter

    ds = np.array([5, 7])
    decodings = np.array([3])
    probabilities = [0.01, 0.02]
    results = sinter.collect(
        num_workers=4,
        tasks=generate_tasks(ds, decodings, probabilities),
        custom_decoders=generate_decoders(ds, decodings),
        max_shots=10_000,
        print_progress=True,
    )
    for res in results:
        meta = res.json_metadata
        print(
            f"d={meta['d']} r={meta['r']} p={meta['p']} "
            f"{res.decoder}: {res.errors}/{res.shots} errors"
        )


if __name__ == "__main__":
    main()
