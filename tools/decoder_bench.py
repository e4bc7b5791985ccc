"""Per-decoder-family throughput vs the MATCHED compiled-reference
baseline on the BASELINE d=13 surface workload (optionally any surface
distance / a [[400,16,6]] HGP workload — see --code).

The headline bench (bench.py) measures the BP+OSD-0 pipeline; this tool
measures EVERY public decoder family at its ``decode_batch`` surface AND
runs the same workload through the matched reference C++ variant
(native/bench_baseline.cpp modes: osd|lsd|lsd-nobp|uf-*|flip|bpflip|
softinfo|mbp), so "matching-or-beating on perf" is demonstrated per
family, not just for the flagship. Prints one JSON line per decoder:

    {"decoder": "BpOsdDecoder[osd_cs-2]", "rate": N, "unit": "syndromes/s",
     "baseline": N, "vs_matched_baseline": N, ...}

Rows whose comparison needs a caveat carry a "note" field (e.g. the BP
row does not assert syndrome validity; the unguided reference peel hangs,
so the standalone-peel baseline is the reference's guided configuration).

Usage: python tools/decoder_bench.py [batch] [reps] [--code surface13|hgp400]
       [--only substring]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

MAX_ITER = 30
MS_FACTOR = 0.625
ERROR_RATE = 0.01


def build_code(which):
    """(hx csr, workload label)."""
    if which == "hgp400":
        # the reference's flagship quantum workload: the [[400,16,6]]
        # hypergraph-product code, loaded from the reference's own PCM
        # fixture (python_test/test_qcodes.py:95-160; pcms/*.npz is
        # data, not code)
        import scipy.sparse

        hx = scipy.sparse.load_npz(
            "/root/reference/python_test/pcms/hx_400_16_6.npz"
        ).tocsr()
        return hx, "hgp_400_16_6"
    if which == "toric20":
        import scipy.sparse

        hx = scipy.sparse.load_npz(
            "/root/reference/python_test/pcms/hx_toric_20.npz"
        ).tocsr()
        return hx, "toric_d20"
    from ldpc_tpu.codes import surface_code

    d = int(which.replace("surface", "") or 13)
    return surface_code(d).hx, f"surface_d{d}"


def main():
    args = [a for a in sys.argv[1:]]
    only = None
    code_name = "surface13"
    pos = []
    i = 0
    while i < len(args):
        if args[i] == "--only":
            only = args[i + 1]
            i += 2
        elif args[i] == "--code":
            code_name = args[i + 1]
            i += 2
        else:
            pos.append(args[i])
            i += 1
    batch = int(pos[0]) if len(pos) > 0 else 65536
    reps = int(pos[1]) if len(pos) > 1 else 5
    nb_default = 2000

    import jax

    from ldpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from ldpc_tpu import (
        BeliefFindDecoder,
        BpDecoder,
        BpFlipDecoder,
        BpLsdDecoder,
        BpOsdDecoder,
        FlipDecoder,
        LsdDecoder,
        MbpDecoder,
        SoftInfoBpDecoder,
        UnionFindDecoder,
    )
    from ldpc_tpu.utils import reference_baseline as rb

    hx, workload = build_code(code_name)
    H = np.asarray(hx.todense(), np.uint8)
    m, n = H.shape
    rng = np.random.default_rng(11)
    errors = (rng.random((batch, n)) < ERROR_RATE).astype(np.uint8)
    syndromes = (errors @ H.T % 2).astype(np.uint8)
    llr1 = np.full(n, np.log((1 - ERROR_RATE) / ERROR_RATE), np.float32)

    common = dict(
        error_rate=ERROR_RATE,
        max_iter=MAX_ITER,
        bp_method="minimum_sum",
        ms_scaling_factor=MS_FACTOR,
    )
    NOTE_BP = (
        "BP alone does not guarantee syndrome-valid output; validity is "
        "not asserted for this row (matches the reference's BpDecoder)"
    )
    NOTE_PEEL = (
        "baseline is the reference's llr-guided peel (bits_per_step=1), "
        "its terminating standalone configuration — the unguided "
        "reference peel loops forever on some syndromes (upstream bug "
        "this framework does not share)"
    )
    NOTE_PEEL_GUIDED = (
        "one-bit-per-step guided growth is inherently sequential on both "
        "sides; this row is latency-bound, not throughput-bound — the "
        "recommended standalone configuration is the unguided row above"
    )

    # soft-info workload: analog syndromes derived from the hard ones
    SOFT_SIGMA, SOFT_CUTOFF = 0.6, 5.0
    soft_syndromes = (
        (1.0 - 2.0 * syndromes) + SOFT_SIGMA * rng.normal(size=syndromes.shape)
    )

    # GF(4) workload for MBP (CSS stack: hz rows as Z=3, hx rows as X=1)
    # — surface workloads only (the hgp fixture ships hx alone)
    Hgf4 = mbp_syn = None
    mbp_batch = min(batch, 16384)
    ch3 = np.full((3, n), ERROR_RATE)
    if workload.startswith("surface"):
        from ldpc_tpu.codes import surface_code as _sc

        _code = _sc(int(workload.split("_d")[1]))
        Hgf4 = np.vstack(
            [np.asarray(_code.hz.todense(), np.uint8) * 3,
             np.asarray(_code.hx.todense(), np.uint8)]
        ).astype(np.uint8)

        # GF(4) errors -> pauli syndromes (commutation, mbp.hpp:43-56):
        # check i fires if |{j: H[i,j] and e[j] and e[j] != H[i,j]}| odd
        def pauli_syndromes(errs):
            out = np.zeros((errs.shape[0], Hgf4.shape[0]), np.uint8)
            Hnz = Hgf4 != 0
            for st in range(0, errs.shape[0], 2048):
                e = errs[st : st + 2048]
                acc = ((e[:, None, :] != 0) & Hnz[None] &
                       (e[:, None, :] != Hgf4[None])).sum(axis=2)
                out[st : st + 2048] = (acc % 2).astype(np.uint8)
            return out

        gf4_errors = rng.choice(
            4, size=(mbp_batch, n),
            p=[1 - 3 * ERROR_RATE] + [ERROR_RATE] * 3,
        ).astype(np.uint8)
        mbp_syn = pauli_syndromes(gf4_errors)

    have_ref = rb.build_binary() is not None

    def std_decode(dec):
        return lambda: dec.decode_batch(syndromes)

    # (name, decoder-or-None, decode_fn, check_valid, ref_cfg, ref stdin
    #  builder, note, batch_used)
    stdin_hard = None
    stdin_soft = None
    stdin_mbp = None

    def hard_input(nb):
        return rb.make_input(H, [ERROR_RATE] * n, syndromes[:nb])

    def soft_input(nb):
        return rb.make_input(
            H, [ERROR_RATE] * n, None, soft_syndromes=soft_syndromes[:nb]
        )

    def mbp_input(nb):
        return rb.make_input(Hgf4, None, mbp_syn[:nb], channel3=ch3)

    variants = []

    def add(name, build, decode=None, valid=True, ref=None,
            stdin=hard_input, note=None, nb=nb_default, bsz=None,
            ref_reps=5):
        variants.append(dict(
            name=name, build=build, decode=decode, valid=valid, ref=ref,
            stdin=stdin, note=note, nb=nb, bsz=bsz or batch,
            ref_reps=ref_reps,
        ))

    add("BpDecoder", lambda: BpDecoder(hx, **common), valid=False,
        ref=dict(decoder="osd", osd_method=-1), note=NOTE_BP)
    add("BpOsdDecoder[osd0]",
        lambda: BpOsdDecoder(hx, osd_method="osd_0", **common),
        ref=dict(decoder="osd", osd_method=0, osd_order=0))
    add("BpOsdDecoder[osd_cs-2]",
        lambda: BpOsdDecoder(hx, osd_method="osd_cs", osd_order=2, **common),
        ref=dict(decoder="osd", osd_method=2, osd_order=2))
    add("BpOsdDecoder[osd_e-2]",
        lambda: BpOsdDecoder(hx, osd_method="osd_e", osd_order=2, **common),
        ref=dict(decoder="osd", osd_method=1, osd_order=2))
    add("BpOsdDecoder[osd_cs-5]",
        lambda: BpOsdDecoder(hx, osd_method="osd_cs", osd_order=5, **common),
        ref=dict(decoder="osd", osd_method=2, osd_order=5))
    add("BpLsdDecoder[lsd0]",
        lambda: BpLsdDecoder(hx, lsd_method="lsd_0", lsd_order=0, **common),
        ref=dict(decoder="lsd", osd_method=-1, osd_order=0))
    add("BpLsdDecoder[lsd_cs-5]",
        lambda: BpLsdDecoder(hx, lsd_method="lsd_cs", lsd_order=5, **common),
        ref=dict(decoder="lsd", osd_method=2, osd_order=5),
        note="order-w LSD re-eliminates the column-masked global system "
             "once per nullity-growth round (W+2 solves); per BP-failure "
             "it is ~2x the reference's per-cluster dense algebra, but "
             "the batched engine pays it for the whole failure bucket — "
             "a structural gap on top of the ~9% BP failure rate")
    add("BeliefFindDecoder[inversion]",
        lambda: BeliefFindDecoder(hx, uf_method="inversion", **common),
        ref=dict(decoder="uf-matrix"))
    add("BeliefFindDecoder[peeling]",
        lambda: BeliefFindDecoder(hx, uf_method="peeling", **common),
        ref=dict(decoder="uf-peel"))
    # standalone UF pays a batched GLOBAL elimination per growth round
    # (every lane, all n columns), where the reference only touches its
    # live local clusters — at p=0.01 the clusters are tiny, so the gap
    # vs the reference widens with n (toric d=20: n=800, 2.5x the d=13
    # flagship); the BP-fronted BeliefFind rows above amortise the same
    # kernel over far fewer residual lanes and stay >10x
    NOTE_UF_SCALE = (
        "standalone UF runs a batched global elimination per growth "
        "round (O(n) packed-word sweeps x all lanes) where the "
        "reference's union-find touches only its live local clusters; "
        "the per-syndrome gap therefore grows with code length on "
        "low-weight syndromes — an honest structural exception on "
        "codes beyond the d=13 flagship (where this row clears 10x)"
    )
    uf_scale_note = NOTE_UF_SCALE if n > 400 else None
    add("UnionFindDecoder[matrix]",
        lambda: UnionFindDecoder(hx, uf_method=True),
        ref=dict(decoder="uf-matrix-nobp"), note=uf_scale_note)
    add("UnionFindDecoder[peeling]",
        lambda: UnionFindDecoder(hx, uf_method=False),
        ref=dict(decoder="uf-peel-nobp", extra1=1.0),
        note=(NOTE_PEEL if uf_scale_note is None
              else NOTE_PEEL + "; " + NOTE_UF_SCALE),
        nb=1000)
    add("UnionFindDecoder[peeling-guided]",
        lambda: UnionFindDecoder(hx, uf_method=False),
        decode=lambda dec: (
            lambda: dec.decode_batch(syndromes[:8192], llrs=llr1,
                                     bits_per_step=1)
        ),
        ref=dict(decoder="uf-peel-nobp", extra1=1.0),
        note=NOTE_PEEL_GUIDED, nb=1000, bsz=8192, ref_reps=3)
    add("FlipDecoder", lambda: FlipDecoder(hx, max_iter=n),
        ref=dict(decoder="flip", max_iter=0), valid=False,
        note="greedy local flipping does not guarantee syndrome-valid "
             "output; decision parity vs the reference is bitwise "
             "(tests/test_ler_parity_aux.py)")
    add("BpFlipDecoder",
        lambda: BpFlipDecoder(hx, flip_iterations=0, **common),
        ref=dict(decoder="bpflip", extra1=0.0), valid=False,
        note=NOTE_BP)
    add("LsdDecoder[standalone-lsd0]",
        lambda: LsdDecoder(hx, lsd_method="lsd_0", lsd_order=0),
        decode=lambda dec: (lambda: dec.decode_batch(syndromes, llr1)),
        ref=dict(decoder="lsd-nobp", osd_method=-1, osd_order=0),
        note="standalone LSD grows one bit per cluster per round "
             "(reference default bits_per_step=1); the batched engine "
             "is bounded by the worst lane's round count, not "
             "arithmetic — an honest structural exception")
    add("SoftInfoBpDecoder",
        lambda: SoftInfoBpDecoder(
            hx, error_rate=ERROR_RATE, max_iter=MAX_ITER,
            ms_scaling_factor=1.0, cutoff=SOFT_CUTOFF, sigma=SOFT_SIGMA,
        ),
        decode=lambda dec: (
            lambda: dec.decode_batch(soft_syndromes[:16384])
        ),
        valid=False,
        ref=dict(decoder="softinfo", ms_factor=1.0, extra1=SOFT_CUTOFF,
                 extra2=SOFT_SIGMA),
        stdin=soft_input,
        note=("the reference algorithm is inherently bit-serial: its "
              "virtual-update rule (bp.hpp:547-665) makes every bit's "
              "update depend on the previous bit's in-place syndrome "
              "edits, so lanes are the only parallel axis; this row "
              "demonstrates parity (~1x), and beating it would mean "
              "abandoning the reference's serial semantics"),
        nb=1000, bsz=16384, ref_reps=3)
    if Hgf4 is not None:
        add("MbpDecoder",
            lambda: MbpDecoder(
                Hgf4=Hgf4, error_channel=ch3, max_iter=MAX_ITER,
                alpha_parameter=1.0, beta_parameter=0.0,
                bp_method="min_sum", gamma_parameter=MS_FACTOR,
            ),
            decode=lambda dec: (lambda: dec.decode_batch(mbp_syn)),
            valid=False,
            ref=dict(decoder="mbp", extra1=1.0, extra2=0.0),
            stdin=mbp_input,
            note="GF(4) decoding: binary-H validity does not apply; "
                 "decision parity vs the reference is pinned by "
                 "tests/test_ler_parity_aux.py",
            nb=500, bsz=mbp_batch, ref_reps=3)

    for v in variants:
        if only and only not in v["name"]:
            continue
        name = v["name"]
        try:
            dec = v["build"]()
            call = (v["decode"](dec) if v["decode"] else std_decode(dec))
            out = np.asarray(call())  # warmup/compile
            call()  # settle: adaptive-bucket hints learned during the
            # warmup can grow the jitted program's compaction buckets,
            # triggering ONE recompile on the next call — absorb it here
            # so a 10+ s compile never lands inside a timed rep
            valid = True
            if v["valid"]:
                bsz = min(v["bsz"], 4096)
                valid = bool(
                    ((out[:bsz] @ H.T) % 2 == syndromes[:bsz]).all()
                )
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                call()
                times.append(time.perf_counter() - t0)
            times.sort()
            rate = v["bsz"] / times[len(times) // 2]
            rate_best = v["bsz"] / times[0]
            rec = {
                "decoder": name,
                "workload": workload,
                "rate": round(rate, 1),
                "rate_best": round(rate_best, 1),
                "unit": "syndromes/s",
                "batch": v["bsz"],
                "backend": jax.default_backend(),
            }
            if v["valid"]:  # rows without validity semantics omit the key
                rec["valid"] = bool(valid)
            if v["note"]:
                rec["note"] = v["note"]
            if have_ref and v["ref"] is not None:
                cfg = dict(max_iter=MAX_ITER, ms_factor=MS_FACTOR)
                cfg.update(v["ref"])
                nb = v["nb"]
                base = None
                err = None
                while nb >= 125:
                    try:
                        base = rb.best_rate(
                            v["stdin"](nb), nb, reps=v["ref_reps"],
                            timeout=600, **cfg
                        )
                        break
                    except Exception as exc:
                        err = str(exc)[:120]
                        nb //= 2
                if base is not None:
                    rec["baseline"] = round(base, 1)
                    rec["baseline_syndromes"] = nb
                    rec["vs_matched_baseline"] = round(rate / base, 2)
                    rec["vs_matched_baseline_best"] = round(
                        rate_best / base, 2
                    )
                else:
                    rec["baseline_error"] = err
            print(json.dumps(rec), flush=True)
        except Exception as exc:  # keep the sweep going
            import traceback

            print(
                json.dumps({
                    "decoder": name,
                    "error": str(exc)[:200] or repr(exc)[:200],
                    "error_tail": traceback.format_exc()[-200:],
                }),
                flush=True,
            )


if __name__ == "__main__":
    main()
