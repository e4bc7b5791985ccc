// Reference-baseline benchmark driver.
//
// Measures the reference C++ BP(+OSD) decoder's single-core throughput on
// this machine by #including the reference headers (mounted read-only at
// -I <reference>/src_cpp). This file is a *driver* of the reference, not
// part of the new framework's decode path — the framework never links
// against it; bench.py compiles and runs it to compute `vs_baseline`.
//
// stdin:  m n
//         m rows of n 0/1 ints        (parity-check matrix, dense)
//         n doubles                    (error channel)
//         num_syndromes
//         num_syndromes rows of m 0/1 ints
// argv:   max_iter ms_scaling_factor osd_method(-1 off,0,1=E,2=CS) osd_order
//         [dump_decodings(0|1)]
//         [decoder: osd|lsd|uf-peel|uf-matrix|uf-peel-nobp|uf-matrix-nobp|
//                   flip|softinfo|mbp]
//         [extra1 extra2]  (per-mode: flip -> pfreq seed;
//                           softinfo -> cutoff sigma; mbp -> alpha beta)
// stdout: one line: "decoded <N> syndromes in <seconds> s"; with dump=1,
//         followed by one 0/1 line per syndrome (the reference decoding —
//         used by the LER-parity tests to compare logical error rates).
// decoder=lsd runs BP then LsdDecoder (osd_method/osd_order become
// lsd_method/lsd_order); uf-* runs BP then UfDecoder peel/matrix decode
// guided by the BP posterior LLRs (the BeliefFindDecoder composition);
// uf-*-nobp runs the unguided standalone UfDecoder (no BP stage, the
// reference UnionFindDecoder composition); flip runs FlipDecoder alone
// (pfreq>0 selects p-flip); softinfo runs soft_info_decode_serial and
// reads the syndromes as doubles; mbp reads the matrix ints as GF(4)
// Pauli values (0-3), the channel as 3n doubles (X, Y, Z blocks), and
// runs the GF(4) mbp_decoder (min-sum, gamma = ms_scaling_factor).
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <iostream>
#include <vector>

#include "bp.hpp"
#include "osd.hpp"
#include "union_find.hpp"
// the reference's lsd.hpp reuses union_find.hpp's include guard (UF2_H),
// so it must be re-armed to get both decoders into one driver
#undef UF2_H
#include "lsd.hpp"
#include "flip.hpp"
#include "mbp.hpp"

int main(int argc, char **argv) {
    int max_iter = argc > 1 ? std::atoi(argv[1]) : 30;
    double ms_factor = argc > 2 ? std::atof(argv[2]) : 0.625;
    int osd_method_i = argc > 3 ? std::atoi(argv[3]) : 0;
    int osd_order = argc > 4 ? std::atoi(argv[4]) : 0;
    bool dump = argc > 5 ? std::atoi(argv[5]) != 0 : false;
    const char *which = argc > 6 ? argv[6] : "osd";
    double extra1 = argc > 7 ? std::atof(argv[7]) : 0.0;
    double extra2 = argc > 8 ? std::atof(argv[8]) : 0.0;
    bool is_mbp = !std::strcmp(which, "mbp");
    bool is_soft = !std::strcmp(which, "softinfo");

    int m, n;
    std::cin >> m >> n;
    auto pcm = ldpc::bp::BpSparse(m, n);
    auto *gf4 = is_mbp ? new mbp_sparse(m, n) : nullptr;
    for (int i = 0; i < m; i++)
        for (int j = 0; j < n; j++) {
            int v;
            std::cin >> v;
            if (v) {
                pcm.insert_entry(i, j);
                if (is_mbp) gf4->insert_entry(i, j, (uint8_t)v);
            }
        }
    std::vector<std::vector<double>> channel3;
    std::vector<double> channel(n);
    if (is_mbp) {
        channel3.assign(3, std::vector<double>(n));
        for (int w = 0; w < 3; w++)
            for (int j = 0; j < n; j++) std::cin >> channel3[w][j];
    } else {
        for (int j = 0; j < n; j++) std::cin >> channel[j];
    }
    int num;
    std::cin >> num;
    std::vector<std::vector<uint8_t>> syndromes;
    std::vector<std::vector<double>> soft_syndromes;
    if (is_soft) {
        soft_syndromes.assign(num, std::vector<double>(m));
        for (int s = 0; s < num; s++)
            for (int i = 0; i < m; i++) std::cin >> soft_syndromes[s][i];
    } else {
        syndromes.assign(num, std::vector<uint8_t>(m));
        for (int s = 0; s < num; s++)
            for (int i = 0; i < m; i++) {
                int v;
                std::cin >> v;
                syndromes[s][i] = (uint8_t)v;
            }
    }

    if (is_mbp) {
        std::vector<std::vector<double>> alpha(
            3, std::vector<double>(n, extra1 > 0 ? extra1 : 1.0));
        mbp_decoder mbp(gf4, channel3, max_iter, alpha, extra2,
                                   1 /*min-sum*/, ms_factor);
        long long checksum = 0;
        std::vector<std::vector<uint8_t>> decodings;
        if (dump) decodings.resize(num);
        auto t0 = std::chrono::steady_clock::now();
        for (int s = 0; s < num; s++) {
            mbp.decode(syndromes[s]);
            for (auto v : mbp.decoding) checksum += v;
            if (dump)
                decodings[s].assign(mbp.decoding.begin(), mbp.decoding.end());
        }
        auto t1 = std::chrono::steady_clock::now();
        double secs = std::chrono::duration<double>(t1 - t0).count();
        std::printf("decoded %d syndromes in %.6f s (checksum %lld)\n", num,
                    secs, checksum);
        if (dump)
            for (int s = 0; s < num; s++) {
                for (int j = 0; j < n; j++)
                    std::putchar('0' + decodings[s][j]);  // GF(4) digits
                std::putchar('\n');
            }
        return 0;
    }

    if (!std::strcmp(which, "flip")) {
        int pfreq = (int)extra1;
        int seed = extra2 != 0 ? (int)extra2 : 1;
        ldpc::flip::FlipDecoder flip(pcm, max_iter, pfreq, seed);
        long long checksum = 0;
        std::vector<std::vector<uint8_t>> decodings;
        if (dump) decodings.resize(num);
        auto t0 = std::chrono::steady_clock::now();
        for (int s = 0; s < num; s++) {
            auto &out = flip.decode(syndromes[s]);
            for (auto v : out) checksum += v;
            if (dump) decodings[s].assign(out.begin(), out.end());
        }
        auto t1 = std::chrono::steady_clock::now();
        double secs = std::chrono::duration<double>(t1 - t0).count();
        std::printf("decoded %d syndromes in %.6f s (checksum %lld)\n", num,
                    secs, checksum);
        if (dump)
            for (int s = 0; s < num; s++) {
                for (int j = 0; j < n; j++)
                    std::putchar(decodings[s][j] ? '1' : '0');
                std::putchar('\n');
            }
        return 0;
    }

    if (!std::strcmp(which, "bpflip")) {
        // reference BpFlipDecoder composition (_bp_flip.pyx:44-61):
        // flip decode, BP on the residual syndrome, XOR the decodings
        int flip_iters = (int)extra1;
        int seed = extra2 != 0 ? (int)extra2 : 1;
        ldpc::flip::FlipDecoder flip(pcm, flip_iters, 0, seed);
        ldpc::bp::BpDecoder bpd(pcm, channel, max_iter,
                                ldpc::bp::MINIMUM_SUM, ldpc::bp::PARALLEL,
                                ms_factor);
        long long checksum = 0;
        std::vector<std::vector<uint8_t>> decodings;
        if (dump) decodings.resize(num);
        std::vector<uint8_t> residual(m);
        auto t0 = std::chrono::steady_clock::now();
        for (int s = 0; s < num; s++) {
            auto &fd = flip.decode(syndromes[s]);
            auto fs = pcm.mulvec(fd);
            for (int i = 0; i < m; i++)
                residual[i] = syndromes[s][i] ^ fs[i];
            bpd.decode(residual);
            if (dump) decodings[s].resize(n);
            for (int j = 0; j < n; j++) {
                uint8_t v = bpd.decoding[j] ^ fd[j];
                checksum += v;
                if (dump) decodings[s][j] = v;
            }
        }
        auto t1 = std::chrono::steady_clock::now();
        double secs = std::chrono::duration<double>(t1 - t0).count();
        std::printf("decoded %d syndromes in %.6f s (checksum %lld)\n", num,
                    secs, checksum);
        if (dump)
            for (int s = 0; s < num; s++) {
                for (int j = 0; j < n; j++)
                    std::putchar(decodings[s][j] ? '1' : '0');
                std::putchar('\n');
            }
        return 0;
    }

    if (!std::strcmp(which, "lsd-nobp")) {
        // reference standalone LsdDecoder (_lsd_decoder.pyx:129-175):
        // lsd_decode directly, channel llrs as the bit weights
        ldpc::lsd::LsdDecoder lsd(
            pcm, static_cast<ldpc::osd::OsdMethod>(osd_method_i + 1),
            osd_order);
        std::vector<double> llrs(n);
        for (int j = 0; j < n; j++)
            llrs[j] = std::log((1.0 - channel[j]) / channel[j]);
        long long checksum = 0;
        std::vector<std::vector<uint8_t>> decodings;
        if (dump) decodings.resize(num);
        auto t0 = std::chrono::steady_clock::now();
        for (int s = 0; s < num; s++) {
            const auto &out = lsd.lsd_decode(syndromes[s], llrs, 1, true);
            for (auto v : out) checksum += v;
            if (dump) decodings[s].assign(out.begin(), out.end());
        }
        auto t1 = std::chrono::steady_clock::now();
        double secs = std::chrono::duration<double>(t1 - t0).count();
        std::printf("decoded %d syndromes in %.6f s (checksum %lld)\n", num,
                    secs, checksum);
        if (dump)
            for (int s = 0; s < num; s++) {
                for (int j = 0; j < n; j++)
                    std::putchar(decodings[s][j] ? '1' : '0');
                std::putchar('\n');
            }
        return 0;
    }

    if (is_soft) {
        double cutoff = extra1;
        double sigma = extra2 > 0 ? extra2 : 1.0;
        ldpc::bp::BpDecoder bpd(pcm, channel, max_iter,
                                ldpc::bp::MINIMUM_SUM, ldpc::bp::SERIAL,
                                ms_factor);
        long long checksum = 0;
        std::vector<std::vector<uint8_t>> decodings;
        if (dump) decodings.resize(num);
        auto t0 = std::chrono::steady_clock::now();
        for (int s = 0; s < num; s++) {
            auto &out =
                bpd.soft_info_decode_serial(soft_syndromes[s], cutoff, sigma);
            for (auto v : out) checksum += v;
            if (dump) decodings[s].assign(out.begin(), out.end());
        }
        auto t1 = std::chrono::steady_clock::now();
        double secs = std::chrono::duration<double>(t1 - t0).count();
        std::printf("decoded %d syndromes in %.6f s (checksum %lld)\n", num,
                    secs, checksum);
        if (dump)
            for (int s = 0; s < num; s++) {
                for (int j = 0; j < n; j++)
                    std::putchar(decodings[s][j] ? '1' : '0');
                std::putchar('\n');
            }
        return 0;
    }

    if (!std::strcmp(which, "uf-peel-nobp") ||
        !std::strcmp(which, "uf-matrix-nobp")) {
        bool peel = !std::strcmp(which, "uf-peel-nobp");
        // extra1 != 0: growth guided by the channel llrs with
        // bits_per_step=1 (the reference guided composition,
        // union_find.hpp:431-483) — unlike the unguided peel this
        // terminates on every syndrome, giving an unbiased baseline
        bool guided = extra1 != 0;
        std::vector<double> llrs(n);
        for (int j = 0; j < n; j++)
            llrs[j] = std::log((1.0 - channel[j]) / channel[j]);
        ldpc::uf::UfDecoder uf(pcm);
        long long checksum = 0;
        std::vector<std::vector<uint8_t>> decodings;
        if (dump) decodings.resize(num);
        auto t0 = std::chrono::steady_clock::now();
        for (int s = 0; s < num; s++) {
            const auto &out =
                peel ? (guided ? uf.peel_decode(syndromes[s], llrs, 1)
                               : uf.peel_decode(syndromes[s]))
                     : (guided ? uf.matrix_decode(syndromes[s], llrs, 1)
                               : uf.matrix_decode(syndromes[s]));
            for (auto v : out) checksum += v;
            if (dump) decodings[s].assign(out.begin(), out.end());
        }
        auto t1 = std::chrono::steady_clock::now();
        double secs = std::chrono::duration<double>(t1 - t0).count();
        std::printf("decoded %d syndromes in %.6f s (checksum %lld)\n", num,
                    secs, checksum);
        if (dump)
            for (int s = 0; s < num; s++) {
                for (int j = 0; j < n; j++)
                    std::putchar(decodings[s][j] ? '1' : '0');
                std::putchar('\n');
            }
        return 0;
    }

    ldpc::bp::BpDecoder bpd(pcm, channel, max_iter, ldpc::bp::MINIMUM_SUM,
                            ldpc::bp::PARALLEL, ms_factor);
    ldpc::osd::OsdDecoder *osd = nullptr;
    ldpc::lsd::LsdDecoder *lsd = nullptr;
    ldpc::uf::UfDecoder *uf = nullptr;
    bool uf_peel = false;
    if (!std::strcmp(which, "lsd")) {
        lsd = new ldpc::lsd::LsdDecoder(
            pcm, static_cast<ldpc::osd::OsdMethod>(osd_method_i + 1),
            osd_order);
    } else if (!std::strncmp(which, "uf", 2)) {
        uf = new ldpc::uf::UfDecoder(pcm);
        uf_peel = !std::strcmp(which, "uf-peel");
    } else if (osd_method_i >= 0) {
        osd = new ldpc::osd::OsdDecoder(
            pcm, static_cast<ldpc::osd::OsdMethod>(osd_method_i + 1), osd_order,
            channel);
    }

    long long checksum = 0;
    std::vector<std::vector<uint8_t>> decodings;
    if (dump) decodings.resize(num);
    auto t0 = std::chrono::steady_clock::now();
    for (int s = 0; s < num; s++) {
        bpd.decode(syndromes[s]);
        const std::vector<uint8_t> *outp = &bpd.decoding;
        if (!bpd.converge) {
            if (lsd)
                outp = &lsd->lsd_decode(syndromes[s], bpd.log_prob_ratios, 1,
                                        true);
            else if (uf)
                outp = uf_peel ? &uf->peel_decode(syndromes[s],
                                                  bpd.log_prob_ratios, 1)
                               : &uf->matrix_decode(syndromes[s],
                                                    bpd.log_prob_ratios, 1);
            else if (osd)
                outp = (osd->decode(syndromes[s], bpd.log_prob_ratios),
                        &osd->osdw_decoding);
        }
        const std::vector<uint8_t> &out = *outp;
        for (auto v : out) checksum += v;
        if (dump) decodings[s].assign(out.begin(), out.end());
    }
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count();
    std::printf("decoded %d syndromes in %.6f s (checksum %lld)\n", num, secs,
                checksum);
    if (dump)
        for (int s = 0; s < num; s++) {
            for (int j = 0; j < n; j++)
                std::putchar(decodings[s][j] ? '1' : '0');
            std::putchar('\n');
        }
    return 0;
}
