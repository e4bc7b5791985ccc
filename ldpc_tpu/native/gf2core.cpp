// Host-side packed GF(2) core.
//
// The reference backs its mod2 toolbox with header-only C++ eliminations
// (reference: src_cpp/gf2dense.hpp, gf2sparse_linalg.hpp). This is the
// framework's native equivalent for the host/setup-time path: rows
// are packed 64 columns per uint64 word and eliminated with word-wide
// XORs. Loaded via ctypes by ldpc_tpu.mod2._gf2core with a pure-numpy
// fallback when the shared library has not been built.
//
// Semantics mirror _gf2core.packed_row_reduce exactly (same pivot choice
// and row swaps) so the two backends produce identical outputs.
#include <cstdint>
#include <cstring>
#include <chrono>
#include <random>

extern "C" {

// In-place Gaussian elimination over packed rows.
//   rows:      m x W uint64, row-major, bit j of the matrix at word j/64
//              bit j%64 (LSB first)
//   full:      1 -> reduced row echelon (eliminate above pivots too)
//   stop_rank: stop after this many pivots (-1 = no limit)
//   col_order: processing order of columns (NULL = 0..n-1), length n
//   pivot_cols: out buffer (length >= n), filled with pivot columns
//   row_perm:   out buffer (length m), final original-row order
// Returns the rank.
int gf2_row_reduce(uint64_t *rows, int m, int W, int n, int full,
                   int stop_rank, const int *col_order, int *pivot_cols,
                   int *row_perm) {
    for (int i = 0; i < m; i++) row_perm[i] = i;
    int rank = 0;
    for (int jj = 0; jj < n; jj++) {
        if (rank == m || (stop_rank >= 0 && rank >= stop_rank)) break;
        const int j = col_order ? col_order[jj] : jj;
        const int w = j >> 6;
        const uint64_t bit = 1ull << (j & 63);
        int piv = -1;
        for (int i = rank; i < m; i++) {
            if (rows[(size_t)i * W + w] & bit) { piv = i; break; }
        }
        if (piv < 0) continue;
        if (piv != rank) {
            for (int t = 0; t < W; t++) {
                uint64_t tmp = rows[(size_t)rank * W + t];
                rows[(size_t)rank * W + t] = rows[(size_t)piv * W + t];
                rows[(size_t)piv * W + t] = tmp;
            }
            int tp = row_perm[rank];
            row_perm[rank] = row_perm[piv];
            row_perm[piv] = tp;
        }
        const uint64_t *prow = rows + (size_t)rank * W;
        const int start = full ? 0 : rank + 1;
        for (int i = start; i < m; i++) {
            if (i == rank) continue;
            if (rows[(size_t)i * W + w] & bit) {
                uint64_t *r = rows + (size_t)i * W;
                for (int t = 0; t < W; t++) r[t] ^= prow[t];
            }
        }
        pivot_cols[rank] = j;
        rank++;
    }
    return rank;
}

// Randomized minimum-distance search over ker-basis combinations
// (reference: gf2dense.hpp:522-654). Each basis word joins a sample with
// probability min(1, 2/k). Runs until timeout_ms elapsed; returns the
// number of samples searched and writes the best weight and up to
// n_save lightest distinct words (packed) into saved (n_save x W).
long long gf2_estimate_distance(const uint64_t *basis, int k, int W,
                                double timeout_ms, uint64_t seed,
                                int *min_weight, uint64_t *saved,
                                int *saved_weights, int n_save) {
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uni(0.0, 1.0);
    const double p = k > 0 ? (2.0 < (double)k ? 2.0 / k : 1.0) : 0.0;
    auto t0 = std::chrono::steady_clock::now();
    long long samples = 0;
    uint64_t *word = new uint64_t[W];
    int worst = *min_weight;  // current saved-list cutoff
    while (true) {
        double el = std::chrono::duration<double, std::milli>(
                        std::chrono::steady_clock::now() - t0)
                        .count();
        if (el >= timeout_ms) break;
        std::memset(word, 0, sizeof(uint64_t) * W);
        for (int i = 0; i < k; i++) {
            if (uni(rng) < p) {
                const uint64_t *b = basis + (size_t)i * W;
                for (int t = 0; t < W; t++) word[t] ^= b[t];
            }
        }
        samples++;
        int wgt = 0;
        for (int t = 0; t < W; t++) wgt += __builtin_popcountll(word[t]);
        if (wgt == 0) continue;
        if (wgt < *min_weight) *min_weight = wgt;
        // fill an empty saved slot, else replace the heaviest if lighter
        // (weight 0 marks an empty slot)
        int slot = -1, hw = -1;
        for (int s = 0; s < n_save; s++) {
            if (saved_weights[s] == 0) { slot = s; break; }
            if (saved_weights[s] > hw) { hw = saved_weights[s]; slot = s; }
        }
        if (slot >= 0 && (saved_weights[slot] == 0 || wgt < hw)) {
            bool dup = false;
            for (int s = 0; s < n_save && !dup; s++) {
                if (saved_weights[s] == wgt &&
                    std::memcmp(saved + (size_t)s * W, word,
                                sizeof(uint64_t) * W) == 0)
                    dup = true;
            }
            if (!dup) {
                std::memcpy(saved + (size_t)slot * W, word,
                            sizeof(uint64_t) * W);
                saved_weights[slot] = wgt;
            }
        }
        (void)worst;
    }
    delete[] word;
    return samples;
}

}  // extern "C"
