// Native batch classifier scoring — the sequential-phase hot path.
//
// The accumulate phase issues thousands of latency-sensitive scoring calls
// (one per mean-shift step); a device dispatch per call would stall there,
// so those calls run on host through this scorer, while large batched
// phases go to the device.
//
// Two paths, both with exact float64 reference semantics on the decision:
//  - FUSED: one pass over the two count rows accumulates integer sufficient
//    statistics (sum-min, dot, EMD, optional log sums), and every derivable
//    feature (manhattan/euclidean/intersection/kulczynski2/simratio/
//    normalized_vectors/pearson/d2z/euclidean_z/length) comes from them plus
//    per-point precomputed moments.  Derived values can differ from the
//    reference's sequential loops in the last ulps, so borderline decisions
//    (probability near a rounding threshold, dist near the window max) are
//    recomputed with the EXACT per-feature loops.
//  - EXACT: formula-faithful per-feature loops matching Feature.cpp's
//    accumulation order bit-for-bit.
//
// The machinery lives in score_impl.h (shared with accumulate.cpp, the
// full accumulate-phase driver); this file is the ctypes entry points.
//
// Counts are stored at the narrowest width that holds the histogram dtype
// (uint8 histograms stream 4x less memory than uint32).
// Feature ids are log2 of the FEAT_* bit flags (Feature.h:31-64).
#include "score_impl.h"

namespace {

using mc2::ModelSpec;
using mc2::PointsView;
using mc2::ScorePlan;

template <typename T>
int score_block_t(const T* counts, const int64_t* mags, const int64_t* lengths,
                  const double* stddevs, const double* self_dots, int64_t dim,
                  const int64_t* a_rows, const int64_t* b_rows, int64_t n_pairs,
                  const ModelSpec& m, double* out_prob, double* out_dist) {
    PointsView<T> v{counts, mags, lengths, stddevs, self_dots, dim};
    ScorePlan<T> plan;
    if (!plan.build(m, self_dots)) return -1;
    mc2::score_pairs(v, m, plan, a_rows, b_rows, /*b_stride=*/1, n_pairs,
                     out_prob, out_dist);
    return 0;
}

}  // namespace

extern "C" {

// Widest SIMD path this build compiled: 512 (AVX-512 BW+VNNI fused
// min/dot/EMD kernels), 2 (AVX2 kernels) or 0 (scalar).
int mc2_simd_level() {
#if defined(MC2_FUSED512)
    return 512;
#elif defined(__AVX2__)
    return 2;
#else
    return 0;
#endif
}

// Returns 0 on success, -1 if a feature id is unsupported.
int supports_features(const int32_t* ids, int32_t n) {
    for (int32_t i = 0; i < n; i++)
        if (!mc2::dispatch<uint32_t>(ids[i])) return -1;
    return 0;
}

// elem_width: 1, 2 or 4 (bytes per count)
int score_block(
    const void* counts, int32_t elem_width, const int64_t* mags,
    const int64_t* lengths, const double* stddevs, const double* self_dots,
    int64_t dim,
    const int64_t* a_rows, const int64_t* b_rows, int64_t n_pairs,
    const int32_t* single_ids, const double* mins, const double* maxs,
    const uint8_t* is_sim, int32_t n_singles,
    const int32_t* combo_kinds, const int32_t* combo_idx0,
    const int32_t* combo_idx1, int32_t n_combos,
    const double* weights, double bias, int32_t raw_sum,
    double* out_prob, double* out_dist) {
    ModelSpec m{single_ids, mins, maxs, is_sim, n_singles,
                combo_kinds, combo_idx0, combo_idx1, n_combos, weights, bias,
                raw_sum};
    switch (elem_width) {
        case 1:
            return score_block_t<uint8_t>((const uint8_t*)counts, mags, lengths,
                                          stddevs, self_dots, dim, a_rows,
                                          b_rows, n_pairs, m, out_prob, out_dist);
        case 2:
            return score_block_t<uint16_t>((const uint16_t*)counts, mags, lengths,
                                           stddevs, self_dots, dim, a_rows,
                                           b_rows, n_pairs, m, out_prob, out_dist);
        case 4:
            return score_block_t<uint32_t>((const uint32_t*)counts, mags, lengths,
                                           stddevs, self_dots, dim, a_rows,
                                           b_rows, n_pairs, m, out_prob, out_dist);
        default:
            return -1;
    }
}

// Raw single-feature values with the reference's accumulation order, for
// the training tables (Feature.cpp loop-order parity feeds the byte-exact
// weights.txt seam).
int raw_singles(
    const void* counts, int32_t elem_width, const int64_t* mags,
    const int64_t* lengths, const double* stddevs, int64_t dim,
    const int64_t* a_rows, const int64_t* b_rows, int64_t n_pairs,
    const int32_t* single_ids, int32_t n_singles, double* out /* [P,S] */) {
    if (elem_width != 1 && elem_width != 2 && elem_width != 4) return -1;
#define RAW_BODY(T)                                                         \
    {                                                                       \
        mc2::feat_fn<T> fns[64];                                            \
        for (int32_t s = 0; s < n_singles; s++) {                           \
            fns[s] = mc2::dispatch<T>(single_ids[s]);                       \
            if (!fns[s]) return -1;                                         \
        }                                                                   \
        PointsView<T> v{(const T*)counts, mags, lengths, stddevs, nullptr,  \
                        dim};                                               \
        _Pragma("omp parallel for schedule(dynamic, 16)")                   \
        for (int64_t p = 0; p < n_pairs; p++)                               \
            for (int32_t s = 0; s < n_singles; s++)                         \
                out[p * n_singles + s] = fns[s](v, a_rows[p], b_rows[p]);   \
    }
    switch (elem_width) {
        case 1: RAW_BODY(uint8_t); break;
        case 2: RAW_BODY(uint16_t); break;
        default: RAW_BODY(uint32_t); break;
    }
#undef RAW_BODY
    return 0;
}

// Batched mean-shift closest-to-mean selection (ClusterFactory.cpp:337-380 /
// 287-335): for each segment of member rows, compute the float64 mean
// histogram and return the first member minimizing distance_d
// (DivergencePoint.cpp:54-66 with its truncating uint64 mag accumulation).
int mean_shift_argmin(
    const void* counts, int32_t elem_width, const int64_t* mags, int64_t dim,
    const int64_t* member_rows, const int64_t* seg_offsets, int64_t n_segs,
    int64_t* out_rows) {
#pragma omp parallel
    {
        double* top = new double[dim];
#pragma omp for schedule(dynamic, 4)
        for (int64_t g = 0; g < n_segs; g++) {
            int64_t s = seg_offsets[g], e = seg_offsets[g + 1];
            if (e <= s) {
                out_rows[g] = -1;
                continue;
            }
            for (int64_t i = 0; i < dim; i++) top[i] = 0.0;
            for (int64_t j = s; j < e; j++) {
                int64_t r = member_rows[j];
                if (elem_width == 1) {
                    const uint8_t* row = (const uint8_t*)counts + r * dim;
                    for (int64_t i = 0; i < dim; i++) top[i] += row[i];
                } else if (elem_width == 2) {
                    const uint16_t* row = (const uint16_t*)counts + r * dim;
                    for (int64_t i = 0; i < dim; i++) top[i] += row[i];
                } else {
                    const uint32_t* row = (const uint32_t*)counts + r * dim;
                    for (int64_t i = 0; i < dim; i++) top[i] += row[i];
                }
            }
            double n = (double)(e - s);
            for (int64_t i = 0; i < dim; i++) top[i] /= n;
            // round(top) once (same for every member)
            double best = 1e300;
            int64_t best_row = -1;
            for (int64_t j = s; j < e; j++) {
                int64_t r = member_rows[j];
                uint64_t dist = 0;
                uint64_t mag = 0;
                if (elem_width == 1) {
                    const uint8_t* row = (const uint8_t*)counts + r * dim;
                    for (int64_t i = 0; i < dim; i++) {
                        double rt = std::floor(top[i] + 0.5);
                        double cv = (double)row[i];
                        dist += 2 * (uint64_t)std::min(cv, rt);
                        mag += (uint64_t)(cv + top[i]);
                    }
                } else if (elem_width == 2) {
                    const uint16_t* row = (const uint16_t*)counts + r * dim;
                    for (int64_t i = 0; i < dim; i++) {
                        double rt = std::floor(top[i] + 0.5);
                        double cv = (double)row[i];
                        dist += 2 * (uint64_t)std::min(cv, rt);
                        mag += (uint64_t)(cv + top[i]);
                    }
                } else {
                    const uint32_t* row = (const uint32_t*)counts + r * dim;
                    for (int64_t i = 0; i < dim; i++) {
                        double rt = std::floor(top[i] + 0.5);
                        double cv = (double)row[i];
                        dist += 2 * (uint64_t)std::min(cv, rt);
                        mag += (uint64_t)(cv + top[i]);
                    }
                }
                double frac = (double)dist / (double)mag;
                double d = 10000.0 * (1.0 - frac * frac);
                if (best_row < 0 || d < best) {
                    best = d;
                    best_row = r;
                }
            }
            out_rows[g] = best_row;
        }
        delete[] top;
    }
    return 0;
}

}  // extern "C"
