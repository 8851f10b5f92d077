// Running per-row top-k lists of the single-pass PathSim top-k kernels
// (sm_90a): the merge of one score tile into a row's sorted best-k.
//
// Layout (tile_gemm.cuh): a row's BN columns of a score tile live in the
// 16 lanes of one half-warp, lane tx holding columns col0 + tx + 16 j.
// A row's list is sorted in the order of lax.top_k: descending value,
// then ascending column. An element enters the list only if it beats the
// list's k-th entry in that order (beats() below). After the first few
// tiles almost no element does, so the common case is one pass: each
// lane checks its 8 elements of a row (candidates(), independent
// compares) and one warp ballot per row says whether any could enter;
// only such rows take the merge, where the survivors are inserted one at
// a time by the row's half-warp.
//
// -inf entries (masked self pairs and padding columns) are ordinary
// elements of that order, so a row with fewer than k finite scores gets
// distinct -inf columns in ascending order, never a repeated index. A
// slot that no element has filled yet holds (-inf, INT_MAX), which every
// element beats.
#pragma once

#include <climits>
#include <math.h>

#include "tile_gemm.cuh"

namespace pathsim {

// (v, c) ranks before (ov, oc): larger value, or equal value and lower
// column.
__device__ __forceinline__ bool beats(float v, int c, float ov, int oc) {
    return v > ov || (v == ov && c < oc);
}

// The lanes of the calling thread's half-warp (the 16 lanes of one row).
__device__ __forceinline__ unsigned half_mask() {
    return (threadIdx.x & 16) ? 0xffff0000u : 0x0000ffffu;
}

// This half-warp's 16 bits of a warp ballot, lane 0 in bit 0.
__device__ __forceinline__ unsigned half_ballot(unsigned hmask, bool p) {
    return __ballot_sync(hmask, p) >> (threadIdx.x & 16);
}

// One row of a score tile, normalized and masked: s[j] holds the product
// m for column col0 + tx + 16 j on entry and its score on exit, -inf for
// columns >= n_true and for self_col. tv is the row's current k-th score.
//
// Prefilter: when tv is a positive normal number, an element with
// m < RN(RN(tv * c) * den), c = (1 - 2^-20) / 2, is set to -inf without
// being divided. Each rounding is within 2^-24 relative in the normal
// range (checked), so 2m / den < tv (1 - 2^-21), and its correctly
// rounded quotient is below tv: it could never enter the list, and -inf
// cannot either while tv > -inf. An element with m == 0 scores exactly
// +0 (normalize's value for any den), also without a division: this
// covers the rows whose bar is 0, such as zero-degree rows. Every other
// element gets the exact normalize(), so the lists, and the kernels'
// results, are exactly those of dividing every element.
__device__ __forceinline__ void score_row(float (&s)[TN], float di,
                                          const float (&dj)[TN], int col0,
                                          int self_col, int n_true,
                                          float tv) {
    const int tx = threadIdx.x & 15;
    const bool prune = tv >= 0x1p-100f && tv < INFINITY;
    const float bar = tv * (0.5f - 0x1p-21f);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const int gj = col0 + tx + 16 * j;
        const float den = di + dj[j];
        const float t = bar * den;
        if (gj >= n_true || gj == self_col || (prune && t >= 0x1p-125f &&
                                                s[j] < t))
            s[j] = -INFINITY;
        else if (s[j] != 0.0f)
            s[j] = normalize(s[j], den);
    }
}

// The elements of this lane's part of a row that beat (tv, tc), the
// row's current k-th entry, as a bit mask over j: if no lane has one,
// the row's list is final for this tile.
__device__ __forceinline__ unsigned candidates(const float (&s)[TN],
                                               int col0, float tv, int tc) {
    const int tx = threadIdx.x & 15;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j)
        bits |= (unsigned)beats(s[j], col0 + tx + 16 * j, tv, tc) << j;
    return bits;
}

// s[j] for a j known only at run time, without indexing the register
// array (which would move it to local memory).
__device__ __forceinline__ float pick(const float (&s)[TN], int j) {
    float x = s[0];
#pragma unroll
    for (int q = 1; q < TN; ++q) x = (q == j) ? s[q] : x;
    return x;
}

// Merge one row's tile scores into its top-k held in registers, one slot
// per lane (lane t holds slot t; k <= 16). s[j] is column col0 + tx + 16 j.
// Only the column groups j where some lane has a candidate are visited,
// in ascending j; within a group, candidates go in lane order.
__device__ __forceinline__ void merge_tile_regs(const float (&s)[TN],
                                                int col0, int k,
                                                unsigned hmask, float& lv,
                                                int& lc) {
    const int tx = threadIdx.x & 15;
    float tv = __shfl_sync(hmask, lv, k - 1, 16);
    int tc = __shfl_sync(hmask, lc, k - 1, 16);
    const unsigned cand = candidates(s, col0, tv, tc);
    unsigned groups = __reduce_or_sync(hmask, cand);
    while (groups) {  // uniform across the half-warp from here on
        const int j = __ffs(groups) - 1;
        groups &= groups - 1;
        const float x = pick(s, j);
        const int cj = col0 + 16 * j;  // column of lane 0's element j
        unsigned m = half_ballot(hmask, (cand >> j) & 1u);
        while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float v = __shfl_sync(hmask, x, src, 16);
            const int c = cj + src;
            if (!beats(v, c, tv, tc)) continue;  // an insertion raised the bar
            const int pos = __popc(
                half_ballot(hmask, tx < k && beats(lv, lc, v, c)));
            const float uv = __shfl_up_sync(hmask, lv, 1, 16);
            const int uc = __shfl_up_sync(hmask, lc, 1, 16);
            if (tx > pos) {
                lv = uv;
                lc = uc;
            } else if (tx == pos) {
                lv = v;
                lc = c;
            }
            tv = __shfl_sync(hmask, lv, k - 1, 16);
            tc = __shfl_sync(hmask, lc, k - 1, 16);
        }
    }
}

// Merge one row's tile scores into its top-k kept in device memory at
// lv[0..k), lc[0..k) (any k >= 1; the row's slice of the output, owned
// by this half-warp alone). (tv, tc) holds the list's k-th entry on entry
// and on exit. __syncwarp orders the lanes' accesses.
__device__ __forceinline__ void merge_tile_mem(const float (&s)[TN],
                                               int col0, int k,
                                               unsigned hmask,
                                               float* __restrict__ lv,
                                               int* __restrict__ lc,
                                               float& tv, int& tc) {
    const int tx = threadIdx.x & 15;
    const unsigned cand = candidates(s, col0, tv, tc);
    unsigned groups = __reduce_or_sync(hmask, cand);
    while (groups) {
        const int j = __ffs(groups) - 1;
        groups &= groups - 1;
        const float x = pick(s, j);
        const int cj = col0 + 16 * j;
        unsigned m = half_ballot(hmask, (cand >> j) & 1u);
        while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float v = __shfl_sync(hmask, x, src, 16);
            const int c = cj + src;
            if (!beats(v, c, tv, tc)) continue;
            // Its slot: the number of entries that beat it (a prefix of
            // the sorted list), counted 16 entries at a time.
            int pos = 0;
            for (int base = 0; base < k; base += 16) {
                const int e = base + tx;
                const int cnt = __popc(
                    half_ballot(hmask, e < k && beats(lv[e], lc[e], v, c)));
                pos += cnt;
                if (cnt < 16) break;
            }
            // Shift slots pos .. k-2 up by one, the highest 16 first: each
            // round reads below what the previous round wrote.
            for (int top = k - 1; top > pos; top -= 16) {
                const int dst = top - tx;
                const bool moves = dst > pos;
                float mv = 0.0f;
                int mc = 0;
                if (moves) {
                    mv = lv[dst - 1];
                    mc = lc[dst - 1];
                }
                __syncwarp(hmask);
                if (moves) {
                    lv[dst] = mv;
                    lc[dst] = mc;
                }
                __syncwarp(hmask);
            }
            if (tx == 0) {
                lv[pos] = v;
                lc[pos] = c;
            }
            __syncwarp(hmask);
            tv = lv[k - 1];
            tc = lc[k - 1];
        }
    }
}

}  // namespace pathsim
