// Per-row running top-k lists of K3 and K4 (sm_90a): the consumers' loop
// of a row block over a range of 64-column subtiles, and the merge of
// each subtile's scores into a row's sorted best-k.
//
// Layout (u8_tile.cuh): a consumer thread holds 2 rows of its
// warpgroup's 64 (warp 16 w + lane / 4, and 8 further), 16 columns of
// each, in the product's accumulator registers; a row's 64 columns lie
// in the 4 lanes of one quad. Selection reads them where they lie.
//
// A row's list is sorted in the order of lax.top_k: descending value,
// then ascending column. It lives wherever the kernel puts it (shared
// memory, or the row's slice of the output) and is reached through a
// generic pointer, so the same code serves any k >= 1. An element enters
// the list only if it beats the list's k-th entry in that order
// (beats()). After the first subtiles almost none does, so the common
// case is cheap: a coarse integer bound on the row part's largest count
// ends most rows' subtiles whole, an exact division-free test
// (stays_out()) the other elements, and one warp vote says whether any
// of the warp's rows has an element left to insert; only then do the
// quad's lanes insert their survivors, one lane at a time. The final
// list is the top-k of every element seen, in whatever order the
// insertions came, since beats() is a strict total order (columns are
// distinct).
//
// -inf entries (masked self pairs and padding columns) are ordinary
// elements of that order, so a row with fewer than k finite scores gets
// distinct -inf columns in ascending order, never a repeated index. A
// slot that no element has filled yet holds (-inf, INT_MAX), which every
// element beats.
#pragma once

#include <climits>
#include <math.h>

#include "tile_gemm.cuh"  // normalize(): K1's and K2's correctly rounded division
#include "u8_tile.cuh"

namespace pathsim {

// (v, c) ranks before (ov, oc): larger value, or equal value and lower
// column.
__device__ __forceinline__ bool beats(float v, int c, float ov, int oc) {
    return v > ov || (v == ov && c < oc);
}

// The accumulator slot of element j (0..15) of this thread's row h, and
// that element's column within the subtile.
__host__ __device__ constexpr int slot(int h, int j) {
    return 4 * (j >> 1) + 2 * h + (j & 1);
}
__device__ __forceinline__ int sub_col(int j) {
    return 8 * (j >> 1) + 2 * (threadIdx.x & 3) + (j & 1);
}

// One element's score: -inf for columns >= n_true and for self_col,
// else normalize(m, den), written out for m == 0 (+0 for any den,
// without a division).
__device__ __forceinline__ float score_elem(float m, float den, int gj,
                                            int self_col, int n_true) {
    if (gj >= n_true || gj == self_col) return -INFINITY;
    return m != 0.0f ? normalize(m, den) : 0.0f;
}

// Whether an element with f32 path count m and denominator den provably
// stays out of a list whose k-th entry is (tv, tc), tv finite, tc left
// of the element's column: its score is at most tv. That holds when
// m <= th * den in exact arithmetic, th = tv / 2 (exact: a power of
// two; then 2m / den <= tv, and so is its correctly rounded quotient; a
// score equal to tv loses the tie to the lower column tc). The test is
// exact: m is an f32, and th * den = hi + lo exactly, hi = RN(th * den),
// lo = fma(th, den, -hi) (exact while hi >= 2^-101: no underflow). m <
// hi implies m <= hi + lo (|lo| is at most half an ulp of hi, and m is
// an f32 below hi); m > hi implies m > hi + lo; at m == hi the sign of
// lo decides. th == 0 keeps out exactly m == 0. The caller checks the
// no-underflow condition once a row: hi >= RN(th * RN(di + dmin)) for
// every den of the subtile (RN is monotone, d >= 0).
__device__ __forceinline__ bool stays_out(float m, float den, float th) {
    const float hi = th * den;
    const float lo = fmaf(th, den, -hi);
    return m < hi || (m == hi && lo >= 0.0f);
}

// This consumer thread's two rows of the block at row0: local rows
// wg * 64 + 16 warp + lane / 4 (+ 8).
__device__ __forceinline__ int local_row(int h) {
    const int t = threadIdx.x;
    return (t / 128) * 64 + ((t % 128) / 32) * 16 + (t & 31) / 4 + 8 * h;
}

// What scoring needs beyond the products, uniform across the block: the
// column denominators (d(gj), 0 past the factor's n columns), the
// columns' end n_true, and the self column of this thread's row h, -1
// without the self mask: row_ids[row] (K3), or the row itself (K4,
// self_ids == nullptr). It is looked up only for the rare elements that
// are scored, so no thread keeps it in registers.
struct Ctx {
    const float* __restrict__ d_cols;
    const int* __restrict__ self_ids;
    int n, n_true, row0;
    bool mask_self;

    __device__ float d(int gj) const {
        return gj < n ? __ldg(d_cols + gj) : 0.0f;
    }
    __device__ int self(int h) const {
        const int row = row0 + local_row(h);
        return !mask_self ? -1 : self_ids ? self_ids[row] : row;
    }
};

// A row of a block: its list (k values at lv, their k columns lc_off
// 4-byte slots further on: one offset for every row of a kernel, so
// the column list costs no register of its own), denominator and
// whether it exists.
struct Row {
    float* lv;
    int lc_off;
    float di;
    bool valid;

    __device__ int* lc() const { return reinterpret_cast<int*>(lv) + lc_off; }
};

// Fill a row's k slots with (-inf, INT_MAX), the row's quad together.
__device__ __forceinline__ void list_init(const Row& r, int k) {
    if (r.valid)
        for (int e = threadIdx.x & 3; e < k; e += 4) {
            r.lv[e] = -INFINITY;
            r.lc()[e] = INT_MAX;
        }
}

// Copy a row's list to out_v / out_c, the row's quad together.
__device__ __forceinline__ void list_store(const Row& r, int k, float* out_v,
                                           int* out_c) {
    if (r.valid)
        for (int e = threadIdx.x & 3; e < k; e += 4) {
            out_v[e] = r.lv[e];
            out_c[e] = r.lc()[e];
        }
}

// x[slot(H, j)] for a j known only at run time (a select chain:
// indexing the register array would move it to local memory).
template <int H, typename T>
__device__ __forceinline__ T pick(const T (&x)[u8::ACC], int j) {
    T v = x[slot(H, 0)];
#pragma unroll
    for (int q = 1; q < 16; ++q) v = (q == j) ? x[slot(H, q)] : v;
    return v;
}

// The f32 of a path count: a single pair's s32 M converts exactly below
// 2^23 with two adds on the bits (2^23 + m has m as its mantissa),
// above by the correctly rounded conversion; the wide path's M is f32
// already.
template <bool AS_FLOAT>
__device__ __forceinline__ float m_f32(int m) {
    if (AS_FLOAT) return __int_as_float(m);
    float mf = __int_as_float(0x4B000000 | m) - 0x1p23f;
    if (m >= (1 << 23)) mf = __int2float_rn(m);
    return mf;
}

// Element j of row H, column gj: its exact score.
template <int H, bool AS_FLOAT>
__device__ __forceinline__ float elem_score(const int (&x)[u8::ACC],
                                            const Ctx& ctx, int j, int gj,
                                            const Row& r) {
    return score_elem(m_f32<AS_FLOAT>(pick<H>(x, j)), r.di + ctx.d(gj), gj,
                      ctx.self(H), ctx.n_true);
}

// Insert the elements of row H flagged in `bits` into its list, each
// only if it still beats the k-th entry (an earlier insertion may have
// raised it). One thread owns the list meanwhile.
template <int H, bool AS_FLOAT>
__device__ __forceinline__ void insert_row(const int (&x)[u8::ACC],
                                           const Ctx& ctx, int col0,
                                           unsigned bits, const Row& r,
                                           int k) {
    float* lv = r.lv;
    int* lc = r.lc();
    while (bits) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        const int c = col0 + sub_col(j);
        const float v = elem_score<H, AS_FLOAT>(x, ctx, j, c, r);
        if (!beats(v, c, lv[k - 1], lc[k - 1])) continue;
        int pos = k - 1;
        while (pos > 0 && beats(v, c, lv[pos - 1], lc[pos - 1])) {
            lv[pos] = lv[pos - 1];
            lc[pos] = lc[pos - 1];
            --pos;
        }
        lv[pos] = v;
        lc[pos] = c;
    }
}

// A row's k-th entry (tv, tc) for one subtile's selection, and whether
// the list is settled: tv is 0 or a normal finite number.
struct Bar {
    float tv;
    int tc;
    bool settled;  // and stays_out() holds exactly for every element
    bool small;    // every s32 M of the row part is below 2^23
};

// Whether row H's part of the subtile needs the per-element test, with
// its Bar. Once the row's list is settled, a coarse test on the row
// part's largest s32 M (15 integer max ops) first: with dlow = RN(di +
// dmin), dmin the least column denominator of the subtile, and Tc =
// RN(RN(tv * dlow) * (1 - 2^-22) / 2) <= tv * dlow / 2 <= tv * den / 2
// (RN is monotone, d >= 0, and the two roundings lose less than the
// 2^-22), every M <= floor(Tc) (below 2^24, so its f32 is exact) passes
// stays_out(), and the whole row part is done. Most rows of the Zipf
// head end here. The wide path (f32 M) skips this test.
template <int H, bool AS_FLOAT>
__device__ __forceinline__ bool needs_fine(const int (&x)[u8::ACC],
                                           float dmin, const Row& r, int k,
                                           Bar& b) {
    if (!r.valid) return false;
    b.tv = r.lv[k - 1];
    b.tc = r.lc()[k - 1];
    const float dlow = r.di + dmin;
    b.settled = b.tv == 0.0f || (b.tv >= 0x1p-100f && b.tv < INFINITY &&
                                 b.tv * 0.5f * dlow >= 0x1p-101f);
    int mx = x[slot(H, 0)];
#pragma unroll
    for (int j = 1; j < 16; ++j) mx = max(mx, x[slot(H, j)]);
    b.small = mx < (1 << 23);
    if (AS_FLOAT || !b.settled) return true;
    const float tcut = (b.tv * dlow) * (0.5f - 0x1p-23f);
    const int ti = b.tv == 0.0f        ? 1
                   : tcut < 0x1p-100f  ? 0
                   : tcut >= 0x1p24f   ? (1 << 24)
                                       : (int)tcut + 1;
    return mx >= ti;
}

// The elements of row H that beat its list's k-th entry: a bit per j.
// stays_out() on each element, without a division and without a branch
// (the 16 elements are independent work; dj holds this lane's column
// denominators), and only for the rest (rare once settled; every
// element while the list fills) the exact score and the comparison with
// the k-th entry.
template <int H, bool AS_FLOAT>
__device__ __forceinline__ unsigned row_candidates(const int (&x)[u8::ACC],
                                                   int col0,
                                                   const float (&dj)[16],
                                                   const Ctx& ctx,
                                                   const Row& r,
                                                   const Bar& b) {
    unsigned keep = 0xffffu;
    if (b.settled) {
        const float th = b.tv * 0.5f;
        keep = 0u;
        if (!AS_FLOAT && b.small) {  // the exact s32 -> f32 in two adds
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const float mf =
                    __int_as_float(0x4B000000 | x[slot(H, j)]) - 0x1p23f;
                keep |= (unsigned)!stays_out(mf, r.di + dj[j], th) << j;
            }
        } else {
#pragma unroll
            for (int j = 0; j < 16; ++j)
                keep |= (unsigned)!stays_out(m_f32<AS_FLOAT>(x[slot(H, j)]),
                                             r.di + dj[j], th) << j;
        }
    }
    unsigned bits = 0u;
    while (keep) {
        const int j = __ffs(keep) - 1;
        keep &= keep - 1;
        const int gj = col0 + sub_col(j);
        const float sc = elem_score<H, AS_FLOAT>(x, ctx, j, gj, r);
        bits |= (unsigned)beats(sc, gj, b.tv, b.tc) << j;
    }
    return bits;
}

// Score this thread's two rows of a subtile and merge them into the
// rows' lists. x holds M (s32, or f32 bits on the wide path).
template <bool AS_FLOAT>
__device__ __forceinline__ void select_rows(const int (&x)[u8::ACC],
                                            int col0, float dmin,
                                            const Ctx& ctx,
                                            const Row (&rows)[2], int k) {
    Bar b0, b1;
    const bool fine0 = needs_fine<0, AS_FLOAT>(x, dmin, rows[0], k, b0);
    const bool fine1 = needs_fine<1, AS_FLOAT>(x, dmin, rows[1], k, b1);
    unsigned cand0 = 0u, cand1 = 0u;
    if (fine0 || fine1) {
        // This lane's 16 column denominators, loaded together, once for
        // both rows.
        float dj[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) dj[j] = ctx.d(col0 + sub_col(j));
        if (fine0)
            cand0 = row_candidates<0, AS_FLOAT>(x, col0, dj, ctx, rows[0], b0);
        if (fine1)
            cand1 = row_candidates<1, AS_FLOAT>(x, col0, dj, ctx, rows[1], b1);
    }
    // One vote for the warp's rows: most subtiles end here.
    if (!__any_sync(0xffffffffu, (cand0 | cand1) != 0u)) return;
    // Then the quad's lanes in turn, only in rounds where some lane of
    // the warp has an element to insert.
    const int q = threadIdx.x & 3;
    const unsigned act0 = __ballot_sync(0xffffffffu, cand0 != 0u);
    const unsigned act1 = __ballot_sync(0xffffffffu, cand1 != 0u);
    for (int src = 0; src < 4; ++src) {
        if (!(act0 & (0x11111111u << src))) continue;  // uniform
        if (q == src && cand0)
            insert_row<0, AS_FLOAT>(x, ctx, col0, cand0, rows[0], k);
        __syncwarp();
    }
    for (int src = 0; src < 4; ++src) {
        if (!(act1 & (0x11111111u << src))) continue;
        if (q == src && cand1)
            insert_row<1, AS_FLOAT>(x, ctx, col0, cand1, rows[1], k);
        __syncwarp();
    }
}


// Consumer thread (WIDE: the kernel instance with the f64 fold): the
// products and the merge of the unit's subtiles into its rows' lists; d_min[sub] is the least column denominator of
// subtile sub (0 where it reaches past n). Columns at or past n read
// denominator 0 (their products are 0 from the zero fill; they score
// -inf as >= n_true).
template <bool WIDE>
__device__ __forceinline__ void consume_rows(const u8::Unit& u,
                                             u8::Pipe& pipe, const Ctx& ctx,
                                             const float* __restrict__ d_min,
                                             const Row (&rows)[2], int k) {
    const int wg = threadIdx.x / 128;
    if (u.resident()) u8::mbar_wait(pipe.rows_full(), 0);
    for (int sub = u.sub0; sub < u.sub1; ++sub) {
        const int col0 = sub * u8::BN;
        int x[u8::ACC];
        const bool as_float = u8::product_subtile<WIDE>(
            u, pipe, wg, u8::sub_max_at(u.sub_max, u.n_sub_max, sub), x);
        const float dmin = __ldg(d_min + sub);
        if (as_float)
            select_rows<true>(x, col0, dmin, ctx, rows, k);
        else
            select_rows<false>(x, col0, dmin, ctx, rows, k);
    }
}

}  // namespace pathsim
