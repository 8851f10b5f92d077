// Per-row running top-k lists of K1, K3 and K4 (sm_90a): the consumers'
// loop of a row block over a range of 64-column subtiles, the merge of
// each subtile's scores into a row's sorted best-k, and the unit of the
// two-pass kernels K1 and K3 (a row block against one stripe of columns).
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
#include <type_traits>

#include "u8_tile.cuh"

namespace pathsim {

// The pallas_kernels.py _normalize form, verbatim: (2 m) / denom with a
// correctly rounded division (built with -prec-div=true and no fast
// math), 0 where the denominator is not positive.
__device__ __forceinline__ float normalize(float m, float denom) {
    return denom > 0.0f ? (2.0f * m) / denom : 0.0f;
}

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

// normalize(m, den), written out for m == 0 (+0 for any den, without a
// division: most pairs of a sparse graph share no path, and a zero
// numerator sends the correctly rounded division down its slow path).
__device__ __forceinline__ float score_of(float m, float den) {
    return m != 0.0f ? normalize(m, den) : 0.0f;
}

// One element's score: -inf for columns >= n_true and for self_col,
// else score_of(m, den).
__device__ __forceinline__ float score_elem(float m, float den, int gj,
                                            int self_col, int n_true) {
    if (gj >= n_true || gj == self_col) return -INFINITY;
    return score_of(m, den);
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

// Largest k of the two-pass kernels (K1, K3): a row's list has at most
// this many slots in shared memory.
constexpr int CAND_K_MAX = 16;

// The unit grid of a two-pass kernel: one block per (128-row block,
// stripe of stripe_sub column subtiles) unit; the row blocks in the
// wrapper's order (most limbs first), each block's stripes in a row. The
// card starts blocks in that order as SMs free up, so the few slow
// multi-limb units run first and the rest fill in behind them. rb_max
// (each row block's largest entry) and order span the row blocks,
// sub_max (each 64-row tile's largest entry) the column factor's
// n_sub_max subtiles, d_min (each subtile's least column denominator, 0
// past the columns) the n_sub subtiles walked.
struct StripeGrid {
    int stripe_sub, n_stripes, n_sub, n_sub_max;
    const int* rb_max;
    const int* order;
    const int* sub_max;
    const float* d_min;
};

// One unit of a two-pass kernel: each of the row block's rows' top-k
// among the stripe's columns, into vals / cols [t, n_stripes, k] (k <=
// CAND_K_MAX). The rows' lists live in shared memory after the
// pipeline. ctx names the column denominators, the columns' end and the
// self mask; its row0 is set here.
template <bool WIDE>
__device__ __forceinline__ void stripe_topk(const CUtensorMap* map_a,
                                            const CUtensorMap* map_b,
                                            const float* __restrict__ d_rows,
                                            int t, Ctx ctx,
                                            const StripeGrid g, int v_pad,
                                            int k, float* __restrict__ vals,
                                            int* __restrict__ cols) {
    extern __shared__ __align__(1024) uint8_t smem[];
    const int rb = g.order[blockIdx.x / g.n_stripes];
    const int stripe = blockIdx.x % g.n_stripes;
    const int sub0 = stripe * g.stripe_sub;
    const u8::Unit u{g.sub_max, g.n_sub_max, g.rb_max[rb], sub0,
                     min(sub0 + g.stripe_sub, g.n_sub), v_pad, WIDE};
    const int row0 = rb * u8::BM;
    u8::Pipe pipe;
    uint8_t* lists = u8::pipe_init(smem, u, map_a, map_b, row0, pipe);
    __syncthreads();
    if (threadIdx.x == 0) {  // the producer
        u8::load_rows(u, pipe);
        u8::feed_stages(u, pipe, u.stages());
    }

    Row rows[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int lrow = local_row(h);
        const int gi = row0 + lrow;
        Row& r = rows[h];
        r.valid = gi < t;
        r.di = r.valid ? d_rows[gi] : 0.0f;
        r.lv = reinterpret_cast<float*>(lists) + lrow * CAND_K_MAX;
        r.lc_off = u8::BM * CAND_K_MAX;
        list_init(r, k);
    }
    __syncwarp();
    ctx.row0 = row0;
    consume_rows<WIDE>(u, pipe, ctx, g.d_min, rows, k);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const long long gi = row0 + local_row(h);
        const long long o = (gi * g.n_stripes + stripe) * k;
        list_store(rows[h], k, vals + o, cols + o);
    }
}

// Dynamic shared memory of a two-pass kernel: the pipeline and the lists.
constexpr int STRIPE_SMEM = u8::PIPE_SMEM + u8::BM * CAND_K_MAX * 8;

// -- the exact instances (K1 and K4 under exact counts) ----------------------
//
// Each value is the correctly rounded f64 quotient 2 M / (d_i + d_j) of
// the exact integers M and d (0 where d_i + d_j is 0): the upstream's
// score as a Python float. M is taken as the product leaves it, exact:
// the s32 accumulator of a narrow pair, or the f64 sum of a wide one
// (u8_tile.cuh, product_subtile_exact), never rounded to f32. d comes
// twice: exact (f64: integers below 2^52, so d_i + d_j is exact too) for
// the score, and rounded to f32 for the prefilter. The lists hold f64
// values: values [rows][k], then columns [rows][k].
//
// The prefilter keeps the f64 division off every element that provably
// stays out of its row's list. With the list's k-th entry (tv, tc)
// settled (tv >= 0; the columns come in ascending order, so tc lies left
// of every element still to come), an element stays out when m < tv den
// / 2 in exact arithmetic: then 2 m / den < tv, its correctly rounded
// quotient is at most tv, and a score equal to tv loses the tie to tc.
// In f32: ths = RD(tv / 2 (1 - 2^-20)), and the element stays out when m
// == 0 or RN(m) < RN(ths RN(RN(d_i) + RN(d_j))). Each of the five
// roundings (four RN, and tv / 2 (1 - 2^-20) itself in f64) errs by at
// most 2^-24 of its value, so RN(m) < that implies m < tv den / 2 (1 -
// 2^-20) (1 + 2^-24)^5 / (1 - 2^-24) < tv den / 2. The coarse test of a
// row part takes its largest M and the subtile's least f32 denominator
// (d_min: RN and the sum are monotone, so it bounds every element's).
// Only the elements that pass are scored in f64 and counted.

// An exact count rounded to f32 for the prefilter (a narrow pair's s32,
// a wide pair's f64).
__device__ __forceinline__ float m_rn32(int m) { return __int2float_rn(m); }
__device__ __forceinline__ float m_rn32(double m) {
    return __double2float_rn(m);
}
__device__ __forceinline__ int m_max(int a, int b) { return max(a, b); }
__device__ __forceinline__ double m_max(double a, double b) {
    return fmax(a, b);
}

// 2 m / den correctly rounded in f64, 0 where m or den is 0 (a pair
// with a path has den >= 2 m > 0).
__device__ __forceinline__ double score64(double m, double den) {
    return m != 0.0 && den > 0.0 ? __ddiv_rn(2.0 * m, den) : 0.0;
}

__device__ __forceinline__ bool beats64(double v, int c, double ov, int oc) {
    return v > ov || (v == ov && c < oc);
}

// Ctx (its f32 denominators are the prefilter's) and the exact ones.
struct Ctx64 {
    Ctx f32;
    const double* __restrict__ d64;

    __device__ double d(int gj) const {
        return gj < f32.n ? __ldg(d64 + gj) : 0.0;
    }
};

// A row of a block in an exact instance: its list (k f64 values at lv,
// their k columns lc_off 4-byte slots further on), its exact and its f32
// denominator, and whether it exists.
struct Row64 {
    double* lv;
    int lc_off;
    double di;
    float di32;
    bool valid;

    __device__ int* lc() const { return reinterpret_cast<int*>(lv) + lc_off; }
};

__device__ __forceinline__ void list_init64(const Row64& r, int k) {
    if (r.valid)
        for (int e = threadIdx.x & 3; e < k; e += 4) {
            r.lv[e] = -INFINITY;
            r.lc()[e] = INT_MAX;
        }
}

__device__ __forceinline__ void list_store64(const Row64& r, int k,
                                             double* out_v, int* out_c) {
    if (r.valid)
        for (int e = threadIdx.x & 3; e < k; e += 4) {
            out_v[e] = r.lv[e];
            out_c[e] = r.lc()[e];
        }
}

// Row r of a block whose lists lie in `lists` (rows x k values, then
// rows x k columns): its list and its offset to the columns.
__device__ __forceinline__ void list_at64(Row64& r, double* lists, int rows,
                                          int row, int k) {
    r.lv = lists + (long long)row * k;
    r.lc_off = 2 * rows * k - row * k;
}

// Element j of row H, column gj: its exact score (-inf for columns >=
// n_true and the self column).
template <int H, typename T>
__device__ __forceinline__ double elem_score64(const T (&x)[u8::ACC],
                                               const Ctx64& ctx, int j,
                                               int gj, const Row64& r) {
    if (gj >= ctx.f32.n_true || gj == ctx.f32.self(H)) return -INFINITY;
    return score64((double)pick<H>(x, j), r.di + ctx.d(gj));
}

template <int H, typename T>
__device__ __forceinline__ void insert_row64(const T (&x)[u8::ACC],
                                             const Ctx64& ctx, int col0,
                                             unsigned bits, const Row64& r,
                                             int k) {
    double* lv = r.lv;
    int* lc = r.lc();
    while (bits) {
        const int j = __ffs(bits) - 1;
        bits &= bits - 1;
        const int c = col0 + sub_col(j);
        const double v = elem_score64<H>(x, ctx, j, c, r);
        if (!beats64(v, c, lv[k - 1], lc[k - 1])) continue;
        int pos = k - 1;
        while (pos > 0 && beats64(v, c, lv[pos - 1], lc[pos - 1])) {
            lv[pos] = lv[pos - 1];
            lc[pos] = lc[pos - 1];
            --pos;
        }
        lv[pos] = v;
        lc[pos] = c;
    }
}

// A row's k-th entry for one subtile's selection: settled when tv >= 0,
// then ths is the prefilter's f32 bar.
struct Bar64 {
    double tv;
    int tc;
    bool settled;
    bool small;  // every M of the row part is below 2^23 (s32 only)
    float ths;
};

// Whether row H's part of the subtile needs the per-element test: not
// once the list is settled and the part's largest M passes the coarse
// test (all of it zero, or below the bar at the subtile's least
// denominator).
template <int H, typename T>
__device__ __forceinline__ bool needs_fine64(const T (&x)[u8::ACC],
                                             float dmin, const Row64& r,
                                             int k, Bar64& b) {
    if (!r.valid) return false;
    b.tv = r.lv[k - 1];
    b.tc = r.lc()[k - 1];
    b.settled = b.tv >= 0.0;
    T mx = x[slot(H, 0)];
#pragma unroll
    for (int j = 1; j < 16; ++j) mx = m_max(mx, x[slot(H, j)]);
    b.small = mx < (1 << 23);
    if (!b.settled) return true;
    b.ths = __double2float_rd(b.tv * (0.5 - 0x1p-21));
    return mx != 0 && !(m_rn32(mx) < b.ths * (r.di32 + dmin));
}

// The elements of row H that beat its list's k-th entry: the prefilter
// on each element (no division, no branch), then for the rest (rare once
// settled; every element while the list fills) the f64 score, counted in
// `scored`, and the comparison with the k-th entry.
template <int H, typename T>
__device__ __forceinline__ unsigned row_candidates64(
    const T (&x)[u8::ACC], int col0, const float (&dj)[16],
    const Ctx64& ctx, const Row64& r, const Bar64& b, unsigned& scored) {
    unsigned keep = 0xffffu;
    if (b.settled) {
        keep = 0u;
        if (std::is_same<T, int>::value && b.small) {
            // the exact s32 -> f32 in two adds (2^23 + m has m as its
            // mantissa), as topk_list's row_candidates
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const int m = (int)x[slot(H, j)];
                const float mf = __int_as_float(0x4B000000 | m) - 0x1p23f;
                keep |= (unsigned)(m != 0 &&
                                   !(mf < b.ths * (r.di32 + dj[j]))) << j;
            }
        } else {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                const T m = x[slot(H, j)];
                keep |= (unsigned)(m != 0 &&
                                   !(m_rn32(m) < b.ths * (r.di32 + dj[j])))
                        << j;
            }
        }
    }
    unsigned bits = 0u;
    while (keep) {
        const int j = __ffs(keep) - 1;
        keep &= keep - 1;
        const int gj = col0 + sub_col(j);
        const double sc = elem_score64<H>(x, ctx, j, gj, r);
        ++scored;
        bits |= (unsigned)beats64(sc, gj, b.tv, b.tc) << j;
    }
    return bits;
}

// select_rows for the exact instances: x holds M exact (s32, or f64 on
// the wide path).
template <typename T>
__device__ __forceinline__ void select_rows64(const T (&x)[u8::ACC],
                                              int col0, float dmin,
                                              const Ctx64& ctx,
                                              const Row64 (&rows)[2], int k,
                                              unsigned& scored) {
    Bar64 b0, b1;
    const bool fine0 = needs_fine64<0>(x, dmin, rows[0], k, b0);
    const bool fine1 = needs_fine64<1>(x, dmin, rows[1], k, b1);
    unsigned cand0 = 0u, cand1 = 0u;
    if (fine0 || fine1) {
        float dj[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) dj[j] = ctx.f32.d(col0 + sub_col(j));
        if (fine0)
            cand0 = row_candidates64<0>(x, col0, dj, ctx, rows[0], b0,
                                        scored);
        if (fine1)
            cand1 = row_candidates64<1>(x, col0, dj, ctx, rows[1], b1,
                                        scored);
    }
    if (!__any_sync(0xffffffffu, (cand0 | cand1) != 0u)) return;
    const int q = threadIdx.x & 3;
    const unsigned act0 = __ballot_sync(0xffffffffu, cand0 != 0u);
    const unsigned act1 = __ballot_sync(0xffffffffu, cand1 != 0u);
    for (int src = 0; src < 4; ++src) {
        if (!(act0 & (0x11111111u << src))) continue;  // uniform
        if (q == src && cand0) insert_row64<0>(x, ctx, col0, cand0, rows[0], k);
        __syncwarp();
    }
    for (int src = 0; src < 4; ++src) {
        if (!(act1 & (0x11111111u << src))) continue;
        if (q == src && cand1) insert_row64<1>(x, ctx, col0, cand1, rows[1], k);
        __syncwarp();
    }
}

// consume_rows for the exact instances; `scored` counts the elements
// this thread scored in f64.
template <bool WIDE>
__device__ __forceinline__ void consume_rows64(const u8::Unit& u,
                                               u8::Pipe& pipe,
                                               const Ctx64& ctx,
                                               const float* __restrict__ d_min,
                                               const Row64 (&rows)[2], int k,
                                               unsigned& scored) {
    const int wg = threadIdx.x / 128;
    if (u.resident()) u8::mbar_wait(pipe.rows_full(), 0);
    for (int sub = u.sub0; sub < u.sub1; ++sub) {
        const int col0 = sub * u8::BN;
        const int bmax = u8::sub_max_at(u.sub_max, u.n_sub_max, sub);
        const float dmin = __ldg(d_min + sub);
        int x[u8::ACC];
        if constexpr (WIDE) {
            double xw[u8::ACC];
            if (u8::product_subtile_exact(u, pipe, wg, bmax, x, xw)) {
                select_rows64<double>(xw, col0, dmin, ctx, rows, k, scored);
                continue;
            }
        } else {
            u8::product_subtile<false>(u, pipe, wg, bmax, x);
        }
        select_rows64<int>(x, col0, dmin, ctx, rows, k, scored);
    }
}

// Add the block's f64 scorings to *total, once a block (every thread of
// the block calls this; block_sum is the block's shared counter, zeroed
// before the block's first __syncthreads). total may be null.
__device__ __forceinline__ void add_scored(unsigned n,
                                           unsigned long long* block_sum,
                                           unsigned long long* total) {
    n = __reduce_add_sync(0xffffffffu, n);
    if ((threadIdx.x & 31) == 0 && n) atomicAdd(block_sum, (unsigned long long)n);
    __syncthreads();
    if (threadIdx.x == 0 && total != nullptr && *block_sum)
        atomicAdd(total, *block_sum);
}

// stripe_topk for the exact instance of K1: vals f64, the lists k slots
// a row (shared memory stripe_smem64(k)), d_rows / d32_rows the rows'
// exact and f32 denominators, scored the launch's count of f64 scorings.
template <bool WIDE>
__device__ __forceinline__ void stripe_topk64(
    const CUtensorMap* map_a, const CUtensorMap* map_b,
    const double* __restrict__ d_rows, const float* __restrict__ d32_rows,
    int t, Ctx64 ctx, const StripeGrid g, int v_pad, int k,
    double* __restrict__ vals, int* __restrict__ cols,
    unsigned long long* scored_total) {
    extern __shared__ __align__(1024) uint8_t smem[];
    __shared__ unsigned long long block_scored;
    const int rb = g.order[blockIdx.x / g.n_stripes];
    const int stripe = blockIdx.x % g.n_stripes;
    const int sub0 = stripe * g.stripe_sub;
    const u8::Unit u{g.sub_max, g.n_sub_max, g.rb_max[rb], sub0,
                     min(sub0 + g.stripe_sub, g.n_sub), v_pad, WIDE};
    const int row0 = rb * u8::BM;
    u8::Pipe pipe;
    uint8_t* lists = u8::pipe_init(smem, u, map_a, map_b, row0, pipe);
    if (threadIdx.x == 0) block_scored = 0;
    __syncthreads();
    if (threadIdx.x == 0) {  // the producer
        u8::load_rows(u, pipe);
        u8::feed_stages(u, pipe, u.stages());
    }

    Row64 rows[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int lrow = local_row(h);
        const int gi = row0 + lrow;
        Row64& r = rows[h];
        r.valid = gi < t;
        r.di = r.valid ? d_rows[gi] : 0.0;
        r.di32 = r.valid ? d32_rows[gi] : 0.0f;
        list_at64(r, reinterpret_cast<double*>(lists), u8::BM, lrow, k);
        list_init64(r, k);
    }
    __syncwarp();
    ctx.f32.row0 = row0;
    unsigned scored = 0;
    consume_rows64<WIDE>(u, pipe, ctx, g.d_min, rows, k, scored);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const long long gi = row0 + local_row(h);
        const long long o = (gi * g.n_stripes + stripe) * k;
        list_store64(rows[h], k, vals + o, cols + o);
    }
    add_scored(scored, &block_scored, scored_total);
}

// Dynamic shared memory of the exact K1 at k: the pipeline and k slots
// of 12 bytes a row (k <= 15 leaves room for two blocks an SM).
__host__ __device__ constexpr int stripe_smem64(int k) {
    return u8::PIPE_SMEM + u8::BM * k * 12;
}

}  // namespace pathsim

// Host: the StripeGrid of a two-pass launch over the row_blocks row
// blocks that order lists (all of a launch's rows, or a slice of them)
// and n columns, with stripes of stripe_tiles 128-column tiles (the last
// may be shorter): ceil(n / 128) * 2 subtiles walked, so every stripe
// holds at least 128 >= k columns, those past n -inf padding with their
// own ids. Sets *units to the grid's size, row_blocks * n_stripes.
static pathsim::StripeGrid pathsim_stripe_grid(int row_blocks, int n,
                                               int stripe_tiles,
                                               const int* rb_max,
                                               const int* order,
                                               const int* sub_max,
                                               const float* d_min,
                                               long long* units) {
    const int per_tile = 128 / pathsim::u8::BN;
    const int n_ct = (n + 127) / 128;
    const int n_stripes = (n_ct + stripe_tiles - 1) / stripe_tiles;
    *units = (long long)row_blocks * n_stripes;
    return pathsim::StripeGrid{stripe_tiles * per_tile, n_stripes,
                               n_ct * per_tile,
                               (n + pathsim::u8::BN - 1) / pathsim::u8::BN,
                               rb_max, order, sub_max, d_min};
}
