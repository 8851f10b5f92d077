// K4: the single-pass per-row top-k of the PathSim score matrix, for any
// k >= 1, for sm_90a.
//
// Replaces the Pallas kernels _topk_kernel (with _fold_tile_topk) and
// _topk_kernel_kt of distributed_pathsim_tpu/ops/pallas_kernels.py
// (fused_topk, fused_topk_ktiled): the dense rank-all for k > 16, where
// the two-pass kernel K1 keeps too few candidates per tile.
//
// What it computes: S = 2 (C C^T) / (d_i + d_j) (0 where that is 0) with
// the self pair at -inf when mask_self, and each row's top-k in the order
// of lax.top_k (descending score, ascending column) into vals [n, k] and
// idxs [n, k]. Columns n .. ceil(max(n, k) / BN) * BN - 1 are -inf
// padding with their own ids, so a row with fewer than k finite scores
// gets distinct ascending -inf columns (the Pallas fold repeats an index
// in such slots instead: after a slot is taken its value becomes -inf
// and the next round can take the same position again).
//
// Design: one block owns BM rows and walks every column tile in order,
// the TPU's sequential grid axis becoming a loop inside the block; the V
// loop is inside the tile product (tile_gemm.cuh), which covers the
// K-tiled Pallas variant too. Each row's running top-k lives in its own
// slice of the output in device memory (any k fits; the Pallas kernel
// likewise keeps its running best in the output block) and is merged
// tile by tile by the row's half-warp (topk_list.cuh): an element is
// compared with the list's k-th entry, and only the few that beat it are
// inserted (a search and a shift of the list, 16 entries per step).
//
// Bound on an H100: operations. S is symmetric, so the function needs
// the n (n + 1) / 2 upper-triangle dot products, n (n + 1) v f32 FLOP:
// 4.12e11 at the bench shape (n = 32768, v = 384), 6.15 ms at 67 TFLOP/s,
// against ~50 MB of C read and n k 8 bytes of output (5 MB at k = 20).
// This kernel scores every tile, 2 n^2 v FLOP, like K1. Scores that
// provably cannot reach a row's current k-th value, and zero counts, skip
// the division (score_row, topk_list.cuh). The merge costs one compare
// per element and one ballot per row once a row's list has settled (its
// k-th entry is kept in shared memory); the insertions of the first tiles
// go through device memory (L1/L2), a few round trips each, k per row at
// first and rarely after. Left on the table: the symmetry of S, the list
// in shared memory for small k, the GEMM's pipelining (tile_gemm.cuh),
// and register pressure (255 a thread, with a few spills).
#include <climits>

#include "tile_gemm.cuh"
#include "topk_list.cuh"

namespace pathsim {

__global__ void __launch_bounds__(THREADS)
topk_fold_kernel(const float* __restrict__ c, const float* __restrict__ d,
                 int n, int v, int k, int mask_self, int n_col_tiles,
                 float* __restrict__ vals, int* __restrict__ idxs) {
    __shared__ TileSmem sm;
    // each row's k-th entry, (value, column), kept beside its list
    __shared__ float bar_v[BM];
    __shared__ int bar_c[BM];
    const int row0 = blockIdx.x * BM;
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    const unsigned hmask = half_mask();

    float di[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
        const int gi = row0 + ty + 16 * r;
        di[r] = gi < n ? d[gi] : 0.0f;
        if (gi < n) {
            for (int e = tx; e < k; e += 16) {
                vals[(long long)gi * k + e] = -INFINITY;
                idxs[(long long)gi * k + e] = INT_MAX;
            }
        }
        if (tx == 0) {
            bar_v[ty + 16 * r] = -INFINITY;
            bar_c[ty + 16 * r] = INT_MAX;
        }
    }
    __syncwarp(hmask);

    for (int ct = 0; ct < n_col_tiles; ++ct) {
        const int col0 = ct * BN;
        float s[TM][TN];
        tile_product(c, n, v, row0, col0, sm, s);
        float dj[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gj = col0 + tx + 16 * j;
            dj[j] = gj < n ? d[gj] : 0.0f;
        }
        unsigned want = 0;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
            const int gi = row0 + ty + 16 * r;
            const float tv = bar_v[ty + 16 * r];
            if (gi < n) {
                score_row(s[r], di[r], dj, col0, mask_self ? gi : -1, n, tv);
                if (candidates(s[r], col0, tv, bar_c[ty + 16 * r]))
                    want |= 1u << r;
            }
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
            const unsigned rows = __ballot_sync(0xffffffffu, (want >> r) & 1u);
            if (rows & hmask) {  // uniform across the half-warp
                const long long gi = row0 + ty + 16 * r;
                float tv = bar_v[ty + 16 * r];
                int tc = bar_c[ty + 16 * r];
                merge_tile_mem(s[r], col0, k, hmask, vals + gi * k,
                               idxs + gi * k, tv, tc);
                __syncwarp(hmask);  // every lane has read the old bar
                if (tx == 0) {
                    bar_v[ty + 16 * r] = tv;
                    bar_c[ty + 16 * r] = tc;
                }
            }
        }
    }
}

}  // namespace pathsim

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The
// caller guarantees n >= 1, k >= 1 and buffers of n * k elements for
// vals and idxs.
extern "C" int pathsim_topk_fold(const float* c, const float* d, int n,
                                 int v, int k, int mask_self, float* vals,
                                 int* idxs, void* stream) {
    using namespace pathsim;
    const int width = n > k ? n : k;
    const int n_col_tiles = (width + BN - 1) / BN;
    topk_fold_kernel<<<(n + BM - 1) / BM, THREADS, 0, (cudaStream_t)stream>>>(
        c, d, n, v, k, mask_self, n_col_tiles, vals, idxs);
    return (int)cudaGetLastError();
}
