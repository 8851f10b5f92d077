// K3: pass 1 of the exact per-row top-k of one ROW TILE of the PathSim
// score matrix against every column, for sm_90a.
//
// Replaces the Pallas kernels _topk2_rect_kernel (with
// _extract_group_topk) and _topk2_rect_kernel_kt (with
// _extract_stripe_topk) of distributed_pathsim_tpu/ops/pallas_kernels.py
// (fused_topk_twopass_rect): the streaming sparse tier's hot op and the
// dense tier's rank-all past K1's candidate budget.
//
// What it computes: for rows r of A = c_rows [t, v] with global ids
// row_ids[r] and every column j of B = c_cols [n, v], the score
// S = 2 (A B^T) / (d_rows[r] + d_cols[j]) (0 where that is 0), with
// columns >= n_true and the self pair (j == row_ids[r]) at -inf; then,
// for each stripe of stripe_tiles * BN columns, the row's top-k in the
// order (descending score, ascending column), written to a candidate
// buffer [t, n_stripes, k]. Columns n .. ceil(n / BN) * BN - 1 are -inf
// padding with their own ids, so every stripe holds at least BN >= k
// columns. Pass 2 (the stable hierarchical sort ops/sparse.
// chunked_row_topk) reduces the candidates: any row's global top-k
// element is in its stripe's top-k, and the candidates lie in column
// order within equal values, so the result is exact with ties to the
// lowest column.
//
// Design: one block owns a [BM rows x stripe] block. It walks the
// stripe's column tiles in order; each tile's scores are computed in
// registers (tile_gemm.cuh, the V loop inside the block: this covers the
// un-tiled and the K-tiled Pallas variants alike) and merged into each
// row's running top-k, kept in registers one slot per lane of the row's
// half-warp (topk_list.cuh). Self pairs are masked in the kernel from
// row_ids, so k candidates per stripe suffice (the TPU kernel keeps k+1
// per tile and drops the self pair on the candidate list: the same
// function). The stripe width sets pass 2's cost and the insertions: with
// one candidate set per 128 columns, as in K1, a row of a 1M-column
// matrix would keep ~82k candidates; and a row's list restarts at every
// stripe, its insertions growing only with the log of the stripe width.
// So the wrapper (cuda_kernels.rect_stripe_tiles) makes stripes as wide
// as still gives the grid ~512 blocks: at the config-5 tile, 8 stripes
// of 1024 tiles, 80 candidates a row at k = 10 (5 MB), 512 blocks.
//
// Bound on an H100: operations. A row tile against all columns has no
// symmetry to exploit: 2 t n v f32 FLOP, 1.1e12 at the config-5 tile
// (t = 8192, n = 1048576, v = 64), 16.0 ms at 67 TFLOP/s on the CUDA
// cores, against 0.27 GB of factor read and 84 MB of candidates written
// (0.1 ms at 3.35 TB/s). At v = 64 each score costs only 64 FMAs, so the
// correctly rounded division (about 15 instructions per score) and the
// selection matter. A prefilter (score_row, topk_list.cuh) skips the
// division of every score that provably cannot reach the row's current
// k-th value (a multiply and a compare instead) and of every zero count;
// selection is one compare per element and one ballot per row once a
// row's list has settled, and an insertion (a few shuffles) only for the
// rare element that enters the list. Left on the table: a deeper
// shared-memory pipeline and fewer registers per thread (one 256-thread
// block per SM), as for K1 (tile_gemm.cuh).
#include <climits>

#include "tile_gemm.cuh"
#include "topk_list.cuh"

namespace pathsim {

__global__ void __launch_bounds__(THREADS)
topk_rect_kernel(const float* __restrict__ c_rows,
                 const float* __restrict__ d_rows,
                 const int* __restrict__ row_ids, int t,
                 const float* __restrict__ c_cols,
                 const float* __restrict__ d_cols, int n, int n_true, int v,
                 int k, int stripe_tiles, int n_stripes,
                 float* __restrict__ vals, int* __restrict__ cols) {
    __shared__ TileSmem sm;
    const int stripe = blockIdx.x;
    const int row0 = blockIdx.y * BM;
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    const unsigned hmask = half_mask();

    int rid[TM];
    float di[TM];
    float lv[TM];
    int lc[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
        const int gi = row0 + ty + 16 * r;
        rid[r] = gi < t ? row_ids[gi] : -1;
        di[r] = gi < t ? d_rows[gi] : 0.0f;
        lv[r] = -INFINITY;
        lc[r] = INT_MAX;
    }

    const int n_ct = (n + BN - 1) / BN;
    const int ct_end = min((stripe + 1) * stripe_tiles, n_ct);
    for (int ct = stripe * stripe_tiles; ct < ct_end; ++ct) {
        const int col0 = ct * BN;
        float s[TM][TN];
        tile_product_rect(c_rows, t, c_cols, n, v, row0, col0, sm, s);
        float dj[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gj = col0 + tx + 16 * j;
            dj[j] = gj < n ? d_cols[gj] : 0.0f;
        }
        // Each row's k-th entry, its scores, and whether any of them
        // could enter its list: independent work across the 8 rows.
        unsigned want = 0;
#pragma unroll
        for (int r = 0; r < TM; ++r) {
            const float tv = __shfl_sync(0xffffffffu, lv[r], k - 1, 16);
            const int tc = __shfl_sync(0xffffffffu, lc[r], k - 1, 16);
            if (row0 + ty + 16 * r < t) {
                score_row(s[r], di[r], dj, col0, rid[r], n_true, tv);
                if (candidates(s[r], col0, tv, tc)) want |= 1u << r;
            }
        }
#pragma unroll
        for (int r = 0; r < TM; ++r) {
            const unsigned rows = __ballot_sync(0xffffffffu, (want >> r) & 1u);
            if (rows & hmask)  // uniform across the half-warp
                merge_tile_regs(s[r], col0, k, hmask, lv[r], lc[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
        const int gi = row0 + ty + 16 * r;
        if (gi < t && tx < k) {
            const long long o = ((long long)gi * n_stripes + stripe) * k + tx;
            vals[o] = lv[r];
            cols[o] = lc[r];
        }
    }
}

}  // namespace pathsim

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The
// caller guarantees t >= 1, n >= 1, 0 <= n_true <= n, 1 <= k <= 16,
// stripe_tiles >= 1 and buffers of t * n_stripes * k elements for vals
// and cols, n_stripes = ceil(ceil(n / BN) / stripe_tiles).
extern "C" int pathsim_topk_rect(const float* c_rows, const float* d_rows,
                                 const int* row_ids, int t,
                                 const float* c_cols, const float* d_cols,
                                 int n, int n_true, int v, int k,
                                 int stripe_tiles, float* vals, int* cols,
                                 void* stream) {
    using namespace pathsim;
    const int n_ct = (n + BN - 1) / BN;
    const int n_stripes = (n_ct + stripe_tiles - 1) / stripe_tiles;
    const dim3 grid(n_stripes, (t + BM - 1) / BM);
    topk_rect_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        c_rows, d_rows, row_ids, t, c_cols, d_cols, n, n_true, v, k,
        stripe_tiles, n_stripes, vals, cols);
    return (int)cudaGetLastError();
}
