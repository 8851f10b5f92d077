// K1: pass 1 of the exact two-pass per-row top-k of the PathSim score
// matrix, for sm_90a.
//
// Replaces the Pallas kernels _topk2_kernel and _topk2_kernel_kt of
// distributed_pathsim_tpu/ops/pallas_kernels.py (fused_topk_twopass).
// Each block scores one [BM x BN] tile (tile_gemm.cuh), masks columns
// >= n and, with mask_self, the self pair to -inf, and writes each row's
// tile-local top-k (values descending, ties to the lowest column) to a
// candidate buffer laid out [n, n_col_tiles, k]. Pass 2 (a stable
// hierarchical sort in torch, ops/sparse.chunked_row_topk) reduces the
// candidates to the final top-k: any global top-k element is in its
// tile's top-k, so the result is exact, and the candidate order (tile
// ascending, then column ascending among equal values) makes the stable
// sort break ties to the lowest global column.
//
// Bound on an H100: operations. S is symmetric, so the function needs
// only the upper-triangle dot products: n (n + 1) v = 4.12e11 f32 FLOP at
// the rank-all shape (n = 32768, v = 384), 6.15 ms at 67 TFLOP/s on the
// CUDA cores, against ~50 MB of C read and ~0.67 GB of candidates
// written (0.21 ms at 3.35 TB/s). This kernel scores every tile, twice
// that: 2 n^2 v = 8.25e11 FLOP. The selection is k rounds of a 16-lane
// shuffle argmax per row held in registers, about a sixth of the GEMM's
// instruction count at k = 10. What the simple design leaves on the
// table: see tile_gemm.cuh, plus the candidate bytes (a k-wide merge
// across column tiles inside the block would cut them by the number of
// column tiles per block).
#include <climits>

#include "tile_gemm.cuh"

namespace pathsim {

__global__ void __launch_bounds__(THREADS)
topk_candidates_kernel(const float* __restrict__ c,
                       const float* __restrict__ d, int n, int v, int k,
                       int mask_self, int n_ct, float* __restrict__ vals,
                       int* __restrict__ cols) {
    __shared__ TileSmem sm;
    const int col_tile = blockIdx.x;
    const int row0 = blockIdx.y * BM;
    const int col0 = col_tile * BN;
    float s[TM][TN];
    tile_product(c, n, v, row0, col0, sm, s);

    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    float dj[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const int gj = col0 + tx + 16 * j;
        dj[j] = gj < n ? d[gj] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
        const int gi = row0 + ty + 16 * r;
        const float di = gi < n ? d[gi] : 0.0f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gj = col0 + tx + 16 * j;
            const float x = normalize(s[r][j], di + dj[j]);
            s[r][j] = (gj >= n || (mask_self && gi == gj)) ? -INFINITY : x;
        }
    }

    // A row's BN columns live in the 16 lanes of one half-warp (8 each).
    // Round t: each lane proposes its best untaken (value, column), a
    // 4-step xor shuffle picks the half-warp's best (ties: lower
    // column), the owner marks it taken, and lane t keeps it for slot t.
    // Taken bits (not -inf) mark used entries, so -inf entries are
    // still emitted as distinct columns.
    unsigned taken[TM];
    float keep_v[TM];
    int keep_c[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
        taken[r] = 0u;
        keep_v[r] = -INFINITY;
        keep_c[r] = 0;
    }
    for (int t = 0; t < k; ++t) {
#pragma unroll
        for (int r = 0; r < TM; ++r) {
            float bv = -INFINITY;
            int bc = INT_MAX;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int gj = col0 + tx + 16 * j;
                const bool untaken = !((taken[r] >> j) & 1u);
                if (untaken && (s[r][j] > bv || (s[r][j] == bv && gj < bc))) {
                    bv = s[r][j];
                    bc = gj;
                }
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) {
                const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
                const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
                if (ov > bv || (ov == bv && oc < bc)) {
                    bv = ov;
                    bc = oc;
                }
            }
            const int local = bc - col0;
            if (local % 16 == tx) taken[r] |= 1u << (local / 16);
            if (tx == t) {
                keep_v[r] = bv;
                keep_c[r] = bc;
            }
        }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
        const int gi = row0 + ty + 16 * r;
        if (gi < n && tx < k) {
            const long long o = ((long long)gi * n_ct + col_tile) * k + tx;
            vals[o] = keep_v[r];
            cols[o] = keep_c[r];
        }
    }
}

}  // namespace pathsim

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The
// caller guarantees n >= 1, 1 <= k <= 16 and buffers of
// n * ceil(n / BN) * k elements for vals and cols.
extern "C" int pathsim_topk_candidates(const float* c, const float* d,
                                       int n, int v, int k, int mask_self,
                                       float* vals, int* cols,
                                       void* stream) {
    using namespace pathsim;
    const int n_ct = (n + BN - 1) / BN;
    const dim3 grid(n_ct, (n + BM - 1) / BM);
    topk_candidates_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        c, d, n, v, k, mask_self, n_ct, vals, cols);
    return (int)cudaGetLastError();
}
