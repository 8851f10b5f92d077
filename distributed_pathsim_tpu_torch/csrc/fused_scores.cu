// K2: the all-pairs PathSim score matrix, for sm_90a.
//
// Replaces the Pallas kernels _scores_kernel and _scores_kernel_kt of
// distributed_pathsim_tpu/ops/pallas_kernels.py (fused_scores and
// fused_scores_ktiled): each block writes one normalized [BM x BN] tile
// of S = (2 * C * C^T) / (d_i + d_j) (0 where d_i + d_j == 0), so the
// count matrix M never reaches device memory. The loop over v inside the
// block (tile_gemm.cuh) serves narrow and wide factors alike.
//
// Bound on an H100: S is symmetric, so at the all-pairs shape of the main
// path (n = 8192, v = 384) the function needs n (n + 1) v = 2.58e10 f32
// FLOP (the upper triangle) against 268 MB of S written: operations
// bound, 0.38 ms at 67 TFLOP/s vs 0.08 ms at 3.35 TB/s. This kernel
// computes every tile, 2 n^2 v = 5.2e10 FLOP. The simple design leaves
// on the table what tile_gemm.cuh lists; the mirrored half of the tiles
// is the largest item.
#include "tile_gemm.cuh"

namespace pathsim {

__global__ void __launch_bounds__(THREADS)
scores_kernel(const float* __restrict__ c, const float* __restrict__ d,
              int n, int v, float* __restrict__ out) {
    __shared__ TileSmem sm;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
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
        if (gi >= n) continue;
        const float di = d[gi];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int gj = col0 + tx + 16 * j;
            if (gj < n)
                out[(long long)gi * n + gj] = normalize(s[r][j], di + dj[j]);
        }
    }
}

}  // namespace pathsim

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The
// caller guarantees n >= 1 and an output buffer of n * n floats.
extern "C" int pathsim_fused_scores(const float* c, const float* d, int n,
                                    int v, float* out, void* stream) {
    using namespace pathsim;
    const dim3 grid((n + BN - 1) / BN, (n + BM - 1) / BM);
    scores_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(c, d, n, v,
                                                               out);
    return (int)cudaGetLastError();
}
