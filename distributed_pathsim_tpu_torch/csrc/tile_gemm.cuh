// Score-tile machinery of K1 and K2 (sm_90a): the f32 CUDA-core product.
// K3 and K4 take their exact product from the int8 tensor cores
// (u8_tile.cuh) and share only normalize() from here; K1 and K2 move to
// that machinery in a later change, and this file goes with them.
//
// Every kernel here computes tiles of S = (2 * A * B^T) / (d_i + d_j), 0
// where d_i + d_j == 0, from row factors A [na, v] and column factors B
// [nb, v] (row-major f32; A == B for the square kernels, where both are
// the half-chain factor C) and their denominators. One block owns one
// [BM x BN] output tile and
// loops over the contraction axis v inside the block, staging [BK]-wide
// slices of the row tile and the column tile in shared memory. That one
// loop covers both the un-tiled Pallas kernels and their K-tiled
// variants. The product never leaves registers.
//
// Exactness: path counts are integers below 2^24, so every f32 FMA in
// any order is exact, and the only rounding is the one correctly rounded
// division in normalize(). This file must be compiled without fast math
// and with -prec-div=true. It uses CUDA-core FMAs only: TF32 tensor-core
// paths keep ~10 mantissa bits and would truncate counts above 2048 (the
// integer tensor cores of u8_tile.cuh are exact by construction).
//
// Simple by design: a register-blocked shared-memory FMA GEMM with a
// one-step register prefetch. Left on the table: the u8 limb products
// on the int8 tensor cores (u8_tile.cuh), exploiting the symmetry of S
// (only the upper-triangle tiles are needed: half the FLOPs, which is
// what the kernels' bound counts), and deeper shared-memory pipelining.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace pathsim {

constexpr int BM = 128;       // rows of a score tile
constexpr int BN = 128;       // columns of a score tile
constexpr int BK = 16;        // contraction slice staged per step
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int TM = 8;         // rows per thread: ty + 16 * r
constexpr int TN = 8;         // columns per thread: tx + 16 * c
constexpr int LOADS = BM * BK / THREADS;  // staged elements per thread per operand

// k-major staging; the +1 pad keeps the transposed stores conflict-light.
struct TileSmem {
    float a[BK][BM + 1];
    float b[BK][BN + 1];
};

__device__ __forceinline__ void stage_load(const float* __restrict__ a,
                                           int na,
                                           const float* __restrict__ b,
                                           int nb, int v, int row0,
                                           int col0, int k0,
                                           float (&ra)[LOADS],
                                           float (&rb)[LOADS]) {
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
        const int e = threadIdx.x + THREADS * q;
        const int r = e / BK;
        const int gk = k0 + e % BK;
        const bool k_ok = gk < v;
        ra[q] = (k_ok && row0 + r < na)
                    ? a[(long long)(row0 + r) * v + gk] : 0.0f;
        rb[q] = (k_ok && col0 + r < nb)
                    ? b[(long long)(col0 + r) * v + gk] : 0.0f;
    }
}

// acc[r][c] = sum_k A[row0 + ty + 16 r, k] * B[col0 + tx + 16 c, k],
// with rows of A past na and rows of B past nb reading as zero.
__device__ __forceinline__ void tile_product_rect(
    const float* __restrict__ a, int na, const float* __restrict__ b,
    int nb, int v, int row0, int col0, TileSmem& sm,
    float (&acc)[TM][TN]) {
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] = 0.0f;

    float ra[LOADS], rb[LOADS];
    stage_load(a, na, b, nb, v, row0, col0, 0, ra, rb);
    for (int k0 = 0; k0 < v; k0 += BK) {
        __syncthreads();  // every reader of the previous slice is done
#pragma unroll
        for (int q = 0; q < LOADS; ++q) {
            const int e = threadIdx.x + THREADS * q;
            sm.a[e % BK][e / BK] = ra[q];
            sm.b[e % BK][e / BK] = rb[q];
        }
        __syncthreads();
        if (k0 + BK < v)  // next slice's loads fly while this one computes
            stage_load(a, na, b, nb, v, row0, col0, k0 + BK, ra, rb);
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float x[TM], y[TN];
#pragma unroll
            for (int r = 0; r < TM; ++r) x[r] = sm.a[kk][ty + 16 * r];
#pragma unroll
            for (int j = 0; j < TN; ++j) y[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
            for (int r = 0; r < TM; ++r)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[r][j] = fmaf(x[r], y[j], acc[r][j]);
        }
    }
}

// The square form: acc[r][c] = sum_k C[row0 + ty + 16 r, k] *
// C[col0 + tx + 16 c, k], with rows/columns past n reading as zero.
__device__ __forceinline__ void tile_product(const float* __restrict__ c,
                                             int n, int v, int row0,
                                             int col0, TileSmem& sm,
                                             float (&acc)[TM][TN]) {
    tile_product_rect(c, n, c, n, v, row0, col0, sm, acc);
}

// The pallas_kernels.py _normalize form, verbatim: (2 m) / denom with a
// correctly rounded division, 0 where the denominator is not positive.
__device__ __forceinline__ float normalize(float m, float denom) {
    return denom > 0.0f ? (2.0f * m) / denom : 0.0f;
}

}  // namespace pathsim
