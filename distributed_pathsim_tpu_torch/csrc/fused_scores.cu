// K2: the all-pairs PathSim score matrix, for sm_90a.
//
// Replaces the Pallas kernels _scores_kernel and _scores_kernel_kt of
// distributed_pathsim_tpu/ops/pallas_kernels.py (fused_scores and
// fused_scores_ktiled): S = (2 * C * C^T) / (d_i + d_j) (0 where
// d_i + d_j == 0), [n, n] f32, normalized in registers, so the count
// matrix M never reaches device memory.
//
// Design: one block owns one (128-row block, stripe of 64-column
// subtiles) unit and walks the stripe's subtiles. M comes exact from the
// int8 tensor cores over the factor's u8 limb planes (u8_tile.cuh:
// integer tensor cores, exact by construction; still no TF32), the row
// block's planes resident while they fit, the V loop covering the
// K-tiled Pallas variant. Each warp normalizes its 16 rows x 32 columns
// of the subtile at a time in registers, stages them in shared memory
// (rows 40 floats apart: the float2 writes of wgmma's accumulator layout
// and the row reads are both free of bank conflicts) and stores them a
// row at a time, 32 lanes on 32 consecutive floats: one 128-byte line
// per instruction, evict-first (st.global.cs) so the output streams past
// the L2 that holds the limb planes. The stores are asynchronous: one
// warpgroup's stores overlap the other warpgroup's product, and two
// blocks share an SM. Row blocks with the most limbs launch first.
//
// Bound on an H100: at the all-pairs shape of the main path (n = 8192,
// v = 384) the n (n + 1) / 2 upper-triangle dot products are 2.6e10 u8
// operations per limb product, 0.013 ms at the int8 tensor cores' 1,979
// TOP/s, and S is 268 MB written, 0.080 ms at 3.35 TB/s: bytes. The
// kernel computes every tile (2 n^2 v); the mirrored half of the product
// would save tensor-core time that the stores hide anyway.
#include "topk_list.cuh"
#include "u8_tile.cuh"

namespace pathsim {

constexpr int STAGE_LD = 40;  // staged row pitch, floats
constexpr int STAGE_SMEM = (u8::THREADS / 32) * 16 * STAGE_LD * 4;

// Normalize this thread's elements of the subtile at col0 (x: M as s32,
// or f32 bits when AS_FLOAT) and store them: per warp, two passes of 16
// rows x 32 columns through the warp's staging rows st.
template <bool AS_FLOAT>
__device__ __forceinline__ void store_subtile(const int (&x)[u8::ACC],
                                              const float (&di)[2],
                                              const float* __restrict__ d,
                                              int n, int col0, int wrow0,
                                              float* st,
                                              float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int q = lane & 3;
    float dj[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const int gj = col0 + sub_col(j);
        dj[j] = gj < n ? __ldg(d + gj) : 0.0f;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int j = 2 * (4 * half + i);  // columns 8 (j/2) + 2q + {0, 1}
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float2 s;
                s.x = score_of(m_f32<AS_FLOAT>(x[slot(h, j)]), di[h] + dj[j]);
                s.y = score_of(m_f32<AS_FLOAT>(x[slot(h, j + 1)]),
                               di[h] + dj[j + 1]);
                *reinterpret_cast<float2*>(
                    st + ((lane >> 2) + 8 * h) * STAGE_LD + 8 * i + 2 * q) = s;
            }
        }
        __syncwarp();
        const int gj = col0 + 32 * half + lane;
        if (gj < n) {
#pragma unroll 4
            for (int r = 0; r < 16 && wrow0 + r < n; ++r)
                __stcs(out + (long long)(wrow0 + r) * n + gj,
                       st[r * STAGE_LD + lane]);
        }
        __syncwarp();
    }
}

// WIDE: the instance with the f64 fold, for a factor whose row sums do
// not bound every M below 2^31 (u8_tile.cuh); it takes the registers of
// one block an SM, the common instance leaves room for two.
template <bool WIDE>
__global__ void __launch_bounds__(u8::THREADS, WIDE ? 1 : 2)
scores_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const float* __restrict__ d, int n, int v_pad, int stripe_sub,
              int n_stripes, const int* __restrict__ rb_max,
              const int* __restrict__ order,
              const int* __restrict__ sub_max, float* __restrict__ out) {
    extern __shared__ __align__(1024) uint8_t smem[];
    const int n_sub = (n + u8::BN - 1) / u8::BN;
    const int rb = order[blockIdx.x / n_stripes];
    const int sub0 = (blockIdx.x % n_stripes) * stripe_sub;
    const u8::Unit u{sub_max, n_sub, rb_max[rb], sub0,
                     min(sub0 + stripe_sub, n_sub), v_pad, WIDE};
    const int row0 = rb * u8::BM;
    u8::Pipe pipe;
    float* stage = reinterpret_cast<float*>(
        u8::pipe_init(smem, u, &map_a, &map_b, row0, pipe));
    __syncthreads();
    if (threadIdx.x == 0) {  // the producer
        u8::load_rows(u, pipe);
        u8::feed_stages(u, pipe, u.stages());
    }
    const int wg = threadIdx.x / 128;
    const int warp = threadIdx.x / 32;
    float* st = stage + warp * 16 * STAGE_LD;
    const int wrow0 = row0 + wg * 64 + (warp % 4) * 16;
    float di[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int gi = row0 + local_row(h);
        di[h] = gi < n ? d[gi] : 0.0f;
    }
    if (u.resident()) u8::mbar_wait(pipe.rows_full(), 0);
    for (int sub = u.sub0; sub < u.sub1; ++sub) {
        int x[u8::ACC];
        const bool as_float = u8::product_subtile<WIDE>(
            u, pipe, wg, u8::sub_max_at(sub_max, n_sub, sub), x);
        if (as_float)
            store_subtile<true>(x, di, d, n, sub * u8::BN, wrow0, st, out);
        else
            store_subtile<false>(x, di, d, n, sub * u8::BN, wrow0, st, out);
    }
}

}  // namespace pathsim

// Launch on `stream`; returns 0, a CUDA error, or a tensor-map error
// (u8_tile.cuh). The caller guarantees n >= 1, stripe_tiles >= 1, limb
// planes [n_planes, n, v_pad] u8 (v_pad a multiple of 32; rows v_pad
// bytes apart, planes plane_stride apart), rb_max (each block's largest
// entry) and order over the ceil(n / 128) row blocks, sub_max (each
// subtile's largest entry) over the ceil(n / 64) subtiles, wide (0 only
// when every M of the factor is known below 2^31), and an output buffer
// of n * n floats.
extern "C" int pathsim_fused_scores(const void* planes, int n_planes,
                                    long long plane_stride, int v_pad,
                                    const float* d, int n, int stripe_tiles,
                                    const int* rb_max, const int* order,
                                    const int* sub_max, int wide, float* out,
                                    void* stream) {
    using namespace pathsim;
    CUtensorMap map_a, map_b;
    int rc = pathsim_limb_map(&map_a, planes, n_planes, n, v_pad,
                              plane_stride, u8::BM);
    if (rc == 0)
        rc = pathsim_limb_map(&map_b, planes, n_planes, n, v_pad,
                              plane_stride, u8::BN);
    if (rc != 0) return rc;
    const int n_sub = (n + u8::BN - 1) / u8::BN;
    const int stripe_sub = stripe_tiles * (128 / u8::BN);
    const int n_stripes = (n_sub + stripe_sub - 1) / stripe_sub;
    const int smem = u8::PIPE_SMEM + STAGE_SMEM;
    const auto kernel = wide ? scores_kernel<true> : scores_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const long long units =
        (long long)((n + u8::BM - 1) / u8::BM) * n_stripes;
    kernel<<<(unsigned)units, u8::THREADS, smem, (cudaStream_t)stream>>>(
        map_a, map_b, d, n, v_pad, stripe_sub, n_stripes, rb_max, order,
        sub_max, out);
    return (int)cudaGetLastError();
}
