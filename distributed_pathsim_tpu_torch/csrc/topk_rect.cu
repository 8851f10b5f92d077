// K3: pass 1 of the exact per-row top-k of one ROW TILE of the PathSim
// score matrix against every column, for sm_90a.
//
// Replaces the Pallas kernels _topk2_rect_kernel (with
// _extract_group_topk) and _topk2_rect_kernel_kt (with
// _extract_stripe_topk) of distributed_pathsim_tpu/ops/pallas_kernels.py
// (fused_topk_twopass_rect): the streaming sparse tier's hot op and the
// dense tier's rank-all past K1's candidate budget.
//
// What it computes: for rows r of the row factor (t rows, global ids
// row_ids[r]) and every column j of the column factor (n rows), the score
// S = 2 (A B^T) / (d_rows[r] + d_cols[j]) (0 where that is 0), with
// columns >= n_true and the self pair (j == row_ids[r]) at -inf; then,
// for each stripe of stripe_tiles * 128 columns, the row's top-k in the
// order (descending score, ascending column), written to a candidate
// buffer [t, n_stripes, k]. Columns n .. ceil(n / 128) * 128 - 1 are -inf
// padding with their own ids, so every stripe holds at least 128 >= k
// columns. Pass 2 (the stable hierarchical sort ops/sparse.
// chunked_row_topk) reduces the candidates: any row's global top-k
// element is in its stripe's top-k, and the candidates lie in column
// order within equal values, so the result is exact with ties to the
// lowest column. Self pairs are masked in the kernel from row_ids, so k
// candidates per stripe suffice (the TPU kernel keeps k+1 per tile and
// drops the self pair on the candidate list: the same function).
//
// Design: one block owns one unit, a (128-row block, stripe) pair, and
// walks the stripe's 64-column subtiles in order. M comes exact from the
// int8 tensor cores over the factors' u8 limb planes (u8_tile.cuh:
// integer tensor cores, exact by construction; still no TF32), the row
// block's planes resident, the V loop covering the K-tiled Pallas
// variant; each warpgroup scores and selects from its accumulators where
// they lie (topk_list.cuh) while the other warpgroup's product and the
// TMA loads (thread 0 keeps the ring full) run. A row's list (k < 16
// slots) lives in shared memory and is written to the candidate buffer
// once per stripe. The grid is the units in the order the wrapper gives:
// row blocks with the most limbs first, each block's stripes in a row.
// The card starts blocks in that order as SMs free up, so the few slow
// multi-limb units run first and the rest fill in behind them. The
// wrapper (cuda_kernels.rect_stripe_tiles) sizes stripes for about
// RECT_TARGET_UNITS units: enough to balance the SMs, and wide enough
// that a row's list, which restarts per stripe, costs little.
//
// Bound on an H100: operations. A row tile against all columns has no
// symmetry to exploit: 2 t n v u8 operations per limb product, 1.1e12 at
// the config-5 tile (t = 8192, n = 1048576, v = 64), 0.56 ms at the int8
// tensor cores' 1,979 TOP/s (16.4 ms at the f32 CUDA cores' 67 TFLOP/s,
// the bound of the CUDA-core kernel this one replaced), against 0.07 GB
// of limb planes read and the candidates written. At v = 64 each score
// costs 64 multiply-adds on the tensor cores and several instructions
// of scoring and selection on the CUDA cores, so the selection sets the
// pace: a coarse per-row integer bound skips most rows' subtiles whole,
// an exact division-free test (stays_out) keeps almost every other score
// out, and one vote per warp ends most subtiles' selection.
#include <climits>

#include "topk_list.cuh"
#include "u8_tile.cuh"

namespace pathsim {

constexpr int RECT_K_MAX = 16;

// WIDE: the instance with the f64 fold, for a row tile whose row sums do
// not bound every M below 2^31 (u8_tile.cuh); it takes the registers of
// one block an SM, the common instance leaves room for two.
template <bool WIDE>
__global__ void __launch_bounds__(u8::THREADS, WIDE ? 1 : 2)
topk_rect_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const float* __restrict__ d_rows,
                 const int* __restrict__ row_ids, int t,
                 const float* __restrict__ d_cols, int n, int n_true,
                 int v_pad, int k, int stripe_sub, int n_stripes,
                 int n_sub, const int* __restrict__ rb_max,
                 const int* __restrict__ order,
                 const int* __restrict__ sub_max, int n_sub_max,
                 const float* __restrict__ d_min, float* __restrict__ vals,
                 int* __restrict__ cols) {
    extern __shared__ __align__(1024) uint8_t smem[];
    const int rb = order[blockIdx.x / n_stripes];
    const int stripe = blockIdx.x % n_stripes;
    const int sub0 = stripe * stripe_sub;
    const u8::Unit u{sub_max, n_sub_max, rb_max[rb], sub0,
                     min(sub0 + stripe_sub, n_sub), v_pad, WIDE};
    const int row0 = rb * u8::BM;
    u8::Pipe pipe;
    uint8_t* lists = u8::pipe_init(smem, u, &map_a, &map_b, row0, pipe);
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
        r.lv = reinterpret_cast<float*>(lists) + lrow * RECT_K_MAX;
        r.lc_off = u8::BM * RECT_K_MAX;
        list_init(r, k);
    }
    __syncwarp();
    const Ctx ctx{d_cols, row_ids, n, n_true, row0, true};
    consume_rows<WIDE>(u, pipe, ctx, d_min, rows, k);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const long long gi = row0 + local_row(h);
        const long long o = (gi * n_stripes + stripe) * k;
        list_store(rows[h], k, vals + o, cols + o);
    }
}

}  // namespace pathsim

// Launch on `stream`; returns 0, a CUDA error, or a tensor-map error
// (u8_tile.cuh). The caller guarantees t >= 1, n >= 1, 0 <= n_true <= n,
// 1 <= k <= 16, stripe_tiles >= 1, row limb planes [row_planes, t,
// v_pad] and column limb planes [col_planes, n, v_pad] u8 (v_pad a
// multiple of 32; rows v_pad bytes apart, planes *_stride apart),
// rb_max (each block's largest entry) and order over the ceil(t / 128)
// row blocks, sub_max (each subtile's largest entry) over
// the ceil(n / 64) column subtiles, d_min over the ceil(n / 128) * 2
// subtiles the kernel walks (each one's least column denominator, 0
// past n), wide (0 only when every M of the launch is known below 2^31:
// cuda_kernels' largest row sum times largest entry), and buffers of
// t * n_stripes * k
// elements for vals and cols, n_stripes = ceil(ceil(n / 128) /
// stripe_tiles).
extern "C" int pathsim_topk_rect(const void* row_planes, int n_row_planes,
                                 long long row_stride, const float* d_rows,
                                 const int* row_ids, int t,
                                 const void* col_planes, int n_col_planes,
                                 long long col_stride, const float* d_cols,
                                 int n, int n_true, int v_pad, int k,
                                 int stripe_tiles, const int* rb_max,
                                 const int* order, const int* sub_max,
                                 const float* d_min, int wide, float* vals,
                                 int* cols, void* stream) {
    using namespace pathsim;
    CUtensorMap map_a, map_b;
    int rc = pathsim_limb_map(&map_a, row_planes, n_row_planes, t, v_pad,
                              row_stride, u8::BM);
    if (rc == 0)
        rc = pathsim_limb_map(&map_b, col_planes, n_col_planes, n, v_pad,
                              col_stride, u8::BN);
    if (rc != 0) return rc;
    const int per_tile = 128 / u8::BN;
    const int n_ct = (n + 127) / 128;
    const int n_stripes = (n_ct + stripe_tiles - 1) / stripe_tiles;
    const int smem = u8::PIPE_SMEM + u8::BM * RECT_K_MAX * 8;
    const auto kernel = wide ? topk_rect_kernel<true> : topk_rect_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const long long units =
        (long long)((t + u8::BM - 1) / u8::BM) * n_stripes;
    kernel<<<(unsigned)units, u8::THREADS, smem, (cudaStream_t)stream>>>(
        map_a, map_b, d_rows, row_ids, t, d_cols, n, n_true, v_pad, k,
        stripe_tiles * per_tile, n_stripes, n_ct * per_tile, rb_max, order,
        sub_max, (n + u8::BN - 1) / u8::BN, d_min, vals, cols);
    return (int)cudaGetLastError();
}
