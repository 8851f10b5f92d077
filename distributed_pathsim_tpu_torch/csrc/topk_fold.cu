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
// idxs [n, k]. Columns n .. ceil(max(n, k) / 128) * 128 - 1 are -inf
// padding with their own ids, so a row with fewer than k finite scores
// gets distinct ascending -inf columns (the Pallas fold repeats an index
// in such slots instead: after a slot is taken its value becomes -inf and
// the next round can take the same position again).
//
// Design: one block owns 128 rows (two consumer warpgroups of 64; thread
// 0 also keeps the TMA ring full) and walks every 64-column subtile in
// order, the TPU's sequential grid axis becoming a loop inside the
// block. M comes exact from the int8 tensor cores over the factor's u8
// limb planes (u8_tile.cuh: integer tensor cores, exact by construction;
// still no TF32), the row block's planes resident while they fit, the V
// loop covering the K-tiled Pallas variant. Each warpgroup then scores
// and selects from its accumulators where they lie (topk_list.cuh)
// while the other warpgroup's product and the TMA loads run. A row's
// list lives in shared memory while k <= SMEM_K_MAX (the 227 KB a block
// may take, less the pipeline's ring, over 128 rows of 8-byte slots:
// k <= 137; two blocks share an SM while k is small), else in its slice
// of the output in device memory; the merge code is the same for both.
// Row blocks are launched in the order the wrapper gives, those with the
// most limbs first, so they do not trail the launch. Each row block takes
// its own instance: the few whose row sums leave M unbounded below 2^31
// (the Zipf head) the one with the f64 fold, on a side stream beside the
// launch of the rest. Exact counts past f32's exact integers (2^24, up
// to 2^53) take the exact instances instead: f64 scores of the exact M
// and row sums, behind an f32 prefilter (topk_list.cuh).
//
// Bound on an H100: operations. S is symmetric, so the function needs the
// n (n + 1) / 2 upper-triangle dot products: n (n + 1) v u8 operations
// per limb product, 4.1e11 at the bench shape (n = 32768, v = 384),
// 0.21 ms at the int8 tensor cores' 1,979 TOP/s (6.15 ms at the f32
// CUDA cores' 67 TFLOP/s, the bound of the CUDA-core kernel this one
// replaced), against ~13 MB of limb planes read and n k 8 bytes of
// output. The kernel does every tile, 2 n^2 v. The tensor cores leave
// the pace to the selection on the CUDA cores: an exact division-free
// test keeps almost every score out of it, after a coarse per-row
// integer bound has skipped most rows' subtiles whole (topk_list.cuh).
#include <climits>

#include "topk_list.cuh"
#include "u8_tile.cuh"

namespace pathsim {

constexpr int SMEM_K_MAX = (227 * 1024 - u8::PIPE_SMEM) / (u8::BM * 8);

// SMEM_LISTS: the lists in shared memory (k <= SMEM_K_MAX), else in the
// output. WIDE: the instance with the f64 fold, for the row blocks whose
// row sums do not bound every M of theirs below 2^31 (u8_tile.cuh). Two
// blocks share an SM in the common instance (lists in shared memory, no
// f64 fold); the others take the registers of one block an SM.
template <bool SMEM_LISTS, bool WIDE>
__global__ void __launch_bounds__(u8::THREADS, SMEM_LISTS && !WIDE ? 2 : 1)
topk_fold_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const float* __restrict__ d, int n, int v_pad, int k,
                 int mask_self, int n_sub, const int* __restrict__ rb_max,
                 const int* __restrict__ order,
                 const int* __restrict__ sub_max, int n_sub_max,
                 const float* __restrict__ d_min, float* __restrict__ vals,
                 int* __restrict__ idxs) {
    extern __shared__ __align__(1024) uint8_t smem[];
    const int rb = order[blockIdx.x];
    const u8::Unit u{sub_max, n_sub_max, rb_max[rb], 0, n_sub, v_pad, WIDE};
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
        r.valid = gi < n;
        r.di = r.valid ? d[gi] : 0.0f;
        if (SMEM_LISTS) {
            r.lv = reinterpret_cast<float*>(lists) + lrow * k;
            r.lc_off = u8::BM * k;
        } else {  // idxs lies n * k slots after vals (the wrapper's buffer)
            r.lv = vals + (long long)(r.valid ? gi : 0) * k;
            r.lc_off = n * k;
        }
        list_init(r, k);
    }
    __syncwarp();
    const Ctx ctx{d, nullptr, n, n, row0, mask_self != 0};
    consume_rows<WIDE>(u, pipe, ctx, d_min, rows, k);
    if (SMEM_LISTS) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long gi = row0 + local_row(h);
            list_store(rows[h], k, vals + gi * k, idxs + gi * k);
        }
    }
}

// Lists of the exact instance in shared memory up to this k (12-byte
// slots).
constexpr int SMEM_K_MAX64 = (227 * 1024 - u8::PIPE_SMEM) / (u8::BM * 12);

// The exact instance (exact counts below 2^53; topk_list.cuh's exact
// section): f64 values 2 M / (d_i + d_j) of the exact M and the exact row
// sums d64 (d32: their f32 roundings, the prefilter's). Without
// SMEM_LISTS the lists lie in the output: idxs n * k slots of 8 bytes
// after vals.
template <bool SMEM_LISTS, bool WIDE>
__global__ void __launch_bounds__(u8::THREADS, SMEM_LISTS && !WIDE ? 2 : 1)
topk_fold_exact_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const double* __restrict__ d64,
                       const float* __restrict__ d32, int n, int v_pad,
                       int k, int mask_self, int n_sub,
                       const int* __restrict__ rb_max,
                       const int* __restrict__ order,
                       const int* __restrict__ sub_max, int n_sub_max,
                       const float* __restrict__ d_min,
                       double* __restrict__ vals, int* __restrict__ idxs) {
    extern __shared__ __align__(1024) uint8_t smem[];
    const int rb = order[blockIdx.x];
    const u8::Unit u{sub_max, n_sub_max, rb_max[rb], 0, n_sub, v_pad, WIDE};
    const int row0 = rb * u8::BM;
    u8::Pipe pipe;
    uint8_t* lists = u8::pipe_init(smem, u, &map_a, &map_b, row0, pipe);
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
        r.valid = gi < n;
        r.di = r.valid ? d64[gi] : 0.0;
        r.di32 = r.valid ? d32[gi] : 0.0f;
        if (SMEM_LISTS)
            list_at64(r, reinterpret_cast<double*>(lists), u8::BM, lrow, k);
        else  // the output's rows: vals [n][k], then idxs [n][k]
            list_at64(r, vals, n, r.valid ? gi : 0, k);
        list_init64(r, k);
    }
    __syncwarp();
    const Ctx64 ctx{{d32, nullptr, n, n, row0, mask_self != 0}, d64};
    unsigned scored = 0;  // not reported by K4
    consume_rows64<WIDE>(u, pipe, ctx, d_min, rows, k, scored);
    if (SMEM_LISTS) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long gi = row0 + local_row(h);
            list_store64(rows[h], k, vals + gi * k, idxs + gi * k);
        }
    }
}

}  // namespace pathsim

// Launch the wide row blocks on `wide_stream`, then the narrow ones on
// `stream` (the caller forks and joins the two streams, or passes the
// same one twice); returns 0, a CUDA error, or a tensor-map error
// (u8_tile.cuh). The caller guarantees n >= 1, k >= 1, limb planes
// [n_planes, n, v_pad] u8 (v_pad a multiple of 32; rows v_pad bytes
// apart, planes plane_stride apart), rb_max (each block's largest
// entry) over the ceil(n / 128) row blocks, which wide_order (n_wide of
// them) and narrow_order (n_narrow) split between them, each in launch
// order: a block is narrow only when every M of its rows is known below
// 2^31 (cuda_kernels: the block's largest row sum times the factor's
// largest entry, or the other way round), sub_max (each subtile's
// largest entry) over the ceil(n / 64) subtiles, d_min over every
// subtile the kernel walks (ceil(max(n, k) / 128) * 2: each subtile's
// least denominator, 0 past n), and buffers of n * k elements for vals
// and idxs, idxs starting n * k slots after vals (one buffer: the lists
// in the output reach their columns by that offset; n * k < 2^31).
extern "C" int pathsim_topk_fold(const void* planes, int n_planes,
                                 long long plane_stride, int v_pad,
                                 const float* d, int n, int k, int mask_self,
                                 const int* rb_max, const int* wide_order,
                                 int n_wide, const int* narrow_order,
                                 int n_narrow, const int* sub_max,
                                 const float* d_min, float* vals, int* idxs,
                                 void* wide_stream, void* stream) {
    using namespace pathsim;
    CUtensorMap map_a, map_b;
    int rc = pathsim_limb_map(&map_a, planes, n_planes, n, v_pad,
                              plane_stride, u8::BM);
    if (rc == 0)
        rc = pathsim_limb_map(&map_b, planes, n_planes, n, v_pad,
                              plane_stride, u8::BN);
    if (rc != 0) return rc;
    const int width = n > k ? n : k;
    const int n_sub = (width + 127) / 128 * (128 / u8::BN);
    const bool smem_lists = k <= SMEM_K_MAX;
    const int smem = u8::PIPE_SMEM + (smem_lists ? u8::BM * k * 8 : 0);
    const int n_sub_max = (n + u8::BN - 1) / u8::BN;
    for (int wide = 1; wide >= 0; --wide) {
        const int blocks = wide ? n_wide : n_narrow;
        if (blocks == 0) continue;
        const auto kernel =
            smem_lists ? (wide ? topk_fold_kernel<true, true>
                               : topk_fold_kernel<true, false>)
                       : (wide ? topk_fold_kernel<false, true>
                               : topk_fold_kernel<false, false>);
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<(unsigned)blocks, u8::THREADS, smem,
                 (cudaStream_t)(wide ? wide_stream : stream)>>>(
            map_a, map_b, d, n, v_pad, k, mask_self, n_sub, rb_max,
            wide ? wide_order : narrow_order, sub_max, n_sub_max, d_min,
            vals, idxs);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// pathsim_topk_fold for the exact instance: d64 the exact row sums
// (integers below 2^52), d32 their f32 roundings (d_min is over d32),
// vals f64 and idxs int32 in one buffer, idxs starting 2 * n * k 4-byte
// slots after vals (2 * n * k < 2^31).
extern "C" int pathsim_topk_fold_exact(
    const void* planes, int n_planes, long long plane_stride, int v_pad,
    const double* d64, const float* d32, int n, int k, int mask_self,
    const int* rb_max, const int* wide_order, int n_wide,
    const int* narrow_order, int n_narrow, const int* sub_max,
    const float* d_min, double* vals, int* idxs, void* wide_stream,
    void* stream) {
    using namespace pathsim;
    CUtensorMap map_a, map_b;
    int rc = pathsim_limb_map(&map_a, planes, n_planes, n, v_pad,
                              plane_stride, u8::BM);
    if (rc == 0)
        rc = pathsim_limb_map(&map_b, planes, n_planes, n, v_pad,
                              plane_stride, u8::BN);
    if (rc != 0) return rc;
    const int width = n > k ? n : k;
    const int n_sub = (width + 127) / 128 * (128 / u8::BN);
    const bool smem_lists = k <= SMEM_K_MAX64;
    const int smem = u8::PIPE_SMEM + (smem_lists ? u8::BM * k * 12 : 0);
    const int n_sub_max = (n + u8::BN - 1) / u8::BN;
    for (int wide = 1; wide >= 0; --wide) {
        const int blocks = wide ? n_wide : n_narrow;
        if (blocks == 0) continue;
        const auto kernel =
            smem_lists ? (wide ? topk_fold_exact_kernel<true, true>
                               : topk_fold_exact_kernel<true, false>)
                       : (wide ? topk_fold_exact_kernel<false, true>
                               : topk_fold_exact_kernel<false, false>);
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<(unsigned)blocks, u8::THREADS, smem,
                 (cudaStream_t)(wide ? wide_stream : stream)>>>(
            map_a, map_b, d64, d32, n, v_pad, k, mask_self, n_sub, rb_max,
            wide ? wide_order : narrow_order, sub_max, n_sub_max, d_min,
            vals, idxs);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
