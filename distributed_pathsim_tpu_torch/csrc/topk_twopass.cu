// K1: pass 1 of the exact two-pass per-row top-k of the PathSim score
// matrix, for sm_90a.
//
// Replaces the Pallas kernels _topk2_kernel and _topk2_kernel_kt of
// distributed_pathsim_tpu/ops/pallas_kernels.py (fused_topk_twopass): the
// main path's rank-all for k <= 16.
//
// What it computes: S = 2 (C C^T) / (d_i + d_j) (0 where that is 0) with
// the self pair at -inf when mask_self; then, for each stripe of
// stripe_tiles * 128 columns, each row's top-k in the order (descending
// score, ascending column), written to a candidate buffer [n, n_stripes,
// k]. Columns n .. ceil(n / 128) * 128 - 1 are -inf padding with their
// own ids, so every stripe holds at least 128 >= k columns and a row
// never repeats a column. Pass 2 (the stable hierarchical sort
// ops/sparse.chunked_row_topk) reduces the candidates: any row's global
// top-k element is in its stripe's top-k, and the candidates lie in
// column order within equal values (stripes ascending, each stripe's
// list in (value, column) order), so the result is exact with ties to
// the lowest global column.
//
// Design: K3's (topk_rect.cu) on the square factor. One block owns one
// (128-row block, stripe) unit and walks the stripe's 64-column
// subtiles. M comes exact from the int8 tensor cores over the factor's
// u8 limb planes (u8_tile.cuh: integer tensor cores, exact by
// construction; still no TF32), the row block's planes resident while
// they fit, the V loop covering the K-tiled Pallas variant; each
// warpgroup scores and selects from its accumulators where they lie
// (topk_list.cuh: a coarse per-row integer bound, an exact
// division-free test, one warp vote) while the other warpgroup's product
// and the TMA loads run. A row's list (k <= 16 slots) lives in shared
// memory for the whole stripe and is written to the candidate buffer
// once. Row blocks with the most limbs launch first. Each row block takes
// its own instance: the few whose row sums leave M unbounded below 2^31
// (the Zipf head) the one with the f64 fold, on a side stream beside the
// launch of the rest, which runs two blocks an SM. The stripe width is
// the wrapper's (cuda_kernels.TWOPASS_STRIPE_TILES): a row's list
// restarts per stripe, and the first subtile of each stripe is scored
// in full while the list fills, so wide stripes cost less selection;
// pass 2 reads n_stripes * k candidates a row.
//
// Bound on an H100: operations. S is symmetric, so the function needs the
// n (n + 1) / 2 upper-triangle dot products: n (n + 1) v u8 operations
// per limb product, 4.1e11 at the rank-all shape (n = 32768, v = 384),
// 0.21 ms at the int8 tensor cores' 1,979 TOP/s (6.15 ms at the f32
// CUDA cores' 67 TFLOP/s, the bound of the CUDA-core kernel this one
// replaced), against ~13 MB of limb planes read and n * n_stripes * k * 8
// bytes of candidates written. The kernel does every tile, 2 n^2 v. The
// tensor cores leave the pace to the selection on the CUDA cores, as in
// K3 and K4.
#include <climits>

#include "topk_list.cuh"
#include "u8_tile.cuh"

namespace pathsim {

// WIDE: the instance with the f64 fold, for the row blocks whose row sums
// do not bound every M of theirs below 2^31 (u8_tile.cuh); it takes the
// registers of one block an SM, the common instance leaves room for two.
template <bool WIDE>
__global__ void __launch_bounds__(u8::THREADS, WIDE ? 1 : 2)
topk_twopass_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const float* __restrict__ d, int n, int v_pad, int k,
                    int mask_self, const StripeGrid g,
                    float* __restrict__ vals, int* __restrict__ cols) {
    // the self column of a row is the row itself (self_ids == nullptr)
    const Ctx ctx{d, nullptr, n, n, 0, mask_self != 0};
    stripe_topk<WIDE>(&map_a, &map_b, d, n, ctx, g, v_pad, k, vals, cols);
}

// The exact instance (exact counts below 2^53; topk_list.cuh's exact
// section): f64 values 2 M / (d_i + d_j) of the exact M and the
// exact row sums d64 (d32: their f32 roundings, the prefilter's), and
// the count of elements scored in f64 added to *scored (null: none).
template <bool WIDE>
__global__ void __launch_bounds__(u8::THREADS, WIDE ? 1 : 2)
topk_twopass_exact_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          const double* __restrict__ d64,
                          const float* __restrict__ d32, int n, int v_pad,
                          int k, int mask_self, const StripeGrid g,
                          double* __restrict__ vals, int* __restrict__ cols,
                          unsigned long long* scored) {
    const Ctx64 ctx{{d32, nullptr, n, n, 0, mask_self != 0}, d64};
    stripe_topk64<WIDE>(&map_a, &map_b, d64, d32, n, ctx, g, v_pad, k, vals,
                        cols, scored);
}

}  // namespace pathsim

// Launch the wide row blocks on `wide_stream`, then the narrow ones on
// `stream` (the caller forks and joins the two streams, or passes the
// same one twice); returns 0, a CUDA error, or a tensor-map error
// (u8_tile.cuh). The caller guarantees n >= 1, 1 <= k <= 16,
// stripe_tiles >= 1, limb planes [n_planes, n, v_pad] u8 (v_pad a
// multiple of 32; rows v_pad bytes apart, planes plane_stride apart),
// rb_max (each block's largest entry) over the ceil(n / 128) row blocks,
// which wide_order (n_wide of them) and narrow_order (n_narrow) split
// between them, each in launch order: a block is narrow only when every M
// of its rows is known below 2^31 (cuda_kernels: the block's largest row
// sum times the factor's largest entry, or the other way round), sub_max
// (each subtile's largest entry) over the ceil(n / 64) subtiles, d_min
// over the ceil(n / 128) * 2 subtiles the kernel walks (each one's least
// denominator, 0 past n), and buffers of n * n_stripes * k elements for
// vals and cols, n_stripes = ceil(ceil(n / 128) / stripe_tiles).
extern "C" int pathsim_topk_twopass(const void* planes, int n_planes,
                                    long long plane_stride, int v_pad,
                                    const float* d, int n, int k,
                                    int mask_self, int stripe_tiles,
                                    const int* rb_max, const int* wide_order,
                                    int n_wide, const int* narrow_order,
                                    int n_narrow, const int* sub_max,
                                    const float* d_min, float* vals,
                                    int* cols, void* wide_stream,
                                    void* stream) {
    using namespace pathsim;
    CUtensorMap map_a, map_b;
    int rc = pathsim_limb_map(&map_a, planes, n_planes, n, v_pad,
                              plane_stride, u8::BM);
    if (rc == 0)
        rc = pathsim_limb_map(&map_b, planes, n_planes, n, v_pad,
                              plane_stride, u8::BN);
    if (rc != 0) return rc;
    for (int wide = 1; wide >= 0; --wide) {
        const int blocks = wide ? n_wide : n_narrow;
        if (blocks == 0) continue;
        long long units;
        const StripeGrid g = pathsim_stripe_grid(
            blocks, n, stripe_tiles, rb_max, wide ? wide_order : narrow_order,
            sub_max, d_min, &units);
        const auto kernel =
            wide ? topk_twopass_kernel<true> : topk_twopass_kernel<false>;
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, STRIPE_SMEM);
        if (err != cudaSuccess) return (int)err;
        kernel<<<(unsigned)units, u8::THREADS, STRIPE_SMEM,
                 (cudaStream_t)(wide ? wide_stream : stream)>>>(
            map_a, map_b, d, n, v_pad, k, mask_self, g, vals, cols);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

// pathsim_topk_twopass for the exact instance: d64 the exact row sums
// (integers below 2^52), d32 their f32 roundings (d_min is over d32), vals
// f64, and scored a device counter the launch adds its f64 scorings to
// (or null).
extern "C" int pathsim_topk_twopass_exact(
    const void* planes, int n_planes, long long plane_stride, int v_pad,
    const double* d64, const float* d32, int n, int k, int mask_self,
    int stripe_tiles, const int* rb_max, const int* wide_order, int n_wide,
    const int* narrow_order, int n_narrow, const int* sub_max,
    const float* d_min, double* vals, int* cols, unsigned long long* scored,
    void* wide_stream, void* stream) {
    using namespace pathsim;
    CUtensorMap map_a, map_b;
    int rc = pathsim_limb_map(&map_a, planes, n_planes, n, v_pad,
                              plane_stride, u8::BM);
    if (rc == 0)
        rc = pathsim_limb_map(&map_b, planes, n_planes, n, v_pad,
                              plane_stride, u8::BN);
    if (rc != 0) return rc;
    const int smem = stripe_smem64(k);
    for (int wide = 1; wide >= 0; --wide) {
        const int blocks = wide ? n_wide : n_narrow;
        if (blocks == 0) continue;
        long long units;
        const StripeGrid g = pathsim_stripe_grid(
            blocks, n, stripe_tiles, rb_max, wide ? wide_order : narrow_order,
            sub_max, d_min, &units);
        const auto kernel = wide ? topk_twopass_exact_kernel<true>
                                 : topk_twopass_exact_kernel<false>;
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        kernel<<<(unsigned)units, u8::THREADS, smem,
                 (cudaStream_t)(wide ? wide_stream : stream)>>>(
            map_a, map_b, d64, d32, n, v_pad, k, mask_self, g, vals, cols,
            scored);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
