// The exact integer tile product of the PathSim top-k kernels K3 and K4
// (sm_90a): M = A B^T for nonnegative integer path counts below 2^24, on
// the int8 tensor cores (wgmma .s32.u8.u8), fed by TMA.
//
// Inputs. The wrapper (ops/cuda_kernels.split_limbs) splits each factor
// once into u8 limb planes, c = l0 + 256 l1 + 65536 l2, planes [L, n,
// v_pad] (v_pad a multiple of 32, zero padded), and keeps each row's limb
// count; per 128-row block (rows) and per 64-row tile (columns) the
// kernels read the most limbs any row there needs.
//
// Exactness, in full:
// 1. Limbs are exact: every entry is an integer in [0, 2^24) (the wrapper
//    raises otherwise), so its three base-256 digits are exact u8 values.
// 2. M = sum_{p,q} 2^(8(p+q)) A_p B_q^T, with A_p, B_q the limb planes.
//    Each u8 x u8 product and each s32 sum of the tensor cores is integer
//    arithmetic, exact while it stays below 2^31.
// 3. A "narrow" tile pair has every M below 2^31, so every partial sum on
//    the way to it too (all terms are nonnegative): a pair whose rows the
//    wrapper has cleared (M_ij <= (row sum of row i) * (largest entry of
//    row j), and the other way round; cuda_kernels checks the largest of
//    these on the host: for each 128-row block against every column in
//    K1 and K4, which launch the cleared blocks on the instance without
//    the f64 fold, once a launch in K2 and K3), or one with v_pad *
//    (largest row entry) * (largest column entry) < 2^31. Its limb products go
//    into one s32 accumulator, Horner fashion: for the shift s = p + q
//    from the highest down, acc = 256 acc + (the products of shift s).
//    With one limb each that is the plain product.
//    Any other pair sums the products that share a shift in one s32
//    accumulator over at most FOLD_CHUNKS chunks of 128 bytes of V (8192
//    values): at most 3 products (p, q) share a shift, so the sum is at
//    most 255^2 * 8192 * 3 = 1.6e9 < 2^31. Then it is folded into an f64
//    sum, wide += acc * 2^(8s): the product by a power of two is exact,
//    and so is the f64 sum while M < 2^53 (f64 holds every integer
//    below it; M >= 2^53 would need counts far past any graph here).
// 4. One correctly rounded conversion to f32 (the exact s32 below 2^23
//    by adding it to 2^23 in the bits, __int2float_rn above, or
//    __double2float_rn of the exact f64 value). Below 2^24 it is exact,
//    so M equals the plain version's f32 C C^T bit for bit (every f32
//    partial sum of nonnegative integers below 2^24 is exact too). Past
//    2^24 (--approx) it is the correctly rounded exact value.
// 5. One correctly rounded division in normalize() (topk_list.cuh; built
//    with -prec-div=true and no fast math). No TF32 anywhere.
//
// Machinery. A block of 256 threads has two consumer warpgroups, each
// owning 64 rows (wgmma's M) of the block's 128, and walks 64-column
// subtiles (wgmma's N). u8 operands must be K-major, and the planes are
// [rows, V] row-major: both already are. TMA loads 128-byte V chunks into
// the 128-byte swizzled layout that the wgmma descriptors name. While the
// row block's planes fit 48 KB they are loaded once and stay resident,
// and a ring of RES_STAGES stages carries the column chunks; otherwise
// each of STAGED_STAGES stages carries a row chunk and a column chunk.
// Thread 0 is also the producer: it keeps the ring full in the
// consumers' order, each time its own warpgroup releases a stage, its
// place in the walk kept in shared memory (a dedicated producer warp
// would make the block 288 threads, and two such blocks only fit an SM
// at 96 registers a thread). The two warpgroups run independently, so
// one warpgroup's selection overlaps the other's product and the loads.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pathsim {
namespace u8 {

constexpr int BM = 128;          // rows of a block (two warpgroups of 64)
constexpr int BN = 64;           // columns of a subtile (wgmma N)
constexpr int CHUNK = 128;       // bytes of V per stage (one swizzle row)
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS;       // thread 0 is also the producer
constexpr int A_BYTES = BM * CHUNK;      // 16 KB
constexpr int B_BYTES = BN * CHUNK;      // 8 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // a stage with its A chunk
// The stage ring's shared memory (88 KB: with the lists, two blocks fit
// on an SM). While a row block's limb planes fit RES_CHUNKS chunks
// (lr * ceil(v_pad / 128) <= 3: every one-limb block up to V = 384, and
// every block at V <= 128) they stay resident in its first 48 KB, loaded
// once, and the ring holds RES_STAGES B chunks; otherwise the ring holds
// STAGED_STAGES stages of an A and a B chunk.
constexpr int RING_BYTES = 88 * 1024;
constexpr int RES_CHUNKS = 3;
constexpr int RES_STAGES = (RING_BYTES - RES_CHUNKS * A_BYTES) / B_BYTES;
constexpr int STAGED_STAGES = RING_BYTES / STAGE_BYTES;
constexpr int MAX_STAGES = RES_STAGES;
constexpr int FOLD_CHUNKS = 64;  // V chunks per s32 accumulation group
constexpr int ACC = BN / 2;      // s32 accumulators a thread (m64n64)
constexpr int QUARTERS = 4;      // column parts of the wide path (m64n16)

// -- barriers, TMA, wgmma ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(b)) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
    const uint32_t addr = smem_u32(b);
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } while (!done);
}

// One box of a 3-D tensor map [planes, rows, v_pad] (innermost last)
// into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y,
                                         int z) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(z)
        : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in
// the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups
// 1024 bytes apart; the tile starts 1024-byte aligned. Adding 2 advances
// the start by 32 bytes, one k32 step of u8.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    const uint64_t a = smem_u32(p);
    return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous product's fence and wait.
template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (+)= A[64 x 32] * B[64 x 32]^T, u8 x u8 -> s32, exact; d is
// overwritten when accumulate == 0.
__device__ __forceinline__ void wgmma_u8(int (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// The m64n16k32 form: d (+)= A[64 x 32] * B[16 x 32]^T.
__device__ __forceinline__ void wgmma_u8(int (&d)[8], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
}

// -- the pipeline -------------------------------------------------------------

// The limb pairs (p, q) of shift s with p < lr, q < lc.
__device__ __forceinline__ int p_lo(int s, int lc) { return max(0, s - lc + 1); }
__device__ __forceinline__ int p_hi(int s, int lr) { return min(s, lr - 1); }

// Limbs of an entry bound: 1, 2 or 3.
__device__ __forceinline__ int limbs_of(int max_entry) {
    return 1 + (max_entry >= 256) + (max_entry >= 65536);
}

// The largest entry of column subtile `sub` (0 past the factor's
// subtiles: zero padding).
__device__ __forceinline__ int sub_max_at(const int* __restrict__ sub_max,
                                          int n_sub_max, int sub) {
    return sub < n_sub_max ? sub_max[sub] : 0;
}

// A tile pair is "narrow" when every M of it is known to stay below 2^31:
// in a row block the wrapper has cleared (Unit::wide false: the row
// sums bound every M of the block's rows, see the top of this file), or
// when v_pad * (largest row entry) * (largest column entry) < 2^31. Then
// every partial sum on the way to M is below 2^31 too, and one s32
// accumulator takes all the limb products, Horner fashion: for s from
// the highest shift down, acc = 256 acc + (the products of shift s). The
// few other pairs fold each shift's s32 sums into f64 (see the top of
// this file), once per 16-column quarter of the subtile (m64n16: 8
// accumulators and 8 f64 sums a thread).
__device__ __forceinline__ bool narrow_pair(int amax, int bmax, int v_pad) {
    return (long long)amax * bmax < (0x7fffffffLL + v_pad - 1) / v_pad;
}

// The producer's place in the walk over a unit's stages, in shared
// memory: only thread 0 touches it, and keeping it out of registers
// keeps it off every consumer thread's register budget.
struct Feed {
    const CUtensorMap* map_a;  // the row factor's planes
    const CUtensorMap* map_b;  // the column factor's planes
    int row0;
    int sub, part, passes, lc, gsz, s, g0, p, ch;  // the next stage to load
    int issued;                                    // stages loaded so far
    int stage;                                     // its ring slot
    unsigned phase;
};

// What every thread of a block knows of its unit: the row block's
// largest entry (so its limbs, and whether its planes stay resident),
// the subtile range and the planes' width. (The producer's own needs,
// the tensor maps and the row block's first row, wait in the Feed.)
struct Unit {
    const int* sub_max;
    int n_sub_max, amax, sub0, sub1, v_pad;
    bool wide;  // some pair of the row block may pass the s32 bound

    __device__ bool narrow(int bmax) const {
        return !wide || narrow_pair(amax, bmax, v_pad);
    }

    __device__ int lr() const { return limbs_of(amax); }
    __device__ int n_chunks() const { return (v_pad + CHUNK - 1) / CHUNK; }
    __device__ bool resident() const { return lr() * n_chunks() <= RES_CHUNKS; }
    __device__ int stages() const {
        return resident() ? RES_STAGES : STAGED_STAGES;
    }
};

// The ring in dynamic shared memory (RING_BYTES, 1024-byte aligned),
// then full[MAX_STAGES] (the producer's expect_tx + the TMA bytes),
// empty[MAX_STAGES] (one arrival from each of the 8 consumer warps once
// its product has read the stage), rows_full (the resident planes), and
// the Feed. idx counts the stages this thread has consumed.
struct Pipe {
    uint8_t* base;
    int s = 0;
    unsigned phase = 0;
    int idx = 0;

    __device__ uint64_t* full() const {
        return reinterpret_cast<uint64_t*>(base + RING_BYTES);
    }
    __device__ uint64_t* empty() const { return full() + MAX_STAGES; }
    __device__ uint64_t* rows_full() const { return empty() + MAX_STAGES; }
    __device__ Feed* feed() const {
        return reinterpret_cast<Feed*>(rows_full() + 1);
    }
    __device__ void advance(int stages) {
        ++idx;
        if (++s == stages) {
            s = 0;
            phase ^= 1u;
        }
    }
    // Stage slot i's A chunk (staged) and B chunk.
    __device__ uint8_t* a_at(int i) const { return base + i * STAGE_BYTES; }
    __device__ uint8_t* b_at(bool resident, int i) const {
        return resident ? base + RES_CHUNKS * A_BYTES + i * B_BYTES
                        : a_at(i) + A_BYTES;
    }
};

// Dynamic shared memory before the lists: the ring, the barriers, the
// Feed and the alignment slack.
constexpr int PIPE_SMEM = RING_BYTES + 256 + 1024;

// The Feed at the first stage of subtile f.sub.
__device__ __forceinline__ void feed_subtile(const Unit& u, Feed& f) {
    const int bmax = sub_max_at(u.sub_max, u.n_sub_max, f.sub);
    const bool narrow = u.narrow(bmax);
    f.lc = limbs_of(bmax);
    f.passes = narrow ? 1 : QUARTERS;
    f.gsz = narrow ? u.n_chunks() : FOLD_CHUNKS;
    f.part = f.g0 = f.ch = 0;
    f.s = u.lr() + f.lc - 2;
    f.p = p_lo(f.s, f.lc);
}

// Lay out the pipeline at the start of dynamic shared memory and return
// the first byte after it (the lists' space). Thread 0 initializes the
// barriers and the Feed; the caller syncs the block before using them.
__device__ __forceinline__ uint8_t* pipe_init(uint8_t* smem, const Unit& u,
                                              const CUtensorMap* map_a,
                                              const CUtensorMap* map_b,
                                              int row0, Pipe& p) {
    const uint32_t base = smem_u32(smem);
    p.base = smem + ((1024 - (base & 1023)) & 1023);
    if (threadIdx.x == 0) {
        for (int i = 0; i < MAX_STAGES; ++i) {
            mbar_init(&p.full()[i], 1);
            mbar_init(&p.empty()[i], CONSUMERS / 32);
        }
        mbar_init(p.rows_full(), 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        Feed& f = *p.feed();
        f.map_a = map_a;
        f.map_b = map_b;
        f.row0 = row0;
        f.sub = u.sub0;
        f.issued = 0;
        f.stage = 0;
        f.phase = 0;
        if (f.sub < u.sub1) feed_subtile(u, f);
    }
    return smem + PIPE_SMEM;
}

// Producer (thread 0 only), once per unit: the resident row planes.
__device__ __forceinline__ void load_rows(const Unit& u, const Pipe& pipe) {
    if (!u.resident()) return;
    uint64_t* bar = pipe.rows_full();
    const Feed& f = *pipe.feed();
    const int n_chunks = u.n_chunks();
    mbar_expect_tx(bar, u.lr() * n_chunks * A_BYTES);
    for (int p = 0; p < u.lr(); ++p)
        for (int ch = 0; ch < n_chunks; ++ch)
            tma_load(pipe.base + (p * n_chunks + ch) * A_BYTES, f.map_a,
                     bar, ch * CHUNK, f.row0, p);
}

// Producer (thread 0 only): load stages in the consumers' order until
// `limit` stages are loaded or the unit's are all. The consumers' order,
// per subtile: (quarter on the wide path, shift s from the highest down,
// V group g0, limb pair p, V chunk ch). A load waits for its ring slot
// to be released by both warpgroups; the caller only asks for slots its
// own warpgroup has released, so the wait is on the other warpgroup
// alone, which never waits on this one's loads past them: no deadlock.
__device__ __forceinline__ void feed_stages(const Unit& u, const Pipe& pipe,
                                            int limit) {
    Feed& f = *pipe.feed();
    const bool resident = u.resident();
    const int n_chunks = u.n_chunks();
    const int lr = u.lr();
    while (f.issued < limit && f.sub < u.sub1) {
        mbar_wait(&pipe.empty()[f.stage], f.phase ^ 1u);
        uint64_t* bar = &pipe.full()[f.stage];
        if (resident) {
            mbar_expect_tx(bar, B_BYTES);
        } else {
            mbar_expect_tx(bar, STAGE_BYTES);
            tma_load(pipe.a_at(f.stage), f.map_a, bar, f.ch * CHUNK, f.row0,
                     f.p);
        }
        tma_load(pipe.b_at(resident, f.stage), f.map_b, bar, f.ch * CHUNK,
                 f.sub * BN, f.s - f.p);
        if (++f.stage == u.stages()) {
            f.stage = 0;
            f.phase ^= 1u;
        }
        ++f.issued;
        // the next stage
        if (++f.ch < min(n_chunks, f.g0 + f.gsz)) continue;
        if (++f.p <= p_hi(f.s, lr)) {
            f.ch = f.g0;
            continue;
        }
        f.g0 += f.gsz;
        if (f.g0 < n_chunks) {
            f.p = p_lo(f.s, f.lc);
            f.ch = f.g0;
            continue;
        }
        f.g0 = f.ch = 0;
        if (--f.s >= 0) {
            f.p = p_lo(f.s, f.lc);
            continue;
        }
        if (++f.part < f.passes) {
            f.s = lr + f.lc - 2;
            f.p = p_lo(f.s, f.lc);
            continue;
        }
        if (++f.sub < u.sub1) feed_subtile(u, f);
    }
}

// Release the stage of consumed index `done` (one arrival per warp) and,
// on thread 0, load the stages its release lets this warpgroup's side
// of the ring take.
__device__ __forceinline__ void release(const Unit& u, const Pipe& pipe,
                                        int slot, int done) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&pipe.empty()[slot]);
    if (threadIdx.x == 0) feed_stages(u, pipe, done + 1 + u.stages());
}

// The products of shift s over V chunks [g0, g1): every limb pair (p,
// s - p) and chunk of it, each stage released once its product has read
// it. acc starts at 0 when `zero`, else the products add to it. NACC =
// 32 is the m64n64 product, 8 the m64n16 product of the B quarter at
// b_off (descriptor units of 16 bytes).
template <int NACC>
__device__ __forceinline__ void product_group(const Unit& u, Pipe& pipe,
                                              int wg, int s, int lc,
                                              int g0, int g1, int b_off,
                                              bool zero, int (&acc)[NACC]) {
    const bool resident = u.resident();
    const int n_chunks = u.n_chunks();
    int prev = -1;
    int first = zero;
    for (int p = p_lo(s, lc); p <= p_hi(s, u.lr()); ++p)
        for (int ch = g0; ch < g1; ++ch) {
            mbar_wait(&pipe.full()[pipe.s], pipe.phase);
            __syncwarp();  // converged for the .aligned wgmma
            const uint8_t* a = resident
                                   ? pipe.base + (p * n_chunks + ch) * A_BYTES
                                   : pipe.a_at(pipe.s);
            const uint64_t da = sw128_desc(a + wg * (A_BYTES / 2));
            const uint64_t db = sw128_desc(pipe.b_at(resident, pipe.s)) + b_off;
            const int nk = min(CHUNK, u.v_pad - ch * CHUNK) / 32;
            fence_acc(acc);
            wgmma_fence();
            for (int kk = 0; kk < nk; ++kk)
                wgmma_u8(acc, da + 2 * kk, db + 2 * kk, !(first && kk == 0));
            wgmma_commit();
            first = 0;
            wgmma_wait<1>();  // the previous chunk's product is done
            if (prev >= 0) release(u, pipe, prev, pipe.idx - 1);
            prev = pipe.s;
            pipe.advance(u.stages());
        }
    wgmma_wait<0>();
    fence_acc(acc);
    release(u, pipe, prev, pipe.idx - 1);
}

// Consumer warpgroup `wg`: the exact M of its 64 rows x the subtile's 64
// columns (largest entry bmax) in wgmma's accumulator layout (out[4 i +
// 2 h + e] is row 16 warp + lane / 4 + 8 h, column 8 i + 2 (lane % 4) +
// e). Returns false when `out` holds M as s32 (a narrow pair: exact,
// below 2^31), true when it holds the bits of M's correctly rounded f32
// (the wide path). WIDE: whether this kernel instance has the wide path
// at all (it takes registers the narrow instances leave to a second
// block on the SM); it must equal u.wide.
template <bool WIDE>
__device__ __forceinline__ bool product_subtile(const Unit& u, Pipe& pipe,
                                                int wg, int bmax,
                                                int (&out)[ACC]) {
    const int lc = limbs_of(bmax);
    const int top = u.lr() + lc - 2;
    const int n_chunks = u.n_chunks();
    if (!WIDE || u.narrow(bmax)) {
        for (int s = top; s >= 0; --s) {
            if (s < top) {
#pragma unroll
                for (int i = 0; i < ACC; ++i) out[i] <<= 8;
            }
            product_group<ACC>(u, pipe, wg, s, lc, 0, n_chunks, 0, s == top,
                               out);
        }
        return false;
    }
    if (!WIDE) return false;  // not reached: the wrapper cleared the block
#pragma unroll
    for (int part = 0; part < QUARTERS; ++part) {
        constexpr int N = ACC / QUARTERS;
        int acc[N];
        double wide[N];
#pragma unroll
        for (int i = 0; i < N; ++i) wide[i] = 0.0;
        for (int s = top; s >= 0; --s) {
            const double shift = (double)(1ull << (8 * s));
            for (int g0 = 0; g0 < n_chunks; g0 += FOLD_CHUNKS) {
                // 16 rows of 128 bytes: a quarter of B, 2048 bytes on
                product_group<N>(u, pipe, wg, s, lc, g0,
                                 min(n_chunks, g0 + FOLD_CHUNKS),
                                 part * (2048 >> 4), true, acc);
#pragma unroll
                for (int i = 0; i < N; ++i)
                    wide[i] = fma((double)acc[i], shift, wide[i]);
            }
        }
#pragma unroll
        for (int i = 0; i < N; ++i)
            out[part * N + i] = __float_as_int(__double2float_rn(wide[i]));
    }
    return true;
}

}  // namespace u8
}  // namespace pathsim

// -- host side ----------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
static PFN_cuTensorMapEncodeTiled pathsim_encode_fn() {
    static void* fn = nullptr;
    if (fn == nullptr) {
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                         cudaEnableDefault, &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q);
#endif
        if (q != cudaDriverEntryPointSuccess) fn = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
}

// Error codes of the launchers past CUDA's own: no tensor-map encoder,
// and an encoder refusal (plus its CUresult).
constexpr int PATHSIM_ERR_NO_ENCODER = 2000;
constexpr int PATHSIM_ERR_ENCODE = 3000;

// The tensor map of limb planes [n_planes, rows, v_pad] u8 (rows v_pad
// bytes apart, planes plane_stride bytes apart), boxes of one 128-byte
// chunk x box_rows rows of one plane, 128-byte swizzle, zero fill past
// the edges. Returns 0 or an error code.
static int pathsim_limb_map(CUtensorMap* map, const void* planes,
                            int n_planes, long long rows, int v_pad,
                            long long plane_stride, int box_rows) {
    const PFN_cuTensorMapEncodeTiled encode = pathsim_encode_fn();
    if (encode == nullptr) return PATHSIM_ERR_NO_ENCODER;
    const cuuint64_t dims[3] = {(cuuint64_t)v_pad, (cuuint64_t)rows,
                                (cuuint64_t)n_planes};
    const cuuint64_t strides[2] = {(cuuint64_t)v_pad,
                                   (cuuint64_t)plane_stride};
    const cuuint32_t box[3] = {(cuuint32_t)pathsim::u8::CHUNK,
                               (cuuint32_t)box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(planes),
        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : PATHSIM_ERR_ENCODE + (int)r;
}
