// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rg_lru_scan.py:68
// (rg_lru_scan_kernel_call -> _kernel :32).  x, a, out are contiguous
// [B, S, R], all float32 or all bfloat16; h0 is [B, R] float32; out[b, t]
// = h_t.  Both instances walk the sequence in order with each channel's
// carry in a float32 register.  The step is a rounded multiply then a
// rounded add (__fmul_rn, __fadd_rn, no FMA contraction), the same
// arithmetic as the plain PyTorch loop, so the two agree bit for bit.  As
// in the Pallas kernel, a bf16 element is converted to float32 where the
// walk reads it and each h_t is rounded to bf16 once, at its store (round
// to nearest even, as a float32 -> bf16 cast in PyTorch rounds).  Every
// byte of x and a is read once and every h_t written once.
//
// The TPU kernel's log-space block form, h = A * (h_in + cumsum(x / A))
// with A = cumprod(a), is not carried over: it exists to turn the serial
// recurrence into the vector unit's cumulative sums, and on the card it
// would only add the 1 / A overflow bound its docstring warns about
// (a ~ 0.9 over a 256-step block gives 1 / A ~ 5e11).
//
// float32 instance: a deep prefetch ring under one walking warp.  One warp
// owns 64 neighbouring channels of one batch row (lane l: channels l and
// l + 32).  The steps of a and x stream into a shared-memory ring of
// STAGES = 4 stages of T = 32 steps (64 KB a block) by cp.async: 16 bytes
// a thread when R and the pointers allow it, else 4 bytes a thread.  While
// the warp walks one stage the next three are in flight.  64 channels a
// warp make each step's read and write one 256-byte segment, at the cost
// of half as many blocks (128 at the serve shape, for 132 SMs).  Bound:
// bytes, 3 * B * S * R * 4 over 3.35 TB/s, 0.090 ms at the serve shape
// B = 2, S = 3072, R = 4096; it reads 0.114 ms of device time.
//
// bf16 instance: walking warps fed by TMA, stores staged.  The float32
// ring with bf16 elements read 0.102 ms of device time at the serve shape
// against a byte bound of 0.045 ms (NVIDIA H100 80GB HBM3, 700 W, CUDA
// graph replay).  With its walk removed (ring filled, nothing walked or
// stored) it read 0.034 ms; with its global loads removed (the walk and
// the 2-byte stores over whatever the ring held) 0.074 ms: the one warp an
// SM that issued every shared load, convert, multiply, add and strided
// 2-byte global store set the pace, not the bytes.  So here a block of
// CH = 32 * WALKERS channels of one batch row runs WALKERS walking warps,
// one channel a lane, and one producer warp.  The producer's elected lane
// lands tiles of T steps x CH channels of a and x in a ring of
// LOAD_STAGES slots by TMA (a 3-D tensor map over [B, S, R]; a box past S
// or R is zero-filled), each completing on the slot's `full` mbarrier; the
// walkers free a slot on its `empty` mbarrier.  Walkers write each h_t as
// bf16 into an output stage of OUT_STAGES slots; after each stage one
// walker sends the slot to device memory as whole rows by a TMA store
// (clipped at S and R) and waits for it to have read the slot before the
// slot is written again.  Only the dependent multiply-add, two shared
// loads, the converts and one shared store a step stay with the walkers.
// Rows TMA cannot take (R % 8 != 0 or a pointer off 16 bytes, where a
// 16-byte cp.async cannot go either) run the same kernel with the walkers
// copying each output stage out row by row and the producer warp filling
// the ring by 4-byte cp.async, an element pair a word, where R is even and
// x and a are 4-byte aligned, else element by element with synchronous
// loads.  That path is there to be right at any shape; no shape of the
// port's models takes it, and it is timed at none.  Bound: bytes, 3 * B * S * R * 2 over 3.35 TB/s,
// 0.045 ms at the serve shape; the walk's serial chain is about 8 cycles
// a step, 3072 steps ~ 14 us, under it.  This design reads 0.052-0.053
// ms there (same card).  Its loads alone read 0.033 ms (3.0 TB/s), its
// walk and stores alone 0.033, its loads and walk 0.035: the reads and the
// writes sharing the memory, 151 MB at 2.85 TB/s, set the time.  Variants timed
// beside it all read 0.053-0.058 ms: two channels a lane (half the shared
// loads), 128 channels a block, 32-step stages, a fourth or fifth ring
// slot, a third output slot, a producer that sleeps between polls.
//
// The float32 backward (rg_lru_scan_bwd_f32, namespace bwd) is described
// where it is defined.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPL = 2;         // channels per lane: lane + 32 k, k < CPL
constexpr int CH = 32 * CPL;   // channels per block (one warp)
constexpr int T = 32;          // steps per stage
constexpr int STAGES = 4;      // ring depth: STAGES * T = 128 steps
constexpr int STAGE_ELEMS = T * CH;
constexpr size_t SMEM_BYTES = 2ull * STAGES * STAGE_ELEMS * sizeof(float);   // a and x

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? 16 : 0;     // src-size 0: zero-fill, nothing read
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 1) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Issue the loads of stage `st` (steps st*T .. st*T + T - 1) into its slot.
template <bool VEC>
__device__ __forceinline__ void issue(float* ring_a, float* ring_x, const float* a,
                                      const float* x, long long base, int st, int S, int R,
                                      int c0, int lane)
{
    float* da = ring_a + (st % STAGES) * STAGE_ELEMS;
    float* dx = ring_x + (st % STAGES) * STAGE_ELEMS;
    const int t0 = st * T;
    if (VEC) {
        // a row of CH channels is CH / EPC chunks of 16 bytes; a warp
        // instruction lands RPI rows
        constexpr int EPC = 4, CPR = CH / EPC, RPI = 32 / CPR;
        const int cc = EPC * (lane % CPR);
        const bool cok = c0 + cc < R;      // R % EPC == 0: a chunk is all in or all out
#pragma unroll
        for (int i = 0; i < T / RPI; ++i) {
            const int u = RPI * i + lane / CPR;
            if (t0 + u >= S) break;
            const long long off = base + (long long)(t0 + u) * R + cc;
            cp_async16(da + u * CH + cc, cok ? a + off : a, cok);
            cp_async16(dx + u * CH + cc, cok ? x + off : x, cok);
        }
    } else {
#pragma unroll 8
        for (int u = 0; u < T; ++u) {
            if (t0 + u >= S) break;
#pragma unroll
            for (int k = 0; k < CPL; ++k) {
                const int cl = lane + 32 * k;
                const bool cok = c0 + cl < R;
                const long long off = base + (long long)(t0 + u) * R + cl;
                cp_async4(da + u * CH + cl, cok ? a + off : a, cok);
                cp_async4(dx + u * CH + cl, cok ? x + off : x, cok);
            }
        }
    }
}

template <bool VEC>
__global__ void __launch_bounds__(32)
rg_lru_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ h0, float* __restrict__ out, int S, int R)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* ring_a = reinterpret_cast<float*>(smem_raw);   // [STAGES][T][CH]
    float* ring_x = ring_a + STAGES * STAGE_ELEMS;        // [STAGES][T][CH]
    const int lane = threadIdx.x;
    const int c0 = blockIdx.x * CH;
    const int b = blockIdx.y;
    const long long base = (long long)b * S * R + c0;   // element (b, 0, c0)
    const int nst = (S + T - 1) / T;

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nst) issue<VEC>(ring_a, ring_x, a, x, base, st, S, R, c0, lane);
        cp_async_commit();
    }
    float h[CPL];
    bool mine[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
        const int c = c0 + lane + 32 * k;
        mine[k] = c < R;
        h[k] = mine[k] ? h0[(long long)b * R + c] : 0.f;
    }
    float* o = out + base + lane;
    for (int st = 0; st < nst; ++st) {
        __syncwarp();     // the slot of stage st - 1 is read by every lane
        if (st + STAGES - 1 < nst)
            issue<VEC>(ring_a, ring_x, a, x, base, st + STAGES - 1, S, R, c0, lane);
        cp_async_commit();
        cp_async_wait();  // this lane's copies of stage st have landed
        __syncwarp();     // and so have the other lanes'
        const float* sa = ring_a + (st % STAGES) * STAGE_ELEMS + lane;
        const float* sx = ring_x + (st % STAGES) * STAGE_ELEMS + lane;
        const int t0 = st * T;
        const int n = min(T, S - t0);
        if (n == T) {
#pragma unroll
            for (int u = 0; u < T; ++u)
#pragma unroll
                for (int k = 0; k < CPL; ++k) {
                    h[k] = __fadd_rn(__fmul_rn(sa[u * CH + 32 * k], h[k]), sx[u * CH + 32 * k]);
                    if (mine[k]) o[(long long)(t0 + u) * R + 32 * k] = h[k];
                }
        } else {
            for (int u = 0; u < n; ++u)
#pragma unroll
                for (int k = 0; k < CPL; ++k) {
                    h[k] = __fadd_rn(__fmul_rn(sa[u * CH + 32 * k], h[k]), sx[u * CH + 32 * k]);
                    if (mine[k]) o[(long long)(t0 + u) * R + 32 * k] = h[k];
                }
        }
    }
}

template <bool VEC>
int launch(const float* x, const float* a, const float* h0, float* out, int B, int S, int R,
           cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(
        rg_lru_scan_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((R + CH - 1) / CH, B);
    rg_lru_scan_kernel<VEC><<<grid, 32, SMEM_BYTES, stream>>>(x, a, h0, out, S, R);
    return (int)cudaGetLastError();
}

int run(const float* x, const float* a, const float* h0, float* out, int B, int S, int R,
        void* stream)
{
    if (B <= 0 || S <= 0 || R <= 0) return (int)cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    const bool vec = R % 4 == 0 && ((uintptr_t)x | (uintptr_t)a) % 16 == 0;
    return vec ? launch<true>(x, a, h0, out, B, S, R, st)
               : launch<false>(x, a, h0, out, B, S, R, st);
}

// ---------------------------------------------------------------------------
// Hopper's asynchronous copies: mbarriers, TMA tensor maps, bulk tensor
// loads and stores.  Kept apart from the scan so that another kernel can
// take them as they are.
// ---------------------------------------------------------------------------
namespace tma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const unsigned addr = smem_addr(bar);
    unsigned done = 0;
    while (!done) {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}
// Box (c0, c1, c2) of a 3-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                        uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%2, %3, %4}], [%5];\n"
                 :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
                    "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar)) : "memory");
}
// Shared memory at `src` to box (c0, c1, c2) of a 3-D map; clipped at the bounds.
__device__ __forceinline__ void store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
    asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)),
                    "r"(c0), "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void store_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// At most N committed stores still reading shared memory.
template <int N>
__device__ __forceinline__ void store_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// Every committed store complete.
__device__ __forceinline__ void store_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// This thread's shared-memory writes, visible to a later TMA store.
__device__ __forceinline__ void fence_to_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A 3-D map over a contiguous [d2][d1][d0] array at `p` (16-byte aligned,
// d0 * elem a multiple of 16), box {b0, b1, 1}, no swizzle, zero fill
// outside the array.  Returns a cudaError_t.
int map_3d(CUtensorMap* map, CUtensorMapDataType dtype, int elem, const void* p,
           uint64_t d0, uint64_t d1, uint64_t d2, unsigned b0, unsigned b1) {
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[3] = {d0, d1, d2};
    const cuuint64_t strides[2] = {d0 * elem, d0 * d1 * elem};
    const cuuint32_t box[3] = {b0, b1, 1};
    const cuuint32_t step[3] = {1, 1, 1};
    CUresult r = enc(map, dtype, 3, const_cast<void*>(p), dims, strides, box, step,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}

}  // namespace tma

// ---------------------------------------------------------------------------
// bf16 instance
// ---------------------------------------------------------------------------
namespace bf16 {

typedef __nv_bfloat16 bf16_t;
constexpr int WALKERS = 2;                 // walking warps a block, one channel a lane
constexpr int CH = 32 * WALKERS;           // channels of a block
constexpr int T = 64;                      // steps of a stage
constexpr int LOAD_STAGES = 3;             // ring slots of a and x
constexpr int OUT_STAGES = 2;              // output stage slots
constexpr int THREADS = 32 * (WALKERS + 1);   // the walkers and one producer warp
constexpr int TILE = T * CH;               // elements of one slot
constexpr size_t SMEM = (2ull * LOAD_STAGES + OUT_STAGES) * TILE * sizeof(bf16_t)
                        + 2 * LOAD_STAGES * sizeof(uint64_t) + 128;   // + alignment slack

template <bool TMA>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_out, const bf16_t* __restrict__ x,
            const bf16_t* __restrict__ a, const float* __restrict__ h0, bf16_t* __restrict__ out,
            int S, int R, bool pairs)
{
    extern __shared__ __align__(16) unsigned char smem_bf16[];
    // TMA wants 128-byte aligned shared boxes; an offset from the shared
    // array (not a rounded integer) keeps the walk's loads LDS, not generic
    const unsigned pad = (128u - (tma::smem_addr(smem_bf16) & 127u)) & 127u;
    bf16_t* ring_a = reinterpret_cast<bf16_t*>(smem_bf16 + pad);
    bf16_t* ring_x = ring_a + LOAD_STAGES * TILE;   // [LOAD_STAGES][T][CH] each
    bf16_t* outs = ring_x + LOAD_STAGES * TILE;     // [OUT_STAGES][T][CH]
    uint64_t* full = reinterpret_cast<uint64_t*>(outs + OUT_STAGES * TILE);
    uint64_t* empty = full + LOAD_STAGES;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c0 = blockIdx.x * CH;
    const int b = blockIdx.y;
    const int nst = (S + T - 1) / T;

    if (threadIdx.x == 0) {
        for (int i = 0; i < LOAD_STAGES; ++i) {
            tma::mbar_init(&full[i], 1);           // the producer's one arrival (+ the TMA bytes)
            tma::mbar_init(&empty[i], WALKERS);    // one arrival a walking warp
        }
        tma::mbar_init_fence();
    }
    __syncthreads();

    if (warp == WALKERS) {
        // the producer: stage st into slot st % LOAD_STAGES once its last
        // walk has freed it
        for (int st = 0; st < nst; ++st) {
            const int slot = st % LOAD_STAGES;
            if (st >= LOAD_STAGES) tma::mbar_wait(&empty[slot], (st / LOAD_STAGES - 1) & 1);
            bf16_t* da = ring_a + slot * TILE;
            bf16_t* dx = ring_x + slot * TILE;
            if (TMA) {
                if (lane == 0) {
                    tma::mbar_arrive_tx(&full[slot], 2 * TILE * sizeof(bf16_t));
                    tma::load_3d(da, &map_a, c0, st * T, b, &full[slot]);
                    tma::load_3d(dx, &map_x, c0, st * T, b, &full[slot]);
                }
            } else {
                const long long base = ((long long)b * S + (long long)st * T) * R + c0;
                if (pairs) {
                    // R even, x and a 4-byte aligned: an element pair (c, c + 1),
                    // c even, is one 4-byte word, all in or all out; zeros past S, R
#pragma unroll 4
                    for (int i = lane; i < TILE / 2; i += 32) {
                        const int u = i / (CH / 2), c = 2 * (i % (CH / 2));
                        const bool ok = st * T + u < S && c0 + c < R;
                        const long long off = base + (long long)u * R + c;
                        cp_async4(da + u * CH + c, ok ? a + off : a, ok);
                        cp_async4(dx + u * CH + c, ok ? x + off : x, ok);
                    }
                    cp_async_commit();
                    cp_async_wait_all();
                } else {
#pragma unroll 4
                    for (int i = lane; i < TILE; i += 32) {
                        const int u = i / CH, c = i % CH;
                        const bool ok = st * T + u < S && c0 + c < R;
                        const long long off = base + (long long)u * R + c;
                        da[i] = ok ? a[off] : __float2bfloat16_rn(0.f);
                        dx[i] = ok ? x[off] : __float2bfloat16_rn(0.f);
                    }
                }
                __syncwarp();
                if (lane == 0) tma::mbar_arrive(&full[slot]);
            }
        }
        return;
    }

    // the walkers: lane `lane` of warp `warp` carries channel c0 + 32 warp + lane
    const int cl = 32 * warp + lane;
    const int c = c0 + cl;
    float h = c < R ? h0[(long long)b * R + c] : 0.f;
    for (int st = 0; st < nst; ++st) {
        const int slot = st % LOAD_STAGES;
        const int os = st % OUT_STAGES;
        tma::mbar_wait(&full[slot], (st / LOAD_STAGES) & 1);
        const bf16_t* sa = ring_a + slot * TILE + cl;
        const bf16_t* sx = ring_x + slot * TILE + cl;
        bf16_t* so = outs + os * TILE + cl;
        // the stage's a and x to registers first: a shared load after a
        // shared store waits for it (the compiler cannot tell the ring from
        // the output stage), which put a load's latency on every step
        __nv_bfloat16 av[T], xv[T];
#pragma unroll
        for (int u = 0; u < T; ++u) {
            av[u] = sa[u * CH];
            xv[u] = sx[u * CH];
        }
        // steps past S walk zeros; their h_t is never stored
#pragma unroll
        for (int u = 0; u < T; ++u) {
            h = __fadd_rn(__fmul_rn(__bfloat162float(av[u]), h), __bfloat162float(xv[u]));
            so[u * CH] = __float2bfloat16_rn(h);
        }
        __syncwarp();
        if (lane == 0) tma::mbar_arrive(&empty[slot]);
        if (TMA) {
            tma::fence_to_async();
            // the store that last read slot (st + 1) % OUT_STAGES has done so
            if (threadIdx.x == 0) tma::store_wait_read<OUT_STAGES - 2>();
        }
        asm volatile("bar.sync 1, %0;\n" :: "n"(WALKERS * 32) : "memory");   // the walkers only
        if (TMA) {
            if (threadIdx.x == 0) {
                tma::store_3d(&map_out, outs + os * TILE, c0, st * T, b);
                tma::store_commit();
            }
        } else {
            const long long base = ((long long)b * S + (long long)st * T) * R + c0;
            const bf16_t* src = outs + os * TILE;
            for (int i = threadIdx.x; i < TILE; i += WALKERS * 32) {
                const int u = i / CH, cc = i % CH;
                if (st * T + u < S && c0 + cc < R) out[base + (long long)u * R + cc] = src[i];
            }
        }
    }
    if (TMA && threadIdx.x == 0) tma::store_wait_all();
}

template <bool TMA>
int launch(const CUtensorMap& mx, const CUtensorMap& ma, const CUtensorMap& mo, const bf16_t* x,
           const bf16_t* a, const float* h0, bf16_t* out, int B, int S, int R, bool pairs,
           cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(scan_kernel<TMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((R + CH - 1) / CH, B);
    scan_kernel<TMA><<<grid, THREADS, SMEM, stream>>>(mx, ma, mo, x, a, h0, out, S, R, pairs);
    return (int)cudaGetLastError();
}

int run(const bf16_t* x, const bf16_t* a, const float* h0, bf16_t* out, int B, int S, int R,
        void* stream)
{
    if (B <= 0 || S <= 0 || R <= 0) return (int)cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    CUtensorMap mx{}, ma{}, mo{};
    const bool tma = R % 8 == 0 && ((uintptr_t)x | (uintptr_t)a | (uintptr_t)out) % 16 == 0;
    if (!tma) {
        const bool pairs = R % 2 == 0 && ((uintptr_t)x | (uintptr_t)a) % 4 == 0;
        return launch<false>(mx, ma, mo, x, a, h0, out, B, S, R, pairs, st);
    }
    const CUtensorMapDataType dt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    int rc = tma::map_3d(&mx, dt, 2, x, R, S, B, CH, T);
    if (rc == 0) rc = tma::map_3d(&ma, dt, 2, a, R, S, B, CH, T);
    if (rc == 0) rc = tma::map_3d(&mo, dt, 2, out, R, S, B, CH, T);
    if (rc != 0) return rc;
    return launch<true>(mx, ma, mo, x, a, h0, out, B, S, R, false, st);
}

}  // namespace bf16

// ---------------------------------------------------------------------------
// float32 backward: the reverse recurrence.  Replaces no TPU kernel: the
// JAX package trains through jnp (src/repro/models/rglru.py:99 runs
// associative_scan) and its Pallas scan has no VJP.  The port runs the scan
// kernel on its forward path on the card, so training there needs this one.
// With g_t the gradient that reaches h_t from the loss:
//
//   g_{S-1} = dh_{S-1},   g_t = dh_t + a_{t+1} g_{t+1},
//   dx_t = g_t,   da_t = g_t h_{t-1} (h_{-1} = h0),   dh0 = a_0 g_0.
//
// Each step is a rounded multiply then a rounded add (__fmul_rn,
// __fadd_rn), the operations autograd applies to the plain loop, so the
// result is bit-identical to the plain backward (kernels/ref.py
// rg_lru_bwd_ref) and, up to the sign of a zero, to autograd of the plain
// forward.  One warp owns 32 neighbouring channels of one batch row, one
// channel a lane, and walks the steps from the last, in chunks of U steps.
// Each lane copies its own channel's dh_t, a_t and h_{t-1} of a chunk into
// shared memory by 4-byte cp.async (a warp's copies of one step are one
// 128-byte segment of each array), NB - 1 chunks ahead of its walk, in a
// ring of NB chunks; a lane reads only what it copied.  Bound: bytes,
// 5 * B * S * R * 4 (dh, a, h read, dx, da written) over 3.35 TB/s.
// ---------------------------------------------------------------------------
namespace bwd {

constexpr int U = 32;    // steps of one chunk
constexpr int NB = 3;    // chunks of the ring: NB - 1 in flight during a walk

__device__ __forceinline__ void wait_ring() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(NB - 2) : "memory");
}

__global__ void __launch_bounds__(32)
scan_bwd_kernel(const float* __restrict__ dh, const float* __restrict__ a,
                const float* __restrict__ h, const float* __restrict__ h0,
                float* __restrict__ dx, float* __restrict__ da, float* __restrict__ dh0,
                int S, int R)
{
    __shared__ float ring[NB][3][U][32];      // [chunk slot][dh, a, h_{t-1}][step][lane]
    const int lane = threadIdx.x;
    const int c = blockIdx.x * 32 + lane;
    const bool mine = c < R;
    const int b = blockIdx.y;
    const long long base = (long long)b * S * R + (mine ? c : 0);
    const float h_init = mine ? h0[(long long)b * R + c] : 0.f;
    const int nch = (S + U - 1) / U;
    // chunk k holds steps S - 1 - k U, S - 2 - k U, ... (at most U of them)
    auto fill = [&](int k) {
        if (k < nch) {
            const int hi = S - 1 - k * U, n = min(U, hi + 1);
            float (*slot)[U][32] = ring[k % NB];
            for (int u = 0; u < n; ++u) {
                const int t = hi - u;
                const long long off = base + (long long)t * R;
                cp_async4(&slot[0][u][lane], mine ? dh + off : dh, mine);
                cp_async4(&slot[1][u][lane], mine ? a + off : a, mine);
                cp_async4(&slot[2][u][lane], mine && t > 0 ? h + off - R : h, mine && t > 0);
            }
        }
        cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < NB - 1; ++k) fill(k);
    float g = 0.f, a_next = 0.f;
    for (int k = 0; k < nch; ++k) {
        __syncwarp();            // every lane is done reading the slot refilled next
        fill(k + NB - 1);
        wait_ring();             // this lane's copies of chunk k have landed
        const float (*slot)[U][32] = ring[k % NB];
        const int hi = S - 1 - k * U, n = min(U, hi + 1);
        for (int u = 0; u < n; ++u) {
            const int t = hi - u;
            const float dhv = slot[0][u][lane];
            const float hp = t > 0 ? slot[2][u][lane] : h_init;
            g = t == S - 1 ? dhv : __fadd_rn(dhv, __fmul_rn(a_next, g));
            a_next = slot[1][u][lane];
            if (mine) {
                const long long off = base + (long long)t * R;
                dx[off] = g;
                da[off] = __fmul_rn(g, hp);
            }
        }
    }
    cp_async_wait_all();
    if (mine) dh0[(long long)b * R + c] = __fmul_rn(a_next, g);
}

int run(const float* dh, const float* a, const float* h, const float* h0, float* dx, float* da,
        float* dh0, int B, int S, int R, void* stream)
{
    if (B <= 0 || S <= 0 || R <= 0) return (int)cudaSuccess;
    dim3 grid((R + 31) / 32, B);
    scan_bwd_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(dh, a, h, h0, dx, da, dh0, S, R);
    return (int)cudaGetLastError();
}

}  // namespace bwd

}  // namespace

// The float32 backward: dh, a, h, dx, da [B, S, R]; h0, dh0 [B, R]; all
// contiguous float32; h is the forward's output.  Returns a cudaError_t.
extern "C" int rg_lru_scan_bwd_f32(const float* dh, const float* a, const float* h,
                                   const float* h0, float* dx, float* da, float* dh0, int B,
                                   int S, int R, void* stream)
{
    return bwd::run(dh, a, h, h0, dx, da, dh0, B, S, R, stream);
}

// x, a, out [B, S, R]; h0 [B, R]; contiguous float32.  Returns a cudaError_t.
extern "C" int rg_lru_scan_f32(const float* x, const float* a, const float* h0,
                               float* out, int B, int S, int R, void* stream)
{
    return run(x, a, h0, out, B, S, R, stream);
}

// x, a, out [B, S, R] contiguous bfloat16; h0 [B, R] contiguous float32.
extern "C" int rg_lru_scan_bf16(const __nv_bfloat16* x, const __nv_bfloat16* a, const float* h0,
                                __nv_bfloat16* out, int B, int S, int R, void* stream)
{
    return bf16::run(x, a, h0, out, B, S, R, stream);
}
