// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rg_lru_scan.py:68
// (rg_lru_scan_kernel_call -> _kernel :32).  x, a, out are contiguous
// [B, S, R], all float32 or all bfloat16; h0 is [B, R] float32; out[b, t]
// = h_t.  As in the Pallas kernel, a bf16 element is converted to float32
// where the walk reads it, the carry and the arithmetic stay float32, and
// each h_t is rounded to bf16 once, at its store (round to nearest even,
// as a float32 -> bf16 cast in PyTorch rounds).
//
// Design: a deep prefetch ring under the sequential recurrence.  One warp
// owns 64 neighbouring channels of one batch row (lane l: channels l and
// l + 32) and walks the sequence in order with each channel's carry in a
// register.  The steps of a and x stream into a shared-memory ring of
// STAGES = 4 stages of T = 32 steps (128 steps x 64 channels x 2 arrays x 4
// bytes = 64 KB a block) by cp.async: 16 bytes a thread when R and the
// pointers allow it (a warp instruction lands 2 steps, each one 256-byte
// row), else 4 bytes a thread.  While the warp walks one stage, the next
// three (48 KB) are in flight, so no load waits behind a dependent update.
// 64 channels a warp rather than 32 make each step's read and write one
// 256-byte segment instead of 128, which the memory serves faster at the
// cost of half as many blocks (128 at the serve shape, for 132 SMs).  The
// step is a rounded multiply then a rounded add (__fmul_rn, __fadd_rn, no
// FMA contraction), the same arithmetic as the plain PyTorch loop, so the
// two agree bit for bit; every byte of x and a is read once and every h_t
// written once.
//
// The TPU kernel's log-space block form, h = A * (h_in + cumsum(x / A))
// with A = cumprod(a), is not carried over: it exists to turn the serial
// recurrence into the vector unit's cumulative sums, and on the card it
// would only add the 1 / A overflow bound its docstring warns about
// (a ~ 0.9 over a 256-step block gives 1 / A ~ 5e11).
//
// What bounds it on an H100: bytes, 3 * B * S * R * 4 over 3.35 TB/s (0.090
// ms at the serve shape B = 2, S = 3072, R = 4096; half that in bf16).  The walk itself (per
// step and channel two shared loads, a multiply, an add and a store) takes
// a small part of that; what is left is the memory's rate on this pattern
// of one row segment per block and step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPL = 2;         // channels per lane: lane + 32 k, k < CPL
constexpr int CH = 32 * CPL;   // channels per block (one warp)
constexpr int T = 32;          // steps per stage
constexpr int STAGES = 4;      // ring depth: STAGES * T = 128 steps
constexpr int STAGE_ELEMS = T * CH;
template <typename E>
constexpr size_t smem_bytes() { return 2ull * STAGES * STAGE_ELEMS * sizeof(E); }   // a and x

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

// One element of stage data into the ring: 4-byte cp.async for float32; a
// bf16 element is too small for cp.async, so it is loaded and stored.
__device__ __forceinline__ void copy1(float* dst, const float* src, bool valid) {
    cp_async4(dst, src, valid);
}
__device__ __forceinline__ void copy1(__nv_bfloat16* dst, const __nv_bfloat16* src, bool valid) {
    *dst = valid ? *src : __float2bfloat16_rn(0.f);
}

// Issue the loads of stage `st` (steps st*T .. st*T + T - 1) into its slot.
template <bool VEC, typename E>
__device__ __forceinline__ void issue(E* ring_a, E* ring_x, const E* a,
                                      const E* x, long long base, int st, int S, int R,
                                      int c0, int lane)
{
    E* da = ring_a + (st % STAGES) * STAGE_ELEMS;
    E* dx = ring_x + (st % STAGES) * STAGE_ELEMS;
    const int t0 = st * T;
    if (VEC) {
        // a row of CH channels is CH / EPC chunks of 16 bytes; a warp
        // instruction lands RPI rows
        constexpr int EPC = 16 / sizeof(E), CPR = CH / EPC, RPI = 32 / CPR;
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
                copy1(da + u * CH + cl, cok ? a + off : a, cok);
                copy1(dx + u * CH + cl, cok ? x + off : x, cok);
            }
        }
    }
}

template <bool VEC, typename E>
__global__ void __launch_bounds__(32)
rg_lru_scan_kernel(const E* __restrict__ x, const E* __restrict__ a,
                   const float* __restrict__ h0, E* __restrict__ out, int S, int R)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* ring_a = reinterpret_cast<E*>(smem_raw);     // [STAGES][T][CH]
    E* ring_x = ring_a + STAGES * STAGE_ELEMS;      // [STAGES][T][CH]
    const int lane = threadIdx.x;
    const int c0 = blockIdx.x * CH;
    const int b = blockIdx.y;
    const long long base = (long long)b * S * R + c0;   // element (b, 0, c0)
    const int nst = (S + T - 1) / T;

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nst) issue<VEC, E>(ring_a, ring_x, a, x, base, st, S, R, c0, lane);
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
    E* o = out + base + lane;
    for (int st = 0; st < nst; ++st) {
        __syncwarp();     // the slot of stage st - 1 is read by every lane
        if (st + STAGES - 1 < nst)
            issue<VEC, E>(ring_a, ring_x, a, x, base, st + STAGES - 1, S, R, c0, lane);
        cp_async_commit();
        cp_async_wait();  // this lane's copies of stage st have landed
        __syncwarp();     // and so have the other lanes'
        const E* sa = ring_a + (st % STAGES) * STAGE_ELEMS + lane;
        const E* sx = ring_x + (st % STAGES) * STAGE_ELEMS + lane;
        const int t0 = st * T;
        const int n = min(T, S - t0);
        if (n == T) {
#pragma unroll
            for (int u = 0; u < T; ++u)
#pragma unroll
                for (int k = 0; k < CPL; ++k) {
                    h[k] = __fadd_rn(__fmul_rn(to_f32(sa[u * CH + 32 * k]), h[k]),
                                     to_f32(sx[u * CH + 32 * k]));
                    if (mine[k]) store(o + (long long)(t0 + u) * R + 32 * k, h[k]);
                }
        } else {
            for (int u = 0; u < n; ++u)
#pragma unroll
                for (int k = 0; k < CPL; ++k) {
                    h[k] = __fadd_rn(__fmul_rn(to_f32(sa[u * CH + 32 * k]), h[k]),
                                     to_f32(sx[u * CH + 32 * k]));
                    if (mine[k]) store(o + (long long)(t0 + u) * R + 32 * k, h[k]);
                }
        }
    }
}

template <bool VEC, typename E>
int launch(const E* x, const E* a, const float* h0, E* out, int B, int S, int R,
           cudaStream_t stream)
{
    constexpr size_t bytes = smem_bytes<E>();
    cudaError_t err = cudaFuncSetAttribute(
        rg_lru_scan_kernel<VEC, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((R + CH - 1) / CH, B);
    rg_lru_scan_kernel<VEC, E><<<grid, 32, bytes, stream>>>(x, a, h0, out, S, R);
    return (int)cudaGetLastError();
}

template <typename E>
int run(const E* x, const E* a, const float* h0, E* out, int B, int S, int R, void* stream)
{
    if (B <= 0 || S <= 0 || R <= 0) return (int)cudaSuccess;
    cudaStream_t st = (cudaStream_t)stream;
    constexpr int EPC = 16 / sizeof(E);
    const bool vec = R % EPC == 0 && ((uintptr_t)x | (uintptr_t)a) % 16 == 0;
    return vec ? launch<true, E>(x, a, h0, out, B, S, R, st)
               : launch<false, E>(x, a, h0, out, B, S, R, st);
}

}  // namespace

// x, a, out [B, S, R]; h0 [B, R]; contiguous float32.  Returns a cudaError_t.
extern "C" int rg_lru_scan_f32(const float* x, const float* a, const float* h0,
                               float* out, int B, int S, int R, void* stream)
{
    return run<float>(x, a, h0, out, B, S, R, stream);
}

// x, a, out [B, S, R] contiguous bfloat16; h0 [B, R] contiguous float32.
extern "C" int rg_lru_scan_bf16(const __nv_bfloat16* x, const __nv_bfloat16* a, const float* h0,
                                __nv_bfloat16* out, int B, int S, int R, void* stream)
{
    return run<__nv_bfloat16>(x, a, h0, out, B, S, R, stream);
}
