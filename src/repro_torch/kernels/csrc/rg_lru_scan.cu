// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rg_lru_scan.py
// (_kernel / rg_lru_scan_kernel_call).  x, a, out are contiguous
// [B, S, R] float32, h0 is [B, R]; out[b, t] = h_t.
//
// Design: one thread per (b, r) channel walks the sequence in order with
// the carry in a register.  Neighbouring threads own neighbouring channels,
// so every load and store of a step is coalesced across r.  The step is a
// rounded multiply then a rounded add (__fmul_rn, __fadd_rn, no FMA
// contraction), the same arithmetic as the plain PyTorch loop, so the two
// agree bit for bit.  The loads of U = 16 steps are issued before their
// dependent updates, so each thread keeps 32 loads in flight.
//
// The TPU kernel's log-space block form, h = A * (h_in + cumsum(x / A))
// with A = cumprod(a), is not carried over: it exists to turn the serial
// recurrence into the vector unit's cumulative sums, and on the card it
// would only add the 1 / A overflow bound its docstring warns about
// (a ~ 0.9 over a 256-step block gives 1 / A ~ 5e11).
//
// What bounds it on an H100: latency.  At the serve shape (B = 2, R = 4096)
// there are 8 192 channels, 128 blocks of 64 threads for 132 SMs, each
// thread walking S = 3 072 dependent steps; the byte bound (3 * B * S * R *
// 4 bytes over 3.35 TB/s, ~0.09 ms) needs far more bytes in flight than
// this gives.  A chunked scan (per-chunk carries, then a fix-up pass) is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int U = 16;

__global__ void __launch_bounds__(THREADS)
rg_lru_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ h0, float* __restrict__ out,
                   int S, int R)
{
    const int c = blockIdx.x * THREADS + threadIdx.x;
    const int b = blockIdx.y;
    if (c >= R) return;
    const long long base = (long long)b * S * R + c;
    float h = h0[(long long)b * R + c];
    int t = 0;
    for (; t + U <= S; t += U) {
        float av[U], xv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long i = base + (long long)(t + u) * R;
            av[u] = a[i];
            xv[u] = x[i];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
            out[base + (long long)(t + u) * R] = h;
        }
    }
    for (; t < S; ++t) {
        const long long i = base + (long long)t * R;
        h = __fadd_rn(__fmul_rn(a[i], h), x[i]);
        out[i] = h;
    }
}

}  // namespace

// x, a, out [B, S, R]; h0 [B, R]; contiguous float32.  Returns a cudaError_t.
extern "C" int rg_lru_scan_f32(const float* x, const float* a, const float* h0,
                               float* out, int B, int S, int R, void* stream)
{
    if (B <= 0 || S <= 0 || R <= 0) return (int)cudaSuccess;
    dim3 grid((R + THREADS - 1) / THREADS, B);
    rg_lru_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, a, h0, out, S, R);
    return (int)cudaGetLastError();
}
