// Flash attention (blocked online softmax) for Hopper (sm_90a), plain FP32 FFMA.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_kernel / flash_attention_kernel_call).  For every batch row b, query
// head h and query position i:
//
//   o[b, i, h] = softmax_j( softcap(q[b, i, h] . k[b, j, g] / sqrt(d)) over
//                           the kept keys j ) @ v[b, :, g]
//
// with g = h / (H / KV), the kv head of query head h in the head-major order
// of the model's _repeat_kv (src/repro/models/attention.py:93).  MQA/GQA
// K/V are read in place: nothing is repeated in device memory.  Key j is
// kept for query i iff j < S, (not causal or j <= i) and (no window or
// j > i - window).  q, o are contiguous [B, S, H, D]; k, v contiguous
// [B, S, KV, D]; any S (the ragged last tile is bounds-checked).
//
// Mask rule.  The TPU kernel writes -1e30 into masked scores and the JAX
// model adds finfo(f32).min; here a masked key gets probability exactly 0
// and takes no part in the running max.  The three agree whenever a query
// row keeps at least one key, because exp(masked - max) underflows to 0
// in all of them; causal self-attention always keeps key i for query i.
// A row that kept no key at all would come out 0 here (the references
// would give the mean of v); no caller of the port produces one.
//
// Design.  One 256-thread block owns BQ = 64 query rows of one (b, h): the
// Q tile stays in shared memory, and the block walks the KV tiles of BK = 64
// keys in order, skipping whole tiles above the causal diagonal or outside
// the window (the TPU kernel's pl.when skip, done here by the loop bounds).
// Per tile: S = Q K^T into a 4x4 register tile per thread (rows ty + 16 i,
// keys tx + 16 j), scale, softcap and mask, the online-softmax update of
// the running max m, denominator l and output accumulator (rows kept in
// registers, 4 rows x D/16 columns per thread, reductions over the 16
// threads of a row by warp shuffles), then O += P V with P staged through
// shared memory.  Everything accumulates in FP32.  Shared memory for D=256:
// Q and K tiles 64 x 260 floats each, V 64 x 256, P 64 x 80: 219,136 bytes,
// above the 48 KB default, so the host wrapper opts in with
// cudaFuncSetAttribute.  Row pads keep the float4 shared loads free of bank
// conflicts.
//
// What bounds it on an H100: FP32 FFMA throughput (67 TFLOP/s) for the
// 4 * kept-pairs * D FLOPs of the live tiles; at the serve shape (S = 3072,
// window 2048, D = 256) the bytes are two orders of magnitude below.  This
// first design runs one block per SM (8 warps), loads K/V through registers
// with no copy/compute overlap, and uses no tensor cores; cp.async/TMA
// double buffering, several heads per block sharing one MQA K/V tile, and a
// TF32/bf16 wgmma path are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG = -1e30f;

template <int D>
struct Layout {
    static constexpr int LDQ = D + 4;     // Q/K row stride (floats)
    static constexpr int LDP = BK + 16;   // P row stride
    static constexpr size_t floats =
        (size_t)BQ * LDQ + (size_t)BK * LDQ + (size_t)BK * D + (size_t)BQ * LDP;
    static constexpr size_t bytes = floats * sizeof(float);
};

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S, int H, int KV, float sqrt_d, int causal, int window,
                       float softcap)
{
    constexpr int LDQ = Layout<D>::LDQ;
    constexpr int LDP = Layout<D>::LDP;
    constexpr int V4 = D / 4;     // float4 per row
    constexpr int NG = D / 64;    // float4 column groups per thread

    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;               // [BQ][LDQ]
    float* Ks = Qs + BQ * LDQ;      // [BK][LDQ]
    float* Vs = Ks + BK * LDQ;      // [BK][D]
    float* Ps = Vs + BK * D;        // [BQ][LDP]

    const int tid = threadIdx.x;
    const int tx = tid & 15;        // key / column group
    const int ty = tid >> 4;        // row group: rows ty + 16 i
    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int g = h / (H / KV);
    const long long qrow = (long long)H * D;    // elements between positions
    const long long krow = (long long)KV * D;
    const float* qb = q + (long long)b * S * qrow + (long long)h * D;
    const float* kb = k + (long long)b * S * krow + (long long)g * D;
    const float* vb = v + (long long)b * S * krow + (long long)g * D;
    float* ob = o + (long long)b * S * qrow + (long long)h * D;

    const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < BQ * V4; i += THREADS) {
        const int r = i / V4, c = (i % V4) * 4;
        float4 val = zero4;
        if (q0 + r < S) val = ld4(qb + (q0 + r) * qrow + c);
        st4(Qs + r * LDQ + c, val);
    }

    float m[4], l[4], acc[4][4 * NG];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
    }

    // live KV tiles: not wholly above the diagonal, not wholly out of window
    const int nkt = (S + BK - 1) / BK;
    int kt_end = nkt;
    if (causal) kt_end = min(nkt, (q0 + BQ - 1) / BK + 1);
    int kt_begin = 0;
    if (window > 0) {
        // live iff the tile's newest key k0 + BK - 1 > q0 - window
        const int t = q0 - window - BK + 1;
        if (t >= 0) kt_begin = t / BK + 1;
    }

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();   // Q stored / previous tile's K, V, P consumed
        for (int i = tid; i < BK * V4; i += THREADS) {
            const int r = i / V4, c = (i % V4) * 4;
            float4 kv = zero4, vv = zero4;
            if (k0 + r < S) {
                kv = ld4(kb + (k0 + r) * krow + c);
                vv = ld4(vb + (k0 + r) * krow + c);
            }
            st4(Ks + r * LDQ + c, kv);
            st4(Vs + r * D + c, vv);
        }
        __syncthreads();

        // S = Q K^T for rows ty + 16 i, keys tx + 16 j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < D; kk += 4) {
            float4 qa[4], ka[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) qa[i] = ld4(Qs + (ty + 16 * i) * LDQ + kk);
#pragma unroll
            for (int j = 0; j < 4; ++j) ka[j] = ld4(Ks + (tx + 16 * j) * LDQ + kk);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float t = s[i][j];
                    t = fmaf(qa[i].x, ka[j].x, t);
                    t = fmaf(qa[i].y, ka[j].y, t);
                    t = fmaf(qa[i].z, ka[j].z, t);
                    t = fmaf(qa[i].w, ka[j].w, t);
                    s[i][j] = t;
                }
        }

        // online softmax: scale, softcap, mask; update m, l, rescale acc
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty + 16 * i;
            bool keep[4];
            float mx = NEG;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = k0 + tx + 16 * j;
                float sv = s[i][j] / sqrt_d;
                if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
                keep[j] = col < S && (!causal || col <= row) &&
                          (window <= 0 || col > row - window);
                s[i][j] = sv;
                if (keep[j]) mx = fmaxf(mx, sv);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
                Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
                ps += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                ps += __shfl_xor_sync(0xffffffffu, ps, off);
            l[i] = l[i] * alpha + ps;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();

        // O += P V: thread columns tx * 4 + 64 * gg (+0..3)
#pragma unroll 2
        for (int j = 0; j < BK; j += 4) {
            float4 pa[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pa[i] = ld4(Ps + (ty + 16 * i) * LDP + j);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const float* vrow = Vs + (j + jj) * D + tx * 4;
#pragma unroll
                for (int gg = 0; gg < NG; ++gg) {
                    const float4 vv = ld4(vrow + 64 * gg);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float p = comp(pa[i], jj);
                        acc[i][4 * gg + 0] = fmaf(p, vv.x, acc[i][4 * gg + 0]);
                        acc[i][4 * gg + 1] = fmaf(p, vv.y, acc[i][4 * gg + 1]);
                        acc[i][4 * gg + 2] = fmaf(p, vv.z, acc[i][4 * gg + 2]);
                        acc[i][4 * gg + 3] = fmaf(p, vv.w, acc[i][4 * gg + 3]);
                    }
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= S) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
        float* orow = ob + row * qrow + tx * 4;
#pragma unroll
        for (int gg = 0; gg < NG; ++gg)
            st4(orow + 64 * gg, make_float4(acc[i][4 * gg + 0] * inv, acc[i][4 * gg + 1] * inv,
                                            acc[i][4 * gg + 2] * inv, acc[i][4 * gg + 3] * inv));
    }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           int B, int S, int H, int KV, float sqrt_d, int causal, int window,
           float softcap, cudaStream_t stream)
{
    const size_t bytes = Layout<D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((S + BQ - 1) / BQ, H, B);
    flash_attention_kernel<D><<<grid, THREADS, bytes, stream>>>(
        q, k, v, o, S, H, KV, sqrt_d, causal, window, softcap);
    return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for head dim D (0 if D is not taken).
extern "C" long long flash_attention_smem_bytes(int D)
{
    switch (D) {
        case 64: return (long long)Layout<64>::bytes;
        case 128: return (long long)Layout<128>::bytes;
        case 256: return (long long)Layout<256>::bytes;
        default: return 0;
    }
}

// q, o [B, S, H, D]; k, v [B, S, KV, D]; all contiguous float32.
// window <= 0: no window; softcap <= 0: no softcap.  Returns a cudaError_t.
extern "C" int flash_attention_f32(
    const float* q, const float* k, const float* v, float* o,
    int B, int S, int H, int KV, int D, int causal, int window, float softcap,
    float sqrt_d, void* stream)
{
    if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
    if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (D) {
        case 64: return launch<64>(q, k, v, o, B, S, H, KV, sqrt_d, causal, window, softcap, st);
        case 128: return launch<128>(q, k, v, o, B, S, H, KV, sqrt_d, causal, window, softcap, st);
        case 256: return launch<256>(q, k, v, o, B, S, H, KV, sqrt_d, causal, window, softcap, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
