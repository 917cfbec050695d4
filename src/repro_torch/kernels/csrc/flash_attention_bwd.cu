// Flash attention backward for Hopper (sm_90a), float32, FP32 FFMA.
//
// Replaces no TPU kernel: the JAX package trains its transformers through
// jnp (src/repro/models/attention.py:117 calls no Pallas kernel) and its
// Pallas kernel, src/repro/kernels/flash_attention.py:120, has no VJP.  The
// port runs the forward kernel (csrc/flash_attention.cu) on its training
// path on the card, so training there needs this backward.  It covers every
// float32 mode of the forward: causal, sliding window, softcap, GQA/MQA
// (query head h reads kv head h / (H / KV); K/V never repeated), the cross
// mode (T != S keys, every key kept) and head dims 64, 128 and 256.
//
// With s1 = q . k / sqrt(d), s2 = softcap(s1) = c tanh(s1 / c) (s2 = s1
// without a softcap), P the softmax of s2 over the kept keys, O = P V and
// dO the incoming gradient:
//
//   D_i  = sum_d dO[i, d] O[i, d]
//   dP   = dO V^T,   dS = P * (dP - D),   times (1 - tanh^2(s1 / c)) under
//          a softcap, then / sqrt(d)
//   dQ   = dS K,     dK = dS^T Q,   dV = P^T dO
//
// with dK and dV of a kv head summed over its H / KV query heads.
//
// Two kernels, launched in order by one entry point:
//
// * dq: a block owns 64 query rows of one (batch row, head).  It reads its
//   Q, dO and O rows, computes D, then walks the live 32-key tiles twice:
//   once for each row's max and sum of exp (the row statistics are
//   recomputed, so the forward kernel, its bits and its times stay as they
//   are), once for P, dP and dS, accumulating dQ = dS K in registers.  It
//   writes dQ and each row's log-sum-exp and D into a [B, H, S] scratch.
// * dkv: a block owns 32 keys of one (batch row, kv head), with their K and
//   V tiles in shared memory, and walks the live 32-row query tiles of each
//   of the kv head's H / KV query heads in turn, recomputing P from the
//   scratch's log-sum-exp, accumulating dV = P^T dO and dK = dS^T Q in
//   registers.  The sum over the query heads happens inside the block, in
//   a fixed order, with no atomics: two runs are bit-identical.
//
// Mask rule: key j is kept for query i iff j < T, i < S, (not causal or
// j <= i) and (no window or j > i - window), as in the forward.  A masked
// pair has P = 0 exactly and adds nothing.  A row with no kept key (which
// no caller builds: causal self-attention keeps key i) has a log-sum-exp of
// -inf; every pair of it is masked, so its dQ is 0 and it adds nothing to
// dK or dV: no NaN.
//
// Every product is FP32 FFMA from shared memory (no tensor cores): each
// thread owns a small tile of each product's output and reads its operands
// as 16-byte shared loads along d.  Rows are padded by 4 floats, so the
// eight 16-byte row reads of a quarter warp hit distinct banks.  The
// exponentials, logarithm and tanh are the accurate expf, logf and tanhf.
// Both kernels declare one block an SM as their floor (__launch_bounds__
// (256, 1)): without it ptxas held dkv at D = 128 to 80 registers and
// spilled; with it no instance spills (chip_smoke.py llm_train_kernel).
// What bounds it: operations, the five products of a backward (S, dP, dQ,
// dK, dV: 10 x kept pairs x D FLOPs) at the FP32 rate (67 TFLOP/s); it
// recomputes S and dP once more each (16 x kept pairs x D), and its loads
// are synchronous, with no ring.  Shared memory at D = 256: dq 208,128
// bytes (Q, dO 64 x 260 floats, K, V 32 x 260, dS 64 x 33), dkv 141,824
// (K, V, Q, dO 32 x 260, P, dS 32 x 33, 2 x 32 row values).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 4;     // floats of padding after each shared row
constexpr int BQ = 64;     // dq: query rows of a block
constexpr int BK = 32;     // dq: keys of a tile
constexpr int BKV = 32;    // dkv: keys of a block
constexpr int BQ2 = 32;    // dkv: query rows of a tile

struct Args {
    const float *q, *k, *v, *o, *dout;
    float *dq, *dk, *dv, *lse, *dsum;
    int B, S, T, H, KV;
    int causal, window;
    float softcap, sqrt_d;
};

template <int D>
struct Smem {
    static constexpr int LD = D + PAD;
    static constexpr size_t dq = sizeof(float) * ((2 * BQ + 2 * BK) * LD + BQ * (BK + 1));
    static constexpr size_t dkv = sizeof(float) * ((2 * BKV + 2 * BQ2) * LD + 2 * BKV * (BQ2 + 1)
                                                    + 2 * BQ2);
};

__device__ __forceinline__ bool kept(const Args& a, int i, int j) {
    return i < a.S && j < a.T && (!a.causal || j <= i) && (a.window <= 0 || j > i - a.window);
}

// Rows 0 .. rows - 1 of a tile from device memory (row r at src + r *
// stride) into shared memory at a row stride of D + PAD; rows from `valid`
// on are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long stride,
                                          int rows, int valid) {
    constexpr int V4 = D / 4;
    for (int idx = threadIdx.x; idx < rows * V4; idx += THREADS) {
        const int r = idx / V4, c = 4 * (idx % V4);
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < valid) val = *reinterpret_cast<const float4*>(src + r * stride + c);
        *reinterpret_cast<float4*>(dst + r * (D + PAD) + c) = val;
    }
}

__device__ __forceinline__ void fma4(float& acc, const float4& x, const float4& y) {
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float s, const float4& y) {
    acc.x = fmaf(s, y.x, acc.x);
    acc.y = fmaf(s, y.y, acc.y);
    acc.z = fmaf(s, y.z, acc.z);
    acc.w = fmaf(s, y.w, acc.w);
}

// out[r][c] = A[ra + 32 r] . Bm[cb + 8 c] over D, for NR rows of A and 4
// rows of Bm, both at a row stride of D + PAD in shared memory.
template <int D, int NR>
__device__ __forceinline__ void dots(const float* A, int ra, const float* Bm, int cb,
                                     float (&out)[NR][4]) {
    constexpr int LD = D + PAD;
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) out[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
        float4 x[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r)
            x[r] = *reinterpret_cast<const float4*>(A + (ra + 32 * r) * LD + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float4 y = *reinterpret_cast<const float4*>(Bm + (cb + 8 * c) * LD + d);
#pragma unroll
            for (int r = 0; r < NR; ++r) fma4(out[r][c], x[r], y);
        }
    }
}

// The softcapped score s2 of a raw dot product and the factor that the
// softcap puts on the gradient, 1 - tanh^2(s1 / c) (1 without a softcap).
__device__ __forceinline__ float score(const Args& a, float raw, float& cap_grad) {
    const float s1 = raw / a.sqrt_d;
    if (a.softcap > 0.f) {
        const float th = tanhf(s1 / a.softcap);
        cap_grad = 1.f - th * th;
        return a.softcap * th;
    }
    cap_grad = 1.f;
    return s1;
}

// Sum and max over the 8 lanes that share a row (lanes 8 m .. 8 m + 7).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// ---------------------------------------------------------------------------
// dq: grid (ceil(S / BQ), H, B).  Thread (ty, tx) = (tid / 8, tid % 8) owns
// rows ty and ty + 32 of the block; of a key tile, keys tx + 8 c (c < 4);
// of dQ, columns 4 tx + 32 j (j < D / 32), four at a time.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq(Args a)
{
    constexpr int LD = D + PAD, NJ = D / 32;
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* dOs = Qs + BQ * LD;
    float* Ks = dOs + BQ * LD;
    float* Vs = Ks + BK * LD;
    float* dSs = Vs + BK * LD;              // [BQ][BK + 1]
    const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int g = h / (a.H / a.KV);
    const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
    const long long qstride = (long long)a.H * D, kstride = (long long)a.KV * D;
    const long long qoff = ((long long)b * a.S + i0) * qstride + (long long)h * D;
    const long long koff = (long long)b * a.T * kstride + (long long)g * D;
    const int valid = min(BQ, a.S - i0);
    load_rows<D>(Qs, a.q + qoff, qstride, BQ, valid);
    load_rows<D>(dOs, a.dout + qoff, qstride, BQ, valid);
    __syncthreads();
    // D_i = dO_i . O_i, the 8 lanes of a row each summing 4 columns in 32
    float di[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float acc = 0.f;
        if ((ty + 32 * r) < valid) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int col = 4 * tx + 32 * j;
                const float4 o4 = *reinterpret_cast<const float4*>(a.o + qoff + (ty + 32 * r) * qstride + col);
                const float4 d4 = *reinterpret_cast<const float4*>(dOs + (ty + 32 * r) * LD + col);
                fma4(acc, o4, d4);
            }
        }
        di[r] = row_sum(acc);
    }
    // the live key tiles of rows i0 .. i0 + valid - 1
    const int nkt = (a.T + BK - 1) / BK;
    int kt_end = nkt, kt_begin = 0;
    if (a.causal) kt_end = min(nkt, (i0 + valid - 1) / BK + 1);
    if (a.window > 0) {
        const int first = i0 - a.window + 1;     // oldest kept key of the oldest row
        if (first > 0) kt_begin = first / BK;
    }
    // pass 1: each row's max and sum of exp over its kept keys
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int j0 = kt * BK;
        load_rows<D>(Ks, a.k + koff + (long long)j0 * kstride, kstride, BK, min(BK, a.T - j0));
        __syncthreads();
        float raw[2][4];
        dots<D, 2>(Qs, ty, Ks, tx, raw);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            float sv[4], tmax = -INFINITY;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float cg;
                const bool keep = kept(a, i0 + (ty + 32 * r), j0 + tx + 8 * c);
                sv[c] = keep ? score(a, raw[r][c], cg) : -INFINITY;
                tmax = fmaxf(tmax, sv[c]);
            }
            // the shuffles run on every lane; a row with no kept key in this
            // tile keeps its statistics
            tmax = row_max(tmax);
            const float mn = fmaxf(m[r], tmax);
            float part = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c)
                if (sv[c] > -INFINITY) part += expf(sv[c] - mn);
            part = row_sum(part);
            if (tmax > -INFINITY) {
                l[r] = l[r] * expf(m[r] - mn) + part;
                m[r] = mn;
            }
        }
        __syncthreads();
    }
    float lse[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lse[r] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
    // pass 2: P, dP, dS, and dQ += dS K
    float4 acc[2][NJ];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[r][j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int j0 = kt * BK, kvalid = min(BK, a.T - j0);
        load_rows<D>(Ks, a.k + koff + (long long)j0 * kstride, kstride, BK, kvalid);
        load_rows<D>(Vs, a.v + koff + (long long)j0 * kstride, kstride, BK, kvalid);
        __syncthreads();
        float raw[2][4], dp[2][4];
        dots<D, 2>(Qs, ty, Ks, tx, raw);
        dots<D, 2>(dOs, ty, Vs, tx, dp);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float ds = 0.f;
                if (kept(a, i0 + (ty + 32 * r), j0 + tx + 8 * c)) {
                    float cg;
                    const float p = expf(score(a, raw[r][c], cg) - lse[r]);
                    ds = p * (dp[r][c] - di[r]) * cg / a.sqrt_d;
                }
                dSs[(ty + 32 * r) * (BK + 1) + tx + 8 * c] = ds;
            }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            const float d0 = dSs[ty * (BK + 1) + kk], d1 = dSs[(ty + 32) * (BK + 1) + kk];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float4 kv = *reinterpret_cast<const float4*>(Ks + kk * LD + 4 * tx + 32 * j);
                axpy4(acc[0][j], d0, kv);
                axpy4(acc[1][j], d1, kv);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if ((ty + 32 * r) >= valid) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
            *reinterpret_cast<float4*>(a.dq + qoff + (ty + 32 * r) * qstride + 4 * tx + 32 * j) = acc[r][j];
        if (tx == 0) {
            const long long row = ((long long)b * a.H + h) * a.S + i0 + (ty + 32 * r);
            a.lse[row] = lse[r];
            a.dsum[row] = di[r];
        }
    }
}

// ---------------------------------------------------------------------------
// dkv: grid (ceil(T / BKV), KV, B).  Thread (ty, tx) owns key ty of the
// block; of a query tile, rows tx + 8 c (c < 4); of dK and dV, columns
// 4 tx + 32 j (j < D / 32) of key ty.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv(Args a)
{
    constexpr int LD = D + PAD, NJ = D / 32;
    extern __shared__ float4 smem4[];
    float* Ks = reinterpret_cast<float*>(smem4);
    float* Vs = Ks + BKV * LD;
    float* Qs = Vs + BKV * LD;
    float* dOs = Qs + BQ2 * LD;
    float* Ps = dOs + BQ2 * LD;             // [BKV][BQ2 + 1]
    float* dSs = Ps + BKV * (BQ2 + 1);      // [BKV][BQ2 + 1]
    float* lse_s = dSs + BKV * (BQ2 + 1);   // [BQ2]
    float* di_s = lse_s + BQ2;              // [BQ2]
    const int j0 = blockIdx.x * BKV, g = blockIdx.y, b = blockIdx.z;
    const int rep = a.H / a.KV;
    const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
    const long long qstride = (long long)a.H * D, kstride = (long long)a.KV * D;
    const long long koff = ((long long)b * a.T + j0) * kstride + (long long)g * D;
    const int kvalid = min(BKV, a.T - j0);
    load_rows<D>(Ks, a.k + koff, kstride, BKV, kvalid);
    load_rows<D>(Vs, a.v + koff, kstride, BKV, kvalid);
    // the live query tiles of keys j0 .. j0 + kvalid - 1
    const int nqt = (a.S + BQ2 - 1) / BQ2;
    const int qt_begin = a.causal ? min(nqt, j0 / BQ2) : 0;
    int qt_end = nqt;
    if (a.window > 0) qt_end = min(nqt, (j0 + kvalid - 1 + a.window - 1) / BQ2 + 1);
    float4 acc_k[NJ], acc_v[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        acc_k[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        acc_v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int hh = 0; hh < rep; ++hh) {
        const int h = g * rep + hh;
        for (int qt = qt_begin; qt < qt_end; ++qt) {
            const int i0 = qt * BQ2, qvalid = min(BQ2, a.S - i0);
            const long long qoff = ((long long)b * a.S + i0) * qstride + (long long)h * D;
            load_rows<D>(Qs, a.q + qoff, qstride, BQ2, qvalid);
            load_rows<D>(dOs, a.dout + qoff, qstride, BQ2, qvalid);
            if (tid < BQ2) {
                const long long row = ((long long)b * a.H + h) * a.S + i0 + tid;
                lse_s[tid] = tid < qvalid ? a.lse[row] : -INFINITY;
                di_s[tid] = tid < qvalid ? a.dsum[row] : 0.f;
            }
            __syncthreads();
            float raw[1][4], dp[1][4];
            dots<D, 1>(Ks, ty, Qs, tx, raw);
            dots<D, 1>(Vs, ty, dOs, tx, dp);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int qi = tx + 8 * c;
                float p = 0.f, ds = 0.f;
                if (kept(a, i0 + qi, j0 + ty)) {
                    float cg;
                    p = expf(score(a, raw[0][c], cg) - lse_s[qi]);
                    ds = p * (dp[0][c] - di_s[qi]) * cg / a.sqrt_d;
                }
                Ps[ty * (BQ2 + 1) + qi] = p;
                dSs[ty * (BQ2 + 1) + qi] = ds;
            }
            __syncthreads();
#pragma unroll 4
            for (int qq = 0; qq < BQ2; ++qq) {
                const float p = Ps[ty * (BQ2 + 1) + qq], ds = dSs[ty * (BQ2 + 1) + qq];
#pragma unroll
                for (int j = 0; j < NJ; ++j) {
                    const int col = 4 * tx + 32 * j;
                    axpy4(acc_v[j], p, *reinterpret_cast<const float4*>(dOs + qq * LD + col));
                    axpy4(acc_k[j], ds, *reinterpret_cast<const float4*>(Qs + qq * LD + col));
                }
            }
            __syncthreads();
        }
    }
    if (ty < kvalid) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const long long off = koff + ty * kstride + 4 * tx + 32 * j;
            *reinterpret_cast<float4*>(a.dk + off) = acc_k[j];
            *reinterpret_cast<float4*>(a.dv + off) = acc_v[j];
        }
    }
}

template <int D>
int launch(const Args& a, cudaStream_t stream)
{
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Smem<D>::dq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Smem<D>::dkv);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq<D><<<dim3((a.S + BQ - 1) / BQ, a.H, a.B), THREADS, Smem<D>::dq, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv<D><<<dim3((a.T + BKV - 1) / BKV, a.KV, a.B), THREADS, Smem<D>::dkv, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block of the dq (which = 0) or dkv (which =
// 1) kernel at head dim D; 0 for a D it does not take.
extern "C" long long flash_attention_bwd_smem_bytes(int D, int which)
{
    switch (D) {
        case 64: return (long long)(which ? Smem<64>::dkv : Smem<64>::dq);
        case 128: return (long long)(which ? Smem<128>::dkv : Smem<128>::dq);
        case 256: return (long long)(which ? Smem<256>::dkv : Smem<256>::dq);
        default: return 0;
    }
}

// q, o, dout, dq [B, S, H, D]; k, v, dk, dv [B, T, KV, D]; lse, dsum [B, H,
// S] scratch; all contiguous float32, 16-byte aligned.  T != S (cross mode)
// only with causal = 0 and window <= 0; window <= 0: no window; softcap <=
// 0: no softcap.  Launches the dq kernel, then the dkv kernel, on `stream`.
// Returns a cudaError_t.
extern "C" int flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o, const float* dout,
    float* dq, float* dk, float* dv, float* lse, float* dsum,
    int B, int S, int T, int H, int KV, int D, int causal, int window, float softcap,
    float sqrt_d, void* stream)
{
    if (B <= 0 || S <= 0 || T <= 0 || H <= 0 || KV <= 0) return (int)cudaSuccess;
    Args a{q, k, v, o, dout, dq, dk, dv, lse, dsum, B, S, T, H, KV, causal, window, softcap, sqrt_d};
    cudaStream_t st = (cudaStream_t)stream;
    switch (D) {
        case 64: return launch<64>(a, st);
        case 128: return launch<128>(a, st);
        case 256: return launch<256>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
