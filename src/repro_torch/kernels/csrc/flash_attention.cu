// Flash attention (blocked online softmax) for Hopper (sm_90a), both
// products in 3xTF32 on the tensor cores with FP32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:120
// (flash_attention_kernel_call -> _kernel :31).  For every batch row b,
// query head h and query position i:
//
//   o[b, i, h] = softmax_j( softcap(q[b, i, h] . k[b, j, g] / sqrt(d)) over
//                           the kept keys j ) @ v[b, :, g]
//
// with g = h / (H / KV), the kv head of query head h in the head-major order
// of the model's _repeat_kv (src/repro/models/attention.py:93).  MQA/GQA
// K/V are read in place: nothing is repeated in device memory.  Key j is
// kept for query i iff j < S, (not causal or j <= i) and (no window or
// j > i - window).  q, o are contiguous [B, S, H, D]; k, v contiguous
// [B, S, KV, D]; D is 64, 128 or 256; any S (ragged tiles are zero-filled
// on load and masked).  All four are float32, or all bfloat16.
//
// The bf16 mode is the Pallas kernel's (flash_attention.py:57-58, 78, 87,
// 134): q, k, v tiles arrive in shared memory as bf16 and each element is
// converted to float32 where a fragment is loaded from there; the scores,
// the softmax, P (never rounded to bf16) and the accumulators are float32
// as in the float32 mode, and o is rounded to bf16 once, at its store.
// The Pallas kernel scales q after its upcast; here the scale multiplies
// the float32 scores, as in the float32 mode: both apply it in float32
// and differ by one float32 rounding.  A bf16 value is exact in tf32 (its
// lo part is 0), so of the three tf32 passes the bf16 instance issues only
// those with no zero operand: hi*hi for Q K^T, and P lo * V hi, P hi * V hi
// for P V (P is float32).  The passes left out add exact zeros, so the
// result is that of all three; leaving them out also keeps the D = 256
// instance within 255 registers without spills.  bf16 mma for Q K^T is the
// later redesign.
//
// Mask rule.  The TPU kernel writes -1e30 into masked scores and the JAX
// model adds finfo(f32).min; here a masked key gets probability exactly 0
// and takes no part in the running max.  The three agree whenever a query
// row keeps at least one key, because exp(masked - max) underflows to 0
// in all of them; causal self-attention always keeps key i for query i.
// A row that kept no key at all would come out 0 here (the references
// would give the mean of v); no caller of the port produces one.
//
// Arithmetic.  Every product runs as mma.sync m16n8k8 tf32 with FP32
// accumulators, in 3xTF32: each operand x is split as hi = tf32(x),
// lo = tf32(x - hi) (the rounding of cvt.rna.tf32.f32), and a product is
// hi*lo + lo*hi + hi*hi (the lo*lo term is below FP32 rounding).  The result
// stays within a few times FP32's error, where one TF32 pass (~5e-4 relative
// at d = 256) would not; this is the kernel's only mode.  1/sqrt(d) and log2(e) are one
// multiply per score, and the softmax runs in exp2; tanh is FP32.
//
// Layout.  A block of 256 threads (8 warps) owns 128 query rows that read
// the same K/V: two query heads of one kv head at 64 positions when H/KV is
// even, else 128 positions of one head.  Each warp owns 16 of the rows with
// the full D of its output in registers (FlashAttention-2): at D = 256 that
// is 128 accumulators a thread, 252 registers in all, no spills.  The
// running max and denominator of a row live in the quad of lanes that share
// it.  S = Q K^T of a 32-key tile stays in the mma C fragments, and
// P = softmax(S) feeds P V from there: the C fragment holds keys (2t, 2t+1)
// of row g in lane (g, t), and P V takes its contraction order from that
// (A's k = t is key 2t, k = t + 4 is key 2t + 1, and V's rows are read in
// the same order), so P never passes through shared memory.  Q K^T
// contracts d in the order that lets one 16-byte shared load feed two
// k-steps.  A tile in which every row of a warp keeps every key skips the
// mask arithmetic; one in which no row keeps a key is skipped by the warp.
//
// Staging.  Q (128 rows) stays in shared memory.  K and V tiles of 32 keys
// arrive by cp.async, 16 bytes a thread, in single staggered buffers: V_j
// loads while S_j = Q K_j^T runs, K_{j+1} while P V_j runs.  Shared memory
// at D = 256: Q 128 x 272 floats, K 32 x 272, V 32 x 260 = 207,360 bytes
// (the +16 / +4 row pads make the fragment loads free of bank conflicts;
// in bf16 the V pad is +8, for 16-byte rows, and the tiles take 103,936
// bytes), opted in with cudaFuncSetAttribute: one block per SM.  Each block walks
// only the live tiles of its 128 rows (causal diagonal, window), and the
// grid issues the last (longest causal) query tiles first so that they do
// not form the tail.  The layout was chosen over a 64-row block with a
// two-stage (K, V) ring, which fits in the same shared memory but gives
// each SM 4 warps instead of 8 and feeds each K/V tile to half as many rows;
// it measured slower on the card.
//
// What bounds it on an H100: the tensor cores, 3 x 4 x kept-pairs x D FLOPs
// at the dense TF32 rate (495 TFLOP/s; the FP32 FFMA bound of the same
// work, 4 x kept-pairs x D at 67 TFLOP/s, is 2.4x longer).  mma.sync reaches
// only part of that rate, and beside each product the warps issue the
// operand splits (four integer/FP32 instructions an element; every warp
// splits the whole K and V tile for itself), the fragment loads and the
// softmax, with 8 warps per SM to hide the latencies.  wgmma on K-major
// tf32 operands in shared memory, with TMA loads, is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;             // keys per K/V tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;   // query rows (head, position) per block
constexpr float NEG = -1e30f;

// E: the element type of q, k, v, o and of their shared-memory tiles
template <int D, typename E>
struct Layout {
    static constexpr int EPC = 16 / sizeof(E);            // elements of one 16-byte copy
    static constexpr int LDK = D + 16;                     // Q and K row stride (elements)
    static constexpr int LDV = D + (sizeof(E) == 4 ? 4 : 8);   // V row stride: 16-byte rows
    static constexpr size_t q_elems = (size_t)ROWS * LDK;
    static constexpr size_t k_elems = (size_t)BK * LDK;
    static constexpr size_t v_elems = (size_t)BK * LDV;
    static constexpr size_t bytes = (q_elems + k_elems + v_elems) * sizeof(E);
};

struct Args {
    const void* q; const void* k; const void* v; void* o;
    int B, S, H, KV, hpb, nqt, causal, window;
    float scale, softcap;
};

// four neighbouring elements of a shared tile as float32 (a bf16 value is
// its bits shifted up by 16, exactly what __bfloat162float computes)
__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// two neighbouring outputs, rounded once to E
__device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? 16 : 0;     // src-size 0: zero-fill, nothing read
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo, each rounded to tf32 as cvt.rna.tf32.f32 rounds a finite
// value: add half a tf32 ulp to the magnitude's bits, drop the low 13.
// Written as integer ops because ptxas expands the cvt into four
// instructions with an Inf/NaN guard (the inputs are finite); lo's low bits
// are left in place, as ptxas leaves them after its own cvt, since the
// tensor core reads only the top 19 bits of a tf32 operand.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a b for one m16n8k8 tile: a rows (g, g+8) x k (t, t+4), b k (t, t+4)
// x column g, c rows (g, g+8) x columns (2t, 2t+1).
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s = Q_w K^T for the warp's 16 rows and the tile's 32 keys: n-tile j holds
// keys 8j..8j+7.  Lane t contracts d0 + 4t .. 4t+3 of each 16-wide slice:
// (4t, 4t+1) as k = (t, t+4) of the first k-step, (4t+2, 4t+3) of the second.
template <int D, int LDK, typename E>
__device__ __forceinline__ void qk_tile(const E* __restrict__ Qw, const E* __restrict__ Kt,
                                        int g, int t, float (&s)[4][4])
{
    constexpr bool EXACT = sizeof(E) == 2;   // bf16: tf32 hi is the value, lo is 0
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const E* q0 = Qw + g * LDK + 4 * t;
    const E* q1 = q0 + 8 * LDK;
    const E* kr = Kt + g * LDK + 4 * t;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 16) {
        const float4 qa = ld4(q0 + d0), qb = ld4(q1 + d0);
        if constexpr (EXACT) {
            const unsigned h0[4] = {__float_as_uint(qa.x), __float_as_uint(qb.x),
                                    __float_as_uint(qa.y), __float_as_uint(qb.y)};
            const unsigned h1[4] = {__float_as_uint(qa.z), __float_as_uint(qb.z),
                                    __float_as_uint(qa.w), __float_as_uint(qb.w)};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float4 kv = ld4(kr + 8 * j * LDK + d0);
                mma(s[j], h0, __float_as_uint(kv.x), __float_as_uint(kv.y));
                mma(s[j], h1, __float_as_uint(kv.z), __float_as_uint(kv.w));
            }
            continue;
        }
        unsigned h0[4], l0[4], h1[4], l1[4];   // A of k-step 0 and 1
        split(qa.x, h0[0], l0[0]); split(qb.x, h0[1], l0[1]);
        split(qa.y, h0[2], l0[2]); split(qb.y, h0[3], l0[3]);
        split(qa.z, h1[0], l1[0]); split(qb.z, h1[1], l1[1]);
        split(qa.w, h1[2], l1[2]); split(qb.w, h1[3], l1[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float4 kv = ld4(kr + 8 * j * LDK + d0);
            unsigned bh[4], bl[4];
            split(kv.x, bh[0], bl[0]); split(kv.y, bh[1], bl[1]);
            split(kv.z, bh[2], bl[2]); split(kv.w, bh[3], bl[3]);
            mma(s[j], h0, bl[0], bl[1]);
            mma(s[j], l0, bh[0], bh[1]);
            mma(s[j], h0, bh[0], bh[1]);
            mma(s[j], h1, bl[2], bl[3]);
            mma(s[j], l1, bh[2], bh[3]);
            mma(s[j], h1, bh[2], bh[3]);
        }
    }
}

// o += P V_t.  k-step j takes S's n-tile j: A = (p[j][0], p[j][2], p[j][1],
// p[j][3]) is keys 8j + 2t (k = t) and 8j + 2t + 1 (k = t + 4) of rows g,
// g + 8, so B reads V's rows in that order; n-tile n is columns 8n..8n+7.
template <int D, int LDV, typename E>
__device__ __forceinline__ void pv_tile(const E* __restrict__ Vt, int g, int t,
                                        const float (&p)[4][4], float (&o)[D / 8][4])
{
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        unsigned ah[4], al[4];
        split(p[j][0], ah[0], al[0]); split(p[j][2], ah[1], al[1]);
        split(p[j][1], ah[2], al[2]); split(p[j][3], ah[3], al[3]);
        const E* v0 = Vt + (8 * j + 2 * t) * LDV + g;
        const E* v1 = v0 + LDV;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            if constexpr (sizeof(E) == 2) {       // bf16 V: tf32 hi is the value, lo is 0
                const unsigned bh0 = __float_as_uint(ld1(v0 + 8 * n));
                const unsigned bh1 = __float_as_uint(ld1(v1 + 8 * n));
                mma(o[n], al, bh0, bh1);
                mma(o[n], ah, bh0, bh1);
                continue;
            }
            unsigned bh0, bl0, bh1, bl1;
            split(ld1(v0 + 8 * n), bh0, bl0);
            split(ld1(v1 + 8 * n), bh1, bl1);
            mma(o[n], al, bh0, bh1);
            mma(o[n], ah, bl0, bl1);
            mma(o[n], ah, bh0, bh1);
        }
    }
}

template <int D, typename E>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const Args p)
{
    using LY = Layout<D, E>;
    constexpr int LDK = LY::LDK, LDV = LY::LDV;
    constexpr int EPC = LY::EPC;
    constexpr int V4 = D / EPC;   // 16-byte chunks per row
    constexpr int NT = D / 8;     // output n-tiles per warp
    const E* __restrict__ gq = static_cast<const E*>(p.q);
    const E* __restrict__ gk = static_cast<const E*>(p.k);
    const E* __restrict__ gv = static_cast<const E*>(p.v);
    E* __restrict__ go = static_cast<E*>(p.o);

    extern __shared__ __align__(16) unsigned char smem_raw[];
    E* Qs = reinterpret_cast<E*>(smem_raw);    // [ROWS][LDK]
    E* Ks = Qs + LY::q_elems;                  // [BK][LDK]
    E* Vs = Ks + LY::k_elems;                  // [BK][LDV]

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;

    // block -> (query tile, batch row, head group); last query tiles first
    const int hb_count = p.H / p.hpb;
    const int per_tile = p.B * hb_count;
    const int qt = p.nqt - 1 - (int)(blockIdx.x / per_tile);
    const int rem = (int)(blockIdx.x % per_tile);
    const int b = rem / hb_count;
    const int head0 = (rem % hb_count) * p.hpb;
    const int pos_n = ROWS / p.hpb;            // positions per block
    const int p0 = qt * pos_n;
    const int S = p.S;
    const int kvh = head0 / (p.H / p.KV);

    // this warp's 16 rows: one head, positions wp0 .. wp0 + 15
    const int whead = head0 + (16 * warp) / pos_n;
    const int wp0 = p0 + (16 * warp) % pos_n;

    // live K/V tiles of the block: not wholly above the diagonal of its
    // newest row, not wholly out of the window of its oldest
    const int nkt = (S + BK - 1) / BK;
    const int kt_end = p.causal ? min(nkt, (min(p0 + pos_n, S) - 1) / BK + 1) : nkt;
    int kt_begin = 0;
    if (p.window > 0) {
        const int tt = p0 - p.window - BK + 1;
        if (tt >= 0) kt_begin = tt / BK + 1;
    }

    for (int i = tid; i < ROWS * V4; i += THREADS) {
        const int r = i / V4, c = (i % V4) * EPC;
        const int pos = p0 + r % pos_n;
        const bool ok = pos < S;
        const E* src = ok ? gq + ((long long)(b * S + pos) * p.H + head0 + r / pos_n) * D + c
                          : gq;
        cp_async16(Qs + r * LDK + c, src, ok);
    }
    // K or V rows k0 .. k0 + BK - 1 of kv head kvh (zeros past S)
    auto load_tile = [&](E* dst, const E* base, int ld, int k0) {
        for (int i = tid; i < BK * V4; i += THREADS) {
            const int r = i / V4, c = (i % V4) * EPC;
            const bool ok = k0 + r < S;
            const E* src = ok ? base + ((long long)(b * S + k0 + r) * p.KV + kvh) * D + c : base;
            cp_async16(dst + r * ld + c, src, ok);
        }
    };
    load_tile(Ks, gk, LDK, kt_begin * BK);
    cp_async_commit();

    float o[NT][4], m[2], l[2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;
    const E* Qw = Qs + 16 * warp * LDK;
    // scores in log2 units: exp(x) = exp2(x log2 e), log2 e folded into the scale
    constexpr float LOG2E = 1.4426950408889634f;
    const bool capped = p.softcap > 0.f;
    const float qk_scale = capped ? p.scale / p.softcap : p.scale * LOG2E;
    const float cap = p.softcap * LOG2E;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        // live: some row of the warp keeps a key of the tile; full: every
        // row keeps every key
        const bool live = wp0 < S && !(p.causal && k0 > wp0 + 15) &&
                          !(p.window > 0 && k0 + BK - 1 <= wp0 - p.window);
        const bool full = k0 + BK <= S && !(p.causal && k0 + BK - 1 > wp0) &&
                          !(p.window > 0 && k0 <= wp0 + 15 - p.window);
        cp_async_wait<0>();
        __syncthreads();          // K_kt landed; every warp is done with V_{kt-1}
        load_tile(Vs, gv, LDV, k0);
        cp_async_commit();

        float s[4][4];
        if (live) {
            qk_tile<D, LDK, E>(Qw, Ks, g, t, s);
            // scale, softcap and mask; online softmax of rows g (hh = 0), g + 8
            float alpha[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int row = wp0 + g + 8 * hh;
                unsigned keep = 0;
                float mx = NEG;
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = k0 + 8 * j + 2 * t + e;
                        float sv = s[j][2 * hh + e] * qk_scale;
                        if (capped) sv = cap * tanhf(sv);
                        const bool kp = full || (col < S && (!p.causal || col <= row) &&
                                                 (p.window <= 0 || col > row - p.window));
                        keep |= (unsigned)kp << (2 * j + e);
                        s[j][2 * hh + e] = sv;
                        if (kp) mx = fmaxf(mx, sv);
                    }
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                const float m_new = fmaxf(m[hh], mx);
                alpha[hh] = exp2f(m[hh] - m_new);
                float ps = 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float pr = (keep >> (2 * j + e)) & 1u
                                             ? exp2f(s[j][2 * hh + e] - m_new) : 0.f;
                        s[j][2 * hh + e] = pr;
                        ps += pr;
                    }
                l[hh] = l[hh] * alpha[hh] + ps;     // this lane's share of the row
                m[hh] = m_new;
            }
            if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
                    o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
                }
            }
        }

        cp_async_wait<0>();
        __syncthreads();          // V_kt landed; every warp is done with K_kt
        if (kt + 1 < kt_end) load_tile(Ks, gk, LDK, k0 + BK);
        cp_async_commit();
        if (live) pv_tile<D, LDV, E>(Vs, g, t, s, o);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float den = l[hh];
        den += __shfl_xor_sync(0xffffffffu, den, 1);
        den += __shfl_xor_sync(0xffffffffu, den, 2);
        const int row = wp0 + g + 8 * hh;
        if (row >= S) continue;
        const float inv = 1.f / fmaxf(den, 1e-30f);
        E* orow = go + ((long long)(b * S + row) * p.H + whead) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n)
            st2(orow + 8 * n, o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
}

template <int D, typename E>
int launch(Args a, cudaStream_t stream)
{
    const size_t bytes = Layout<D, E>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    a.hpb = (a.H / a.KV) % 2 == 0 ? 2 : 1;
    const int pos_n = ROWS / a.hpb;
    a.nqt = (a.S + pos_n - 1) / pos_n;
    const long long blocks = (long long)a.nqt * a.B * (a.H / a.hpb);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    flash_attention_kernel<D, E><<<(unsigned)blocks, THREADS, bytes, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename E>
long long smem_of(int D)
{
    switch (D) {
        case 64: return (long long)Layout<64, E>::bytes;
        case 128: return (long long)Layout<128, E>::bytes;
        case 256: return (long long)Layout<256, E>::bytes;
        default: return 0;
    }
}

template <typename E>
int run(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
        int D, int causal, int window, float softcap, float sqrt_d, void* stream)
{
    if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
    if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
    Args a{q, k, v, o, B, S, H, KV, 1, 1, causal, window, 1.f / sqrt_d, softcap};
    cudaStream_t st = (cudaStream_t)stream;
    switch (D) {
        case 64: return launch<64, E>(a, st);
        case 128: return launch<128, E>(a, st);
        case 256: return launch<256, E>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Dynamic shared memory of one block for head dim D (0 if D is not taken).
extern "C" long long flash_attention_smem_bytes(int D) { return smem_of<float>(D); }

// q, o [B, S, H, D]; k, v [B, S, KV, D]; all contiguous float32.
// window <= 0: no window; softcap <= 0: no softcap.  Returns a cudaError_t.
extern "C" int flash_attention_f32(
    const float* q, const float* k, const float* v, float* o,
    int B, int S, int H, int KV, int D, int causal, int window, float softcap,
    float sqrt_d, void* stream)
{
    return run<float>(q, k, v, o, B, S, H, KV, D, causal, window, softcap, sqrt_d, stream);
}

// The same on contiguous bfloat16 q, k, v, o.
extern "C" int flash_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* o,
    int B, int S, int H, int KV, int D, int causal, int window, float softcap,
    float sqrt_d, void* stream)
{
    return run<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, causal, window, softcap, sqrt_d,
                              stream);
}
