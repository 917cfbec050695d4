// Flash attention (blocked online softmax) for Hopper (sm_90a) on the tensor
// cores with FP32 accumulation: both products in 3xTF32 in the float32
// instance, bf16 mma with P split into three bf16 parts in the bf16 instance.
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
// kept for query i iff j < T, (not causal or j <= i) and (no window or
// j > i - window).  q, o are contiguous [B, S, H, D]; k, v contiguous
// [B, T, KV, D]; D is 64, 128 or 256; any S and T (ragged tiles are
// zero-filled on load and masked).  All four are float32, or all bfloat16.
//
// Cross mode: T != S is the model's cross-attention (a decoder's S queries
// against an encoder's T frames, src/repro/models/attention.py:117-157 with
// xkv), every key kept; the wrapper passes it with causal = 0 and no window
// only.  Query tiles, the grid and its order follow S; the key tiles, their
// loads and the key mask follow T.  Self-attention is T == S.
//
// Mask rule.  The TPU kernel writes -1e30 into masked scores and the JAX
// model adds finfo(f32).min; here a masked key gets probability exactly 0
// and takes no part in the running max.  The three agree whenever a query
// row keeps at least one key, because exp(masked - max) underflows to 0
// in all of them; causal self-attention always keeps key i for query i.
// A row that kept no key at all would come out 0 here (the references
// would give the mean of v); no caller of the port produces one.
//
// Layout, both instances.  A block of 256 threads (8 warps) owns 128 query
// rows that read the same K/V: two query heads of one kv head at 64
// positions when H/KV is even, else 128 positions of one head.  Each warp
// owns 16 of the rows with the full D of its output in registers
// (FlashAttention-2).  The running max and denominator of a row live in the
// quad of lanes that share it.  S = Q K^T of a key tile stays in the mma C
// fragments, and P = softmax(S) feeds P V from there, so P never passes
// through shared memory.  1/sqrt(d) and log2(e) are one multiply per
// float32 score, and the softmax runs in exp2; tanh is FP32.  A tile in
// which every row of a warp keeps every key skips the mask arithmetic; one
// in which no row keeps a key is skipped by the warp.  Each block walks
// only the live tiles of its 128 rows (causal diagonal, window), and the
// grid issues the last (longest causal) query tiles first so that they do
// not form the tail.
//
// float32 instance.  Every product runs as mma.sync m16n8k8 tf32 with FP32
// accumulators, in 3xTF32: each operand x is split as hi = tf32(x),
// lo = tf32(x - hi) (the rounding of cvt.rna.tf32.f32), and a product is
// hi*lo + lo*hi + hi*hi (the lo*lo term is below FP32 rounding).  The result
// stays within a few times FP32's error, where one TF32 pass (~5e-4 relative
// at d = 256) would not.  At D = 256 the output is 128 accumulators a
// thread, about 250 registers in all, no spills.  The C fragment holds keys (2t,
// 2t+1) of row g in lane (g, t), and P V takes its contraction order from
// that (A's k = t is key 2t, k = t + 4 is key 2t + 1, and V's rows are read
// in the same order).  Q K^T contracts d in the order that lets one 16-byte
// shared load feed two k-steps.  Q (128 rows) stays in shared memory; K and
// V tiles of 32 keys arrive by cp.async, 16 bytes a thread, in single
// staggered buffers: V_j loads while S_j = Q K_j^T runs, K_{j+1} while
// P V_j runs.  Shared memory at D = 256: Q 128 x 272 floats, K 32 x 272,
// V 32 x 260 = 207,360 bytes (the +16 / +4 row pads make the fragment loads
// free of bank conflicts), opted in with cudaFuncSetAttribute: one block
// per SM.  The layout was chosen over a 64-row block with a two-stage
// (K, V) ring, which fits in the same shared memory but gives each SM 4
// warps instead of 8 and feeds each K/V tile to half as many rows; it
// measured slower on the card.  What bounds it: the tensor cores, 3 x 4 x
// kept-pairs x D FLOPs at the dense TF32 rate (495 TFLOP/s); mma.sync
// reaches only part of that rate, and beside each product the warps issue
// the operand splits (every warp splits the whole K and V tile for itself),
// the fragment loads and the softmax.  wgmma on K-major tf32 operands in
// shared memory, with TMA loads, is the next step.
//
// bf16 instance: the Pallas kernel's bf16 mode (flash_attention.py:57-58,
// 78, 87, 134: upcast at load, float32 dots, softmax and accumulators, P
// never rounded, o rounded to bf16 once at its store).  A product of two
// bf16 values is exact in float32, so:
//
// * Q K^T is one bf16 mma.sync m16n8k16 pass, its Q and K fragments read by
//   ldmatrix straight from the bf16 [row][d] tiles: no conversion.  The
//   scale multiplies the float32 scores (the Pallas kernel scales q after its
//   upcast: both apply it in float32 and differ by one float32 rounding).
// * P V keeps P's float32 value: each probability is split into three bf16
//   parts, b1 = bf16(p), b2 = bf16(p - b1), b3 = bf16(p - b1 - b2), whose
//   sum is p exactly for p >= 2^-100 (8 + 8 + 8 significant bits cover the
//   24 of a float32; below that b3 may drop bits 2^-100 under the row's
//   largest term, far below float32 rounding of the sum).  Two adjacent n8
//   C tiles of S pack into one k16 A fragment, and each V fragment, read by
//   ldmatrix.trans from the bf16 [key][d] tile (16 bytes a lane), takes the
//   three parts in turn: three bf16 passes, whose products are exact.  The
//   parts live for one k16 step.
// * K and V tiles of BK = 64 keys land by 16-byte cp.async (8 elements) in a
//   two-stage (K, V) ring: tile j + 1 loads while tile j's products run.
//   Rows are padded by 16 bytes (stride D + 8), so ldmatrix's eight rows hit
//   distinct banks.  Shared memory: Q 128 x (D + 8) plus 2 x 2 x 64 x (D + 8)
//   bf16 = 55,296 / 104,448 / 202,752 bytes at D = 64 / 128 / 256.
// * Registers bound the rest.  A warp walks a tile in chunks of KC keys
//   (Tune): Q K^T, the softmax and P V of one chunk, its scores in KC / 2
//   registers a thread beside the D / 2 output accumulators, the 12 of one
//   k16 step's P parts and a V fragment.  At D = 64 and 128 two blocks (16
//   warps) share an SM, which needs at most 128 registers a thread: 64-key
//   chunks fit at D = 64, 16-key chunks at D = 128 (32 spill).  At D = 256
//   (128 output accumulators) one block an SM with 32-key chunks, under 255
//   registers.  ptxas' counts are printed by chip_smoke.py's llm_build
//   phase, which fails on any spill.
// * What bounds it: the tensor cores, 2 x kept-pairs x D FLOPs for Q K^T
//   and 3 x 2 x kept-pairs x D for P V at the dense bf16 rate (989 TFLOP/s;
//   chip_smoke.flash_bf16_bound).  mma.sync reaches part of that rate;
//   beside it the warps issue the fragment loads, the softmax and the P
//   splits.  wgmma fed by TMA in a producer/consumer design is the next
//   step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;   // query rows (head, position) per block
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

struct Args {
    const void* q; const void* k; const void* v; void* o;
    int B, S, T, H, KV, hpb, nqt, causal, window;   // S queries, T keys
    float scale, softcap;
};

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

// The block's place in the grid, shared by both instances: (query tile,
// batch row, head group), last query tiles first; this warp's 16 rows (one
// head, positions wp0 .. wp0 + 15); the live K/V tiles of bk keys (not
// wholly above the diagonal of the block's newest row, not wholly out of the
// window of its oldest).
struct Place {
    int b, head0, pos_n, p0, kvh, whead, wp0, kt_begin, kt_end;

    __device__ Place(const Args& p, int warp, int bk) {
        const int hb_count = p.H / p.hpb;
        const int per_tile = p.B * hb_count;
        const int qt = p.nqt - 1 - (int)(blockIdx.x / per_tile);
        const int rem = (int)(blockIdx.x % per_tile);
        b = rem / hb_count;
        head0 = (rem % hb_count) * p.hpb;
        pos_n = ROWS / p.hpb;
        p0 = qt * pos_n;
        kvh = head0 / (p.H / p.KV);
        whead = head0 + (16 * warp) / pos_n;
        wp0 = p0 + (16 * warp) % pos_n;
        const int nkt = (p.T + bk - 1) / bk;
        kt_end = p.causal ? min(nkt, (min(p0 + pos_n, p.S) - 1) / bk + 1) : nkt;
        kt_begin = 0;
        if (p.window > 0) {
            const int tt = p0 - p.window - bk + 1;
            if (tt >= 0) kt_begin = tt / bk + 1;
        }
    }
    // some row of the warp keeps a key of the tile at k0
    __device__ __forceinline__ bool live(const Args& p, int k0, int bk) const {
        return wp0 < p.S && k0 < p.T && !(p.causal && k0 > wp0 + 15) &&
               !(p.window > 0 && k0 + bk - 1 <= wp0 - p.window);
    }
    // every row of the warp keeps every key of the tile at k0
    __device__ __forceinline__ bool full(const Args& p, int k0, int bk) const {
        return k0 + bk <= p.T && !(p.causal && k0 + bk - 1 > wp0) &&
               !(p.window > 0 && k0 <= wp0 + 15 - p.window);
    }
};

// Scale, softcap and mask the warp's scores of one key tile (NJ n8 tiles
// from k0: lane (g, t) holds keys k0 + 8j + 2t + e of rows wp0 + g (hh = 0)
// and wp0 + g + 8 (hh = 1)), then the online softmax: s becomes P (masked
// keys exactly 0), m and l (this lane's share of the row sum) move on, and
// alpha is the factor the output rows must take.
template <int NJ>
__device__ __forceinline__ void online_softmax(float (&s)[NJ][4], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], const Args& p, int k0,
                                               int wp0, int g, int t, bool full)
{
    // scores in log2 units: exp(x) = exp2(x log2 e), log2 e folded into the scale
    const bool capped = p.softcap > 0.f;
    const float qk_scale = capped ? p.scale / p.softcap : p.scale * LOG2E;
    const float cap = p.softcap * LOG2E;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int row = wp0 + g + 8 * hh;
        unsigned keep = 0;
        float mx = NEG;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = k0 + 8 * j + 2 * t + e;
                float sv = s[j][2 * hh + e] * qk_scale;
                if (capped) sv = cap * tanhf(sv);
                const bool kp = full || (col < p.T && (!p.causal || col <= row) &&
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
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float pr = (keep >> (2 * j + e)) & 1u ? exp2f(s[j][2 * hh + e] - m_new) : 0.f;
                s[j][2 * hh + e] = pr;
                ps += pr;
            }
        l[hh] = l[hh] * alpha[hh] + ps;     // this lane's share of the row
        m[hh] = m_new;
    }
}

template <int NT>
__device__ __forceinline__ void rescale(float (&o)[NT][4], const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
            o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
        }
    }
}

// two neighbouring outputs, rounded once to the output's type
__device__ __forceinline__ void st2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// o / l of the warp's rows: lane (g, t) holds columns 8n + 2t, 8n + 2t + 1
// of rows wp0 + g and wp0 + g + 8
template <int D, typename E>
__device__ __forceinline__ void store_rows(const float (&o)[D / 8][4], const float (&l)[2],
                                           E* __restrict__ go, const Args& p, const Place& pl,
                                           int g, int t)
{
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float den = l[hh];
        den += __shfl_xor_sync(0xffffffffu, den, 1);
        den += __shfl_xor_sync(0xffffffffu, den, 2);
        const int row = pl.wp0 + g + 8 * hh;
        if (row >= p.S) continue;
        const float inv = 1.f / fmaxf(den, 1e-30f);
        E* orow = go + ((long long)(pl.b * p.S + row) * p.H + pl.whead) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            st2(orow + 8 * n, o[n][2 * hh] * inv, o[n][2 * hh + 1] * inv);
    }
}

// ---------------------------------------------------------------------------
// float32 instance: 3xTF32 mma.sync m16n8k8
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BK = 32;             // keys per K/V tile

template <int D>
struct Layout {
    static constexpr int LDK = D + 16;                     // Q and K row stride (floats)
    static constexpr int LDV = D + 4;                      // V row stride: 16-byte rows
    static constexpr size_t q_elems = (size_t)ROWS * LDK;
    static constexpr size_t k_elems = (size_t)BK * LDK;
    static constexpr size_t v_elems = (size_t)BK * LDV;
    static constexpr size_t bytes = (q_elems + k_elems + v_elems) * sizeof(float);
};

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
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
template <int D, int LDK>
__device__ __forceinline__ void qk_tile(const float* __restrict__ Qw, const float* __restrict__ Kt,
                                        int g, int t, float (&s)[4][4])
{
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const float* q0 = Qw + g * LDK + 4 * t;
    const float* q1 = q0 + 8 * LDK;
    const float* kr = Kt + g * LDK + 4 * t;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 16) {
        const float4 qa = ld4(q0 + d0), qb = ld4(q1 + d0);
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
template <int D, int LDV>
__device__ __forceinline__ void pv_tile(const float* __restrict__ Vt, int g, int t,
                                        const float (&p)[4][4], float (&o)[D / 8][4])
{
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        unsigned ah[4], al[4];
        split(p[j][0], ah[0], al[0]); split(p[j][2], ah[1], al[1]);
        split(p[j][1], ah[2], al[2]); split(p[j][3], ah[3], al[3]);
        const float* v0 = Vt + (8 * j + 2 * t) * LDV + g;
        const float* v1 = v0 + LDV;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            unsigned bh0, bl0, bh1, bl1;
            split(v0[8 * n], bh0, bl0);
            split(v1[8 * n], bh1, bl1);
            mma(o[n], al, bh0, bh1);
            mma(o[n], ah, bl0, bl1);
            mma(o[n], ah, bh0, bh1);
        }
    }
}

}  // namespace f32

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const Args p)
{
    using LY = f32::Layout<D>;
    constexpr int BK = f32::BK;
    constexpr int LDK = LY::LDK, LDV = LY::LDV;
    constexpr int V4 = D / 4;     // 16-byte chunks per row
    constexpr int NT = D / 8;     // output n-tiles per warp
    const float* __restrict__ gq = static_cast<const float*>(p.q);
    const float* __restrict__ gk = static_cast<const float*>(p.k);
    const float* __restrict__ gv = static_cast<const float*>(p.v);

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);    // [ROWS][LDK]
    float* Ks = Qs + LY::q_elems;                      // [BK][LDK]
    float* Vs = Ks + LY::k_elems;                      // [BK][LDV]

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const Place pl(p, warp, BK);
    const int S = p.S;

    for (int i = tid; i < ROWS * V4; i += THREADS) {
        const int r = i / V4, c = (i % V4) * 4;
        const int pos = pl.p0 + r % pl.pos_n;
        const bool ok = pos < S;
        const float* src = ok ? gq + ((long long)(pl.b * S + pos) * p.H + pl.head0 + r / pl.pos_n) * D + c
                              : gq;
        cp_async16(Qs + r * LDK + c, src, ok);
    }
    // K or V rows k0 .. k0 + BK - 1 of kv head kvh (zeros past T)
    auto load_tile = [&](float* dst, const float* base, int ld, int k0) {
        for (int i = tid; i < BK * V4; i += THREADS) {
            const int r = i / V4, c = (i % V4) * 4;
            const bool ok = k0 + r < p.T;
            const float* src = ok ? base + ((long long)(pl.b * p.T + k0 + r) * p.KV + pl.kvh) * D + c
                                  : base;
            cp_async16(dst + r * ld + c, src, ok);
        }
    };
    load_tile(Ks, gk, LDK, pl.kt_begin * BK);
    cp_async_commit();

    float o[NT][4], m[2], l[2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;
    const float* Qw = Qs + 16 * warp * LDK;

    for (int kt = pl.kt_begin; kt < pl.kt_end; ++kt) {
        const int k0 = kt * BK;
        const bool live = pl.live(p, k0, BK);
        cp_async_wait<0>();
        __syncthreads();          // K_kt landed; every warp is done with V_{kt-1}
        load_tile(Vs, gv, LDV, k0);
        cp_async_commit();

        float s[4][4];
        if (live) {
            f32::qk_tile<D, LDK>(Qw, Ks, g, t, s);
            float alpha[2];
            online_softmax<4>(s, m, l, alpha, p, k0, pl.wp0, g, t, pl.full(p, k0, BK));
            rescale<NT>(o, alpha);
        }

        cp_async_wait<0>();
        __syncthreads();          // V_kt landed; every warp is done with K_kt
        if (kt + 1 < pl.kt_end) load_tile(Ks, gk, LDK, k0 + BK);
        cp_async_commit();
        if (live) f32::pv_tile<D, LDV>(Vs, g, t, s, o);
    }
    store_rows<D, float>(o, l, static_cast<float*>(p.o), p, pl, g, t);
}

// ---------------------------------------------------------------------------
// bf16 instance: bf16 mma.sync m16n8k16, P V in three bf16 parts of P
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BK = 64;             // keys per K/V tile

// per head dim: the keys of one compute chunk of a tile (its scores live in
// registers: KC / 2 a thread) and the resident blocks per SM the registers
// are budgeted for (two blocks: at most 128 registers a thread).  Chosen on
// the card among 16/32/64-key chunks at one and two blocks an SM, as the
// fastest without a spill.
template <int D> struct Tune {
    static constexpr int KC = D == 64 ? 64 : D == 128 ? 16 : 32;
    static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
};

template <int D>
struct Layout {
    static constexpr int LD = D + 8;                       // row stride (elements): 16-byte pad
    static constexpr size_t q_elems = (size_t)ROWS * LD;
    static constexpr size_t kv_elems = (size_t)BK * LD;    // one K or V tile
    static constexpr size_t bytes = (q_elems + 4 * kv_elems) * sizeof(bf16);   // Q, 2 x (K, V)
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a b for one m16n8k16 tile: a rows (g, g+8) x k (2t, 2t+1, 2t+8,
// 2t+9), b those k x column g, c rows (g, g+8) x columns (2t, 2t+1)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ unsigned bits(__nv_bfloat162 h) {
    return *reinterpret_cast<unsigned*>(&h);
}
// (x, y) = b1 + b2 + b3 in bf16 pairs, each part the rounding of what the
// earlier ones left
__device__ __forceinline__ void split3(float x, float y, unsigned& h1, unsigned& h2, unsigned& h3) {
    const __nv_bfloat162 b1 = __floats2bfloat162_rn(x, y);
    const float2 f1 = __bfloat1622float2(b1);
    const float rx = x - f1.x, ry = y - f1.y;
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(rx, ry);
    const float2 f2 = __bfloat1622float2(b2);
    h1 = bits(b1);
    h2 = bits(b2);
    h3 = bits(__floats2bfloat162_rn(rx - f2.x, ry - f2.y));
}

}  // namespace tc

template <int D>
__global__ void __launch_bounds__(THREADS, tc::Tune<D>::MIN_BLOCKS)
flash_attention_bf16_kernel(const Args p)
{
    using LY = tc::Layout<D>;
    constexpr int BK = tc::BK;
    constexpr int KC = tc::Tune<D>::KC;
    constexpr int LD = LY::LD;
    constexpr int V8 = D / 8;     // 16-byte chunks per row
    constexpr int NT = D / 8;     // output n-tiles per warp
    constexpr int NJ = KC / 8;    // score n-tiles per warp and chunk
    const bf16* __restrict__ gq = static_cast<const bf16*>(p.q);
    const bf16* __restrict__ gk = static_cast<const bf16*>(p.k);
    const bf16* __restrict__ gv = static_cast<const bf16*>(p.v);

    extern __shared__ __align__(16) unsigned char smem_tc[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_tc);   // [ROWS][LD]
    bf16* KV = Qs + LY::q_elems;                   // stage st: K [BK][LD], then V [BK][LD]

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int mi = lane >> 3, rw = lane & 7;       // ldmatrix: this lane's matrix and row
    const Place pl(p, warp, BK);
    const int S = p.S;

    for (int i = tid; i < ROWS * V8; i += THREADS) {
        const int r = i / V8, c = (i % V8) * 8;
        const int pos = pl.p0 + r % pl.pos_n;
        const bool ok = pos < S;
        const bf16* src = ok ? gq + ((long long)(pl.b * S + pos) * p.H + pl.head0 + r / pl.pos_n) * D + c
                             : gq;
        cp_async16(Qs + r * LD + c, src, ok);
    }
    // K and V rows k0 .. k0 + BK - 1 of kv head kvh into ring stage st (zeros past T)
    auto load_kv = [&](int st, int k0) {
        bf16* Kd = KV + 2 * st * LY::kv_elems;
        bf16* Vd = Kd + LY::kv_elems;
#pragma unroll 1          // rolled: no per-chunk offsets held across the tile loop
        for (int i = tid; i < BK * V8; i += THREADS) {
            const int r = i / V8, c = (i % V8) * 8;
            const bool ok = k0 + r < p.T;
            const long long off = ((long long)(pl.b * p.T + k0 + r) * p.KV + pl.kvh) * D + c;
            cp_async16(Kd + r * LD + c, ok ? gk + off : gk, ok);
            cp_async16(Vd + r * LD + c, ok ? gv + off : gv, ok);
        }
    };
    load_kv(0, pl.kt_begin * BK);
    cp_async_commit();

    float o[NT][4], m[2], l[2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.f;
    // ldmatrix row addresses of this lane: Q's A fragments (rows 16 warp +
    // (lane % 16), d 8 (lane / 16)); K's B fragments of n-tiles (j, j + 1)
    // (keys rw + 8 (mi / 2), d 8 (mi % 2)); V's transposed B fragments of
    // n-tiles (n, n + 1) (keys rw + 8 (mi % 2), d 8 (mi / 2))
    const unsigned q_addr = tc::smem_u32(Qs + (16 * warp + (lane & 15)) * LD + 8 * (lane >> 4));
    const unsigned k_addr0 = tc::smem_u32(KV + (rw + 8 * (mi >> 1)) * LD + 8 * (mi & 1));
    const unsigned v_addr0 = tc::smem_u32(KV + LY::kv_elems + (rw + 8 * (mi & 1)) * LD + 8 * (mi >> 1));

    for (int kt = pl.kt_begin; kt < pl.kt_end; ++kt) {
        const int st = (kt - pl.kt_begin) & 1;
        const int k0 = kt * BK;
        cp_async_wait<0>();
        __syncthreads();          // K_kt, V_kt landed; every warp is done with the other stage
        if (kt + 1 < pl.kt_end) load_kv(st ^ 1, k0 + BK);
        cp_async_commit();
#pragma unroll 1
        for (int c0 = 0; c0 < BK; c0 += KC) {
            const int kc = k0 + c0;       // the chunk's first key
            if (!pl.live(p, kc, KC)) continue;
            const unsigned chunk = 2u * (unsigned)(2 * st * LY::kv_elems + c0 * LD);   // bytes
            const unsigned k_addr = k_addr0 + chunk, v_addr = v_addr0 + chunk;

            // S = Q K^T: d in k16 steps, keys in pairs of n8 tiles
            float s[NJ][4];
#pragma unroll
            for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
            for (int d0 = 0; d0 < D; d0 += 16) {
                unsigned a[4];
                tc::ldsm_x4(a, q_addr + 2 * d0);
#pragma unroll
                for (int j = 0; j < NJ; j += 2) {
                    unsigned bk[4];
                    tc::ldsm_x4(bk, k_addr + 2 * (8 * j * LD + d0));
                    tc::mma(s[j], a, bk[0], bk[1]);
                    tc::mma(s[j + 1], a, bk[2], bk[3]);
                }
            }
            float alpha[2];
            online_softmax<NJ>(s, m, l, alpha, p, kc, pl.wp0, g, t, pl.full(p, kc, KC));
            rescale<NT>(o, alpha);

            // O += P V: keys in k16 steps (P from S's n-tiles 2kk, 2kk + 1, in
            // three bf16 parts), d in pairs of n8 tiles
#pragma unroll
            for (int kk = 0; kk < KC / 16; ++kk) {
                unsigned p1[4], p2[4], p3[4];
                tc::split3(s[2 * kk][0], s[2 * kk][1], p1[0], p2[0], p3[0]);
                tc::split3(s[2 * kk][2], s[2 * kk][3], p1[1], p2[1], p3[1]);
                tc::split3(s[2 * kk + 1][0], s[2 * kk + 1][1], p1[2], p2[2], p3[2]);
                tc::split3(s[2 * kk + 1][2], s[2 * kk + 1][3], p1[3], p2[3], p3[3]);
#pragma unroll
                for (int n = 0; n < NT; n += 2) {
                    unsigned bv[4];
                    tc::ldsm_x4_t(bv, v_addr + 2 * (16 * kk * LD + 8 * n));
                    tc::mma(o[n], p3, bv[0], bv[1]);
                    tc::mma(o[n], p2, bv[0], bv[1]);
                    tc::mma(o[n], p1, bv[0], bv[1]);
                    tc::mma(o[n + 1], p3, bv[2], bv[3]);
                    tc::mma(o[n + 1], p2, bv[2], bv[3]);
                    tc::mma(o[n + 1], p1, bv[2], bv[3]);
                }
            }
        }
    }
    cp_async_wait<0>();
    store_rows<D, bf16>(o, l, static_cast<bf16*>(p.o), p, pl, g, t);
}

template <int D, bool BF16>
int launch(Args a, cudaStream_t stream)
{
    const size_t bytes = BF16 ? tc::Layout<D>::bytes : f32::Layout<D>::bytes;
    void (*kern)(const Args) = BF16 ? flash_attention_bf16_kernel<D> : flash_attention_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute((const void*)kern,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    a.hpb = (a.H / a.KV) % 2 == 0 ? 2 : 1;
    const int pos_n = ROWS / a.hpb;
    a.nqt = (a.S + pos_n - 1) / pos_n;
    const long long blocks = (long long)a.nqt * a.B * (a.H / a.hpb);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    kern<<<(unsigned)blocks, THREADS, bytes, stream>>>(a);
    return (int)cudaGetLastError();
}

template <bool BF16>
int run(const void* q, const void* k, const void* v, void* o, int B, int S, int T, int H, int KV,
        int D, int causal, int window, float softcap, float sqrt_d, void* stream)
{
    if (B <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
    if (KV <= 0 || H % KV != 0 || T <= 0) return (int)cudaErrorInvalidValue;
    // causal masks and windows are self-attention's: T == S
    if (T != S && (causal || window > 0)) return (int)cudaErrorInvalidValue;
    Args a{q, k, v, o, B, S, T, H, KV, 1, 1, causal, window, 1.f / sqrt_d, softcap};
    cudaStream_t st = (cudaStream_t)stream;
    switch (D) {
        case 64: return launch<64, BF16>(a, st);
        case 128: return launch<128, BF16>(a, st);
        case 256: return launch<256, BF16>(a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Dynamic shared memory of one block for head dim D (0 if D is not taken),
// of the float32 (is_bf16 = 0) or the bf16 (is_bf16 = 1) instance.
extern "C" long long flash_attention_smem_bytes(int D, int is_bf16)
{
    switch (D) {
        case 64: return (long long)(is_bf16 ? tc::Layout<64>::bytes : f32::Layout<64>::bytes);
        case 128: return (long long)(is_bf16 ? tc::Layout<128>::bytes : f32::Layout<128>::bytes);
        case 256: return (long long)(is_bf16 ? tc::Layout<256>::bytes : f32::Layout<256>::bytes);
        default: return 0;
    }
}

// q, o [B, S, H, D]; k, v [B, T, KV, D]; all contiguous float32.  T != S
// (cross mode) only with causal = 0 and window <= 0.
// window <= 0: no window; softcap <= 0: no softcap.  Returns a cudaError_t.
extern "C" int flash_attention_f32(
    const float* q, const float* k, const float* v, float* o,
    int B, int S, int T, int H, int KV, int D, int causal, int window, float softcap,
    float sqrt_d, void* stream)
{
    return run<false>(q, k, v, o, B, S, T, H, KV, D, causal, window, softcap, sqrt_d, stream);
}

// The same on contiguous bfloat16 q, k, v, o.
extern "C" int flash_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, __nv_bfloat16* o,
    int B, int S, int T, int H, int KV, int D, int causal, int window, float softcap,
    float sqrt_d, void* stream)
{
    return run<true>(q, k, v, o, B, S, T, H, KV, D, causal, window, softcap, sqrt_d, stream);
}
