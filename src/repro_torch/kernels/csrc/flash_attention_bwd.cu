// Flash attention backward for Hopper (sm_90a), float32, on the tensor cores
// in 3xTF32 (FlashAttention-2's backward).
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
// Kernels, launched in order by one entry point, no atomics:
//
// * dq: a block owns ROWS query rows of one (batch row, head), their Q and
//   dO resident in shared memory, and computes D from dO and O.  It walks
//   the live key tiles twice, K (then K and V) arriving through a two-stage
//   cp.async ring: once for each row's max and sum of exp (the row
//   statistics are recomputed, so the forward kernel, its bits and its times
//   stay as they are), once for S = Q K^T and dP = dO V^T, from which P and
//   dS are formed in the mma C fragments and dS feeds dQ += dS K from
//   registers.  It writes dQ and each row's log-sum-exp (log2 units) and D
//   into a [B, H, Sp] scratch (Sp = S rounded up to ROW_PAD; rows past S hold
//   0).
// * dkv: a block owns ROWS keys of one (batch row, kv head), their K and V
//   resident, and walks (query head, live query tile) pairs of its group in
//   order, the Q and dO tiles and their log-sum-exp and D rows arriving
//   through a two-stage cp.async ring.  It computes S^T = K Q^T and dP^T =
//   V dO^T, P and dS in the C fragments, and dV += P^T dO, dK += dS^T Q from
//   registers.  The sum over the query heads happens inside the block, in a
//   fixed order.
// * A grid that fills the card: where ceil(T / ROWS) x KV x B is under the
//   SM count, the walk of each key block is cut into n_split contiguous
//   ranges (n_split_of: the count that finishes in the fewest waves per
//   split, from the shape and the SM count only), each written into its own
//   slice of a [2, n_split, B, T, KV, D] scratch, and reduce sums the slices
//   in split order.  With n_split = 1 dkv writes dK and dV itself.  Two runs
//   are bit-identical.
//
// Mask rule: key j is kept for query i iff j < T, i < S, (not causal or
// j <= i) and (no window or j > i - window), as in the forward.  A masked
// pair has P = 0 and dS = 0 exactly and adds nothing.  A warp skips a tile
// in which none of its pairs is kept and skips the mask arithmetic of one in
// which all are.  A row with no kept key (which no caller builds: causal
// self-attention keeps key i) has a log-sum-exp of -inf; every pair of it is
// masked, so its dQ is 0 and it adds nothing to dK or dV: no NaN.
//
// Products.  Every product is mma.sync m16n8k8 tf32 with FP32 accumulators
// in 3xTF32, as the forward's float32 instance (csrc/flash_attention.cu):
// each operand x is split as hi = tf32(x), lo = x - hi and a product is
// hi*lo + lo*hi + hi*hi; one TF32 pass would miss the 1e-4 bar at d 256.
// A warp owns 16 rows of the block's resident operand, split into tf32 parts
// as it is read (a resident copy in hi and lo would not fit beside the ring
// at d 256: Q and dO of 64 rows take 128 KB as they are).  The score
// products (S, dP; S^T, dP^T) contract d in the forward's qk_tile order,
// their B operand the streamed tile's rows.  The output products (dQ; dV,
// dK) take A from the score tile's C fragment as the forward's P V does
// (k = t is column 2t, k = t + 4 column 2t + 1), and B from the streamed
// tile read 16 bytes a lane along d: lane g reads columns 4g .. 4g + 3 of a
// 32-column group, which are four n-tiles' column g, so an output n-tile
// 4m + e holds columns 32m + 4(2t) + e and 32m + 4(2t + 1) + e, and lane
// (g, t) stores 8 contiguous floats of each of its rows.  Each tile's part
// of an output is summed in fresh C fragments and added to the running sum
// in FP32: the tensor cores truncate every sum they accumulate, and a C
// fragment carried over the ~9,000 mma of a long dK/dV walk drifted 1e-4
// of max|dK| towards zero (qwen3-32b's causal shape on an H100).  Both
// read patterns touch every tile, so tiles are not padded but swizzled:
// 16-byte chunk c of row r sits at chunk c ^ sw(r) of its 128-byte group,
// which keeps every quarter warp of both patterns on distinct banks.  Where
// the output columns of a warp would not fit its registers, SPLIT warps
// share the 16 rows (Tune: 2 for dq at d 256, 2 for dkv at d 128, 4 at d
// 256, where dK and dV of 16 keys are 256 floats a thread): each contracts
// D / SPLIT of d for the scores, the group exchanges the partial C
// fragments through shared memory under a named barrier, each warp sums
// them in the same order, and each accumulates its D / SPLIT output
// columns.
//
// What bounds it: the tensor cores, 3 x 10 x kept pairs x D FLOPs of the
// five products at the dense TF32 rate (495 TFLOP/s).  It does 16 x kept
// pairs x D: S and dP in both kernels (4 more) and the statistics pass's S
// (2 more).
// mma.sync reaches part of that rate; beside each product the warps issue
// the operand splits, the fragment loads and the softmax arithmetic.
// Shared memory a block (Layout<>::bytes): resident tiles 2 x ROWS x D, the
// ring 2 x (2 x TILE x D + 2 x TILE), the exchange 8 x 2 x TILE x 16 floats
// under SPLIT > 1; at d 256 213,248 bytes (dq: 64 rows, 16-row tiles) and
// 229,888 (dkv: 32 keys, 32-row tiles).  ptxas' registers and spills are
// printed by chip_smoke.py's llm_train_kernel phase, which fails on any
// spill.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;          // cp.async ring stages of the streamed tiles
constexpr int ROW_PAD = 64;        // the scratch's rows: S rounded up to this
constexpr int MAX_SPLIT = 16;      // most ranges a dK/dV key block is cut into
constexpr float LOG2E = 1.4426950408889634f;

// Per head dim: warps that share 16 rows (each contracting and owning D /
// SPLIT columns) and the rows of a streamed tile, for the dq kernel (query
// rows resident, key tiles streamed) and the dkv kernel (keys resident,
// query tiles streamed).
template <int D> struct Tune;
template <> struct Tune<64> { static constexpr int Q_SPLIT = 1, Q_TILE = 64, KV_SPLIT = 1, KV_TILE = 32; };
template <> struct Tune<128> { static constexpr int Q_SPLIT = 1, Q_TILE = 32, KV_SPLIT = 2, KV_TILE = 32; };
template <> struct Tune<256> { static constexpr int Q_SPLIT = 2, Q_TILE = 16, KV_SPLIT = 4, KV_TILE = 32; };

template <int D, int SPLIT, int TILE>
struct Layout {
    static constexpr int ROWS = 16 * WARPS / SPLIT;         // resident rows of a block
    static constexpr int DW = D / SPLIT;                    // columns of a warp
    static constexpr int NJ = TILE / 8;                     // n-tiles of a score tile
    static constexpr size_t res = (size_t)ROWS * D;         // one resident tile (floats)
    static constexpr size_t tile = (size_t)TILE * D;        // one streamed tile
    static constexpr size_t stage = 2 * tile + 2 * TILE;    // two tiles (+ lse and D rows in dkv)
    static constexpr size_t xw = (size_t)2 * NJ * 4 * 32;   // one warp's exchange slot
    static constexpr size_t xch = SPLIT > 1 ? WARPS * xw : 0;
    static constexpr size_t bytes = (2 * res + STAGES * stage + xch) * sizeof(float);
    static_assert(bytes <= 232448, "a block has at most 227 KB of shared memory");
};
template <int D> using QL = Layout<D, Tune<D>::Q_SPLIT, Tune<D>::Q_TILE>;
template <int D> using KL = Layout<D, Tune<D>::KV_SPLIT, Tune<D>::KV_TILE>;

struct Args {
    const float *q, *k, *v, *o, *dout;
    float *dq, *dk, *dv, *lse, *dsum, *part;
    int B, S, T, H, KV, Sp, causal, window, n_split;
    float softcap, scale;          // scale = 1 / sqrt(d)
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

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// The swizzle of row r: chunk c of the row sits at chunk c ^ sw(r) (only the
// low three bits of c change).  Rows 2p and 2p + 1 differ in bit 2 (the qk
// pattern: a quarter warp reads rows 2p, 2p + 1 at chunks C .. C + 3), and
// rows 0, 2, 4, 6 (and 1, 3, 5, 7) take 0, 2, 4, 6 in some order (the output
// pattern: rows 2t (+ 1) at chunk g, g in {0, 1} a quarter warp).
__device__ __forceinline__ int sw(int r) {
    return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2);
}

// Rows 0 .. rows - 1 of a [rows][D] tile (row r at src + r * stride; rows
// from `valid` on zero-filled) into shared memory, swizzled, by cp.async.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride, int rows,
                                          int valid) {
    constexpr int C = D / 4;
    for (int i = threadIdx.x; i < rows * C; i += THREADS) {
        const int r = i / C, c = i % C;
        const bool ok = r < valid;
        cp_async16(dst + r * D + 4 * (c ^ sw(r)), ok ? src + r * stride + 4 * c : src, ok);
    }
}

// x = hi + lo: hi rounded to tf32 as cvt.rna.tf32.f32 rounds a finite
// value, lo = x - hi exact in float32, left for the tensor core to cut to
// its top 19 bits.  The forward's split (csrc/flash_attention.cu) also rounds
// lo; cutting it instead errs by less than 2^-22 |x|, with the sign of lo,
// which is random against the product's, and saves one instruction in four
// (5-7 % of the backward's time on an H100, the same error).
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b for one m16n8k8 tile: a rows (g, g+8) x k (t, t+4), b k (t, t+4)
// x column g, c rows (g, g+8) x columns (2t, 2t+1).
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s = A_w B^T over columns d0 .. d0 + DW - 1: A_w the warp's 16 resident
// rows, B the streamed tile, n-tile j its rows 8j .. 8j + 7.  Lane t
// contracts 4t .. 4t + 3 of each 16-column slice, (4t, 4t + 1) as k = (t,
// t + 4) of the first k-step, (4t + 2, 4t + 3) of the second (qk_tile's
// order).  Rows g, g + 8 and 8j + g share the swizzle sw(g).
template <int D, int DW, int NJ>
__device__ __forceinline__ void scores(const float* __restrict__ A, const float* __restrict__ Bt,
                                       int d0, int g, int t, float (&s)[NJ][4])
{
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const int x = sw(g);
    const float* a0 = A + g * D;
    const float* a1 = a0 + 8 * D;
    const float* b0 = Bt + g * D;
    const int o[2] = {4 * (t ^ x), 4 * ((t + 4) ^ x)};
#pragma unroll
    for (int u = 0; u < DW / 32; ++u) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int off = d0 + 32 * u + o[hf];
            const float4 qa = ld4(a0 + off), qb = ld4(a1 + off);
            unsigned h0[4], l0[4], h1[4], l1[4];   // A of k-step 0 and 1
            split(qa.x, h0[0], l0[0]); split(qb.x, h0[1], l0[1]);
            split(qa.y, h0[2], l0[2]); split(qb.y, h0[3], l0[3]);
            split(qa.z, h1[0], l1[0]); split(qb.z, h1[1], l1[1]);
            split(qa.w, h1[2], l1[2]); split(qb.w, h1[3], l1[3]);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const float4 kv = ld4(b0 + 8 * j * D + off);
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
}

// out += P B over the streamed tile's rows, for output columns d0 .. d0 +
// DW - 1.  k-step j takes P's n-tile j: A = (p[j][0], p[j][2], p[j][1],
// p[j][3]) is tile rows 8j + 2t (k = t) and 8j + 2t + 1 (k = t + 4).  Lane g
// reads 16 bytes at columns d0 + 32m + 4g of each row: column g of n-tiles
// 4m .. 4m + 3.  The tile's part of four n-tiles is summed by the mma in
// fresh registers and added to out in FP32 (the header: truncated sums).
template <int D, int DW, int NJ>
__device__ __forceinline__ void accumulate(const float* __restrict__ Bt, int d0, int g, int t,
                                           const float (&p)[NJ][4], float (&out)[DW / 8][4])
{
    const float* r0 = Bt + 2 * t * D + d0 + 4 * (g ^ sw(2 * t));
    const float* r1 = Bt + (2 * t + 1) * D + d0 + 4 * (g ^ sw(2 * t + 1));
    unsigned ah[NJ][4], al[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        split(p[j][0], ah[j][0], al[j][0]); split(p[j][2], ah[j][1], al[j][1]);
        split(p[j][1], ah[j][2], al[j][2]); split(p[j][3], ah[j][3], al[j][3]);
    }
#pragma unroll
    for (int m = 0; m < DW / 32; ++m) {
        float c[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e][0] = c[e][1] = c[e][2] = c[e][3] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const float4 u = ld4(r0 + 8 * j * D + 32 * m), w = ld4(r1 + 8 * j * D + 32 * m);
            const float uu[4] = {u.x, u.y, u.z, u.w}, ww[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                unsigned bh0, bl0, bh1, bl1;
                split(uu[e], bh0, bl0);
                split(ww[e], bh1, bl1);
                mma(c[e], al[j], bh0, bh1);
                mma(c[e], ah[j], bl0, bl1);
                mma(c[e], ah[j], bh0, bh1);
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < 4; ++i) out[4 * m + e][i] += c[e][i];
    }
}

// The output rows g, g + 8 of a warp's accumulators (columns d0 + 32m + 8t
// .. + 7 of each row) into dst (row 0 of the warp at dst, rows `stride`
// apart); rows from `valid` on are not written.
template <int NT>
__device__ __forceinline__ void store_rows(float* dst, long long stride, int valid, int g, int t,
                                           const float (&o)[NT][4])
{
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int r = g + 8 * hh;
        if (r >= valid) continue;
        float* p = dst + r * stride + 8 * t;
#pragma unroll
        for (int m = 0; m < NT / 4; ++m) {
            st4(p + 32 * m, o[4 * m][2 * hh], o[4 * m + 1][2 * hh], o[4 * m + 2][2 * hh],
                o[4 * m + 3][2 * hh]);
            st4(p + 32 * m + 4, o[4 * m][2 * hh + 1], o[4 * m + 1][2 * hh + 1],
                o[4 * m + 2][2 * hh + 1], o[4 * m + 3][2 * hh + 1]);
        }
    }
}

// SPLIT > 1: the SPLIT warps that share 16 rows (warps rg, rg + 8 / SPLIT,
// ...; slot w of xch is warp w's) each hold the score tiles over their part
// of d.  Each writes its part, the group meets at named barrier 1 + rg, and
// each sums all parts in part order, so all get the same bits.
template <int NJ, int SPLIT, bool TWO>
__device__ __forceinline__ void exchange(float (&s)[NJ][4], float (&dp)[NJ][4], float* xch,
                                         int warp, int rg, int lane)
{
    constexpr int XW = 2 * NJ * 4 * 32, GROUPS = WARPS / SPLIT;
    float* mine = xch + warp * XW + 4 * lane;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        st4(mine + 128 * j, s[j][0], s[j][1], s[j][2], s[j][3]);
        if (TWO) st4(mine + 128 * (NJ + j), dp[j][0], dp[j][1], dp[j][2], dp[j][3]);
    }
    asm volatile("bar.sync %0, %1;\n" :: "r"(1 + rg), "r"(32 * SPLIT) : "memory");
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        float4 x = ld4(xch + rg * XW + 4 * lane + 128 * j), y;
        if (TWO) y = ld4(xch + rg * XW + 4 * lane + 128 * (NJ + j));
#pragma unroll
        for (int k = 1; k < SPLIT; ++k) {
            const float* part = xch + (k * GROUPS + rg) * XW + 4 * lane;
            const float4 u = ld4(part + 128 * j);
            x.x += u.x; x.y += u.y; x.z += u.z; x.w += u.w;
            if (TWO) {
                const float4 w = ld4(part + 128 * (NJ + j));
                y.x += w.x; y.y += w.y; y.z += w.z; y.w += w.w;
            }
        }
        s[j][0] = x.x; s[j][1] = x.y; s[j][2] = x.z; s[j][3] = x.w;
        if (TWO) { dp[j][0] = y.x; dp[j][1] = y.y; dp[j][2] = y.z; dp[j][3] = y.w; }
    }
}

__device__ __forceinline__ bool kept(const Args& a, int i, int j) {
    return i < a.S && j < a.T && (!a.causal || j <= i) && (a.window <= 0 || j > i - a.window);
}
// some pair (query i, key j) of [i0, i0 + ni) x [j0, j0 + nj) is kept
__device__ __forceinline__ bool any_kept(const Args& a, int i0, int ni, int j0, int nj) {
    const int i1 = min(i0 + ni, a.S) - 1, j1 = min(j0 + nj, a.T) - 1;
    return i0 <= i1 && j0 <= j1 && (!a.causal || j0 <= i1) && (a.window <= 0 || j1 > i0 - a.window);
}
// every pair of it is
__device__ __forceinline__ bool all_kept(const Args& a, int i0, int ni, int j0, int nj) {
    const int i1 = i0 + ni - 1, j1 = j0 + nj - 1;
    return i1 < a.S && j1 < a.T && (!a.causal || j1 <= i0) && (a.window <= 0 || j0 > i1 - a.window);
}

// The softcapped score of a raw dot product in log2 units, and the factor
// the softcap puts on the gradient, 1 - tanh^2(s1 / c) (1 without one).
__device__ __forceinline__ float score2(const Args& a, float raw, float& cap_grad) {
    if (a.softcap > 0.f) {
        const float th = tanhf(raw * a.scale / a.softcap);
        cap_grad = 1.f - th * th;
        return a.softcap * LOG2E * th;
    }
    cap_grad = 1.f;
    return raw * (a.scale * LOG2E);
}

// dq's first pass: the running max m and this lane's share l of the sum of
// exp2 over the kept keys, rows r0 + g (+ 8), columns c0 + 8j + 2t + e.
template <int NJ>
__device__ __forceinline__ void row_stats(const Args& a, const float (&s)[NJ][4], float (&m)[2],
                                          float (&l)[2], int r0, int c0, int g, int t, bool full)
{
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g + 8 * hh;
        float sv[NJ][2], mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float cg;
                const float x = score2(a, s[j][2 * hh + e], cg);
                sv[j][e] = full || kept(a, r, c0 + 8 * j + 2 * t + e) ? x : -INFINITY;
                mx = fmaxf(mx, sv[j][e]);
            }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[hh], mx);
        if (mn == -INFINITY) continue;        // no kept key yet (uniform over the quad)
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) ps += exp2f(sv[j][e] - mn);
        l[hh] = l[hh] * exp2f(m[hh] - mn) + ps;
        m[hh] = mn;
    }
}

// P and dS of a score tile, rows r0 + g (+ 8), columns c0 + 8j + 2t + e:
// queries are the rows (QROWS, dq; lse and D per row) or the columns (dkv;
// lse and D from the stage, per column).  s holds the raw Q K^T products and
// dp the dO V^T ones; on return s holds P and dp holds dS, both exactly 0
// for a pair that is not kept.
template <int NJ, bool QROWS>
__device__ __forceinline__ void grads(const Args& a, float (&s)[NJ][4], float (&dp)[NJ][4],
                                      const float (&lse_r)[2], const float (&di_r)[2],
                                      const float* lse_c, const float* di_c, int r0, int c0, int g,
                                      int t, bool full)
{
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int r = r0 + g + 8 * hh, cc = 8 * j + 2 * t + e, c = c0 + cc;
                float cg;
                const float sv = score2(a, s[j][2 * hh + e], cg);
                const float lse = QROWS ? lse_r[hh] : lse_c[cc];
                const float di = QROWS ? di_r[hh] : di_c[cc];
                const bool keep = full || (QROWS ? kept(a, r, c) : kept(a, c, r));
                const float p = keep ? exp2f(sv - lse) : 0.f;
                s[j][2 * hh + e] = p;
                dp[j][2 * hh + e] = p * (dp[j][2 * hh + e] - di) * cg * a.scale;
            }
}

// ---------------------------------------------------------------------------
// dq: grid ceil(S / ROWS) x B x H blocks, last query tiles first.  Warp w
// owns rows 16 (w % (8 / SPLIT)) .. + 15 of the block and columns DW (w /
// (8 / SPLIT)) .. + DW - 1 of dQ.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq(const Args a)
{
    constexpr int SPLIT = Tune<D>::Q_SPLIT, TILE = Tune<D>::Q_TILE;
    using LY = QL<D>;
    constexpr int ROWS = LY::ROWS, DW = LY::DW, NJ = LY::NJ, NT = DW / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* Qs = reinterpret_cast<float*>(smem_raw);
    float* dOs = Qs + LY::res;
    float* ring = dOs + LY::res;
    float* xch = ring + STAGES * LY::stage;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int rg = warp % (WARPS / SPLIT), d0 = (warp / (WARPS / SPLIT)) * DW;
    const int per = a.B * a.H, nqt = (a.S + ROWS - 1) / ROWS;
    const int qt = nqt - 1 - (int)(blockIdx.x / per);
    const int b = (int)(blockIdx.x % per) / a.H, h = (int)(blockIdx.x % per) % a.H;
    const int kvh = h / (a.H / a.KV);
    const int i0 = qt * ROWS, wr0 = i0 + 16 * rg;
    const long long qs = (long long)a.H * D, ks = (long long)a.KV * D;
    const long long qoff = ((long long)b * a.S + i0) * qs + (long long)h * D;
    const int valid = min(ROWS, a.S - i0);
    load_tile<D>(Qs, a.q + qoff, qs, ROWS, valid);
    load_tile<D>(dOs, a.dout + qoff, qs, ROWS, valid);
    // the live key tiles of rows i0 .. i0 + valid - 1
    const int nkt = (a.T + TILE - 1) / TILE;
    const int kt_end = a.causal ? min(nkt, (i0 + valid - 1) / TILE + 1) : nkt;
    int kt_begin = 0;
    if (a.window > 0) {
        const int first = i0 - a.window + 1;     // oldest kept key of the oldest row
        if (first > 0) kt_begin = first / TILE;
    }
    const int n = kt_end - kt_begin;
    const float* kb = a.k + (long long)b * a.T * ks + (long long)kvh * D;
    const float* vb = a.v + (long long)b * a.T * ks + (long long)kvh * D;
    auto load_kv = [&](int st, int kt, bool with_v) {
        const int k0 = kt * TILE;
        float* dst = ring + st * LY::stage;
        load_tile<D>(dst, kb + k0 * ks, ks, TILE, a.T - k0);
        if (with_v) load_tile<D>(dst + LY::tile, vb + k0 * ks, ks, TILE, a.T - k0);
    };
    if (n > 0) load_kv(0, kt_begin, false);
    cp_async_commit();

    // D of the warp's rows g, g + 8: lane t sums chunks t, t + 4, ... of the
    // row, then the quad sums its four shares
    float di[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int r = wr0 + g + 8 * hh;
        float acc = 0.f;
        if (r < a.S) {
            const long long off = ((long long)b * a.S + r) * qs + (long long)h * D;
#pragma unroll 4
            for (int c = t; c < D / 4; c += 4) {
                const float4 x = __ldg(reinterpret_cast<const float4*>(a.o + off) + c);
                const float4 y = __ldg(reinterpret_cast<const float4*>(a.dout + off) + c);
                acc = fmaf(x.x, y.x, acc);
                acc = fmaf(x.y, y.y, acc);
                acc = fmaf(x.z, y.z, acc);
                acc = fmaf(x.w, y.w, acc);
            }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        di[hh] = acc;
    }
    const float* Qw = Qs + 16 * rg * D;
    const float* dOw = dOs + 16 * rg * D;

    // pass 1: each row's max and sum of exp2 over its kept keys
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int it = 0; it < n; ++it) {
        const int st = it & 1, k0 = (kt_begin + it) * TILE;
        cp_async_wait<0>();
        __syncthreads();          // tile it landed; every warp is done with the other stage
        if (it + 1 < n) load_kv(st ^ 1, kt_begin + it + 1, false);
        cp_async_commit();
        if (!any_kept(a, wr0, 16, k0, TILE)) continue;
        float s[NJ][4];
        scores<D, DW, NJ>(Qw, ring + st * LY::stage, d0, g, t, s);
        if constexpr (SPLIT > 1) exchange<NJ, SPLIT, false>(s, s, xch, warp, rg, lane);
        row_stats<NJ>(a, s, m, l, wr0, k0, g, t, all_kept(a, wr0, 16, k0, TILE));
    }
    float lse[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float lt = l[hh];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        lse[hh] = lt > 0.f ? m[hh] + log2f(lt) : -INFINITY;
    }

    // pass 2: S, dP, P, dS, and dQ += dS K
    __syncthreads();              // every warp is done with pass 1's stages
    if (n > 0) load_kv(0, kt_begin, true);
    cp_async_commit();
    float acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    for (int it = 0; it < n; ++it) {
        const int st = it & 1, k0 = (kt_begin + it) * TILE;
        cp_async_wait<0>();
        __syncthreads();
        if (it + 1 < n) load_kv(st ^ 1, kt_begin + it + 1, true);
        cp_async_commit();
        if (!any_kept(a, wr0, 16, k0, TILE)) continue;
        const float* Kt = ring + st * LY::stage;
        float s[NJ][4], dp[NJ][4];
        scores<D, DW, NJ>(Qw, Kt, d0, g, t, s);
        scores<D, DW, NJ>(dOw, Kt + LY::tile, d0, g, t, dp);
        if constexpr (SPLIT > 1) exchange<NJ, SPLIT, true>(s, dp, xch, warp, rg, lane);
        grads<NJ, true>(a, s, dp, lse, di, nullptr, nullptr, wr0, k0, g, t,
                        all_kept(a, wr0, 16, k0, TILE));
        accumulate<D, DW, NJ>(Kt, d0, g, t, dp, acc);
    }
    cp_async_wait<0>();
    store_rows<NT>(a.dq + ((long long)b * a.S + wr0) * qs + (long long)h * D + d0, qs,
                   a.S - wr0, g, t, acc);
    if (d0 == 0 && t == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = wr0 + g + 8 * hh;
            if (r >= a.Sp) continue;
            const long long row = ((long long)b * a.H + h) * a.Sp + r;
            a.lse[row] = r < a.S ? lse[hh] : 0.f;
            a.dsum[row] = r < a.S ? di[hh] : 0.f;
        }
    }
}

// ---------------------------------------------------------------------------
// dkv: grid ceil(T / ROWS) x B x KV x n_split blocks, first key blocks (the
// longest causal walks) first.  Warp w owns keys 16 (w % (8 / SPLIT)) .. +
// 15 of the block and columns DW (w / (8 / SPLIT)) .. + DW - 1 of dK, dV.
// Split sp walks items [items sp / n_split, items (sp + 1) / n_split) of
// the block's (query head, live query tile) pairs, head-major.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv(const Args a)
{
    constexpr int SPLIT = Tune<D>::KV_SPLIT, TILE = Tune<D>::KV_TILE;
    using LY = KL<D>;
    constexpr int ROWS = LY::ROWS, DW = LY::DW, NJ = LY::NJ, NT = DW / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* Ks = reinterpret_cast<float*>(smem_raw);
    float* Vs = Ks + LY::res;
    float* ring = Vs + LY::res;
    float* xch = ring + STAGES * LY::stage;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int rg = warp % (WARPS / SPLIT), d0 = (warp / (WARPS / SPLIT)) * DW;
    const int per = a.B * a.KV * a.n_split;
    const int kblk = (int)(blockIdx.x / per), rem = (int)(blockIdx.x % per);
    const int b = rem / (a.KV * a.n_split), gkv = (rem / a.n_split) % a.KV, sp = rem % a.n_split;
    const int rep = a.H / a.KV;
    const int j0 = kblk * ROWS, wk0 = j0 + 16 * rg;
    const long long qs = (long long)a.H * D, ks = (long long)a.KV * D;
    const long long koff = ((long long)b * a.T + j0) * ks + (long long)gkv * D;
    const int kvalid = min(ROWS, a.T - j0);
    load_tile<D>(Ks, a.k + koff, ks, ROWS, kvalid);
    load_tile<D>(Vs, a.v + koff, ks, ROWS, kvalid);
    // the live query tiles of keys j0 .. j0 + kvalid - 1, and this split's items
    const int nqt = (a.S + TILE - 1) / TILE;
    const int qt_begin = a.causal ? min(nqt, j0 / TILE) : 0;
    const int qt_end = a.window > 0 ? min(nqt, (j0 + kvalid - 1 + a.window - 1) / TILE + 1) : nqt;
    const int nq = max(0, qt_end - qt_begin);
    const long long items = (long long)rep * nq;
    const int it0 = (int)(items * sp / a.n_split), it1 = (int)(items * (sp + 1) / a.n_split);
    auto load_q = [&](int st, int idx) {
        const int h = gkv * rep + idx / nq, i0 = (qt_begin + idx % nq) * TILE;
        float* dst = ring + st * LY::stage;
        const long long qoff = ((long long)b * a.S + i0) * qs + (long long)h * D;
        load_tile<D>(dst, a.q + qoff, qs, TILE, a.S - i0);
        load_tile<D>(dst + LY::tile, a.dout + qoff, qs, TILE, a.S - i0);
        if (tid < TILE / 2) {     // lse, then D: rows i0 .. i0 + TILE - 1 < Sp
            const int which = tid / (TILE / 4), c = tid % (TILE / 4);
            const float* src = (which ? a.dsum : a.lse) + ((long long)b * a.H + h) * a.Sp + i0 + 4 * c;
            cp_async16(dst + 2 * LY::tile + which * TILE + 4 * c, src, true);
        }
    };
    if (it0 < it1) load_q(0, it0);
    cp_async_commit();

    float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;
    const float* Kw = Ks + 16 * rg * D;
    const float* Vw = Vs + 16 * rg * D;
    const float none[2] = {0.f, 0.f};
    for (int idx = it0; idx < it1; ++idx) {
        const int st = (idx - it0) & 1, i0 = (qt_begin + idx % nq) * TILE;
        cp_async_wait<0>();
        __syncthreads();          // item idx landed; every warp is done with the other stage
        if (idx + 1 < it1) load_q(st ^ 1, idx + 1);
        cp_async_commit();
        if (!any_kept(a, i0, TILE, wk0, 16)) continue;
        const float* Qt = ring + st * LY::stage;
        const float* dOt = Qt + LY::tile;
        float s[NJ][4], dp[NJ][4];
        scores<D, DW, NJ>(Kw, Qt, d0, g, t, s);
        scores<D, DW, NJ>(Vw, dOt, d0, g, t, dp);
        if constexpr (SPLIT > 1) exchange<NJ, SPLIT, true>(s, dp, xch, warp, rg, lane);
        grads<NJ, false>(a, s, dp, none, none, dOt + LY::tile, dOt + LY::tile + TILE, wk0, i0, g,
                         t, all_kept(a, i0, TILE, wk0, 16));
        accumulate<D, DW, NJ>(dOt, d0, g, t, s, acc_v);
        accumulate<D, DW, NJ>(Qt, d0, g, t, dp, acc_k);
    }
    cp_async_wait<0>();
    const long long total = (long long)a.B * a.T * ks;
    float* dk = a.n_split > 1 ? a.part + sp * total : a.dk;
    float* dv = a.n_split > 1 ? a.part + (a.n_split + sp) * total : a.dv;
    const long long off = ((long long)b * a.T + wk0) * ks + (long long)gkv * D + d0;
    store_rows<NT>(dk + off, ks, a.T - wk0, g, t, acc_k);
    store_rows<NT>(dv + off, ks, a.T - wk0, g, t, acc_v);
}

// dK, dV = the sum of the splits' slices of part ([2][n_split][n4 float4]),
// in split order.
__global__ void __launch_bounds__(256) flash_bwd_reduce(const float4* __restrict__ part,
                                                        float4* __restrict__ dk,
                                                        float4* __restrict__ dv, long long n4,
                                                        int n_split)
{
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < 2 * n4;
         i += (long long)gridDim.x * blockDim.x) {
        const int which = i >= n4;
        const long long e = i - which * n4;
        const float4* p = part + which * n_split * n4 + e;
        float4 acc = p[0];
        for (int s = 1; s < n_split; ++s) {
            const float4 x = p[s * n4];
            acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
        }
        (which ? dv : dk)[e] = acc;
    }
}

// The ranges each dK/dV key block's walk is cut into: 1 where the blocks
// fill the SMs; else the count up to MAX_SPLIT (and the block's most items)
// whose grid takes the fewest waves per split, the smallest on a tie.
template <int D>
int n_split_of(int B, int S, int T, int H, int KV, int sms)
{
    const long long base = (long long)((T + KL<D>::ROWS - 1) / KL<D>::ROWS) * KV * B;
    if (base >= sms) return 1;
    const long long items = (long long)(H / KV) * ((S + Tune<D>::KV_TILE - 1) / Tune<D>::KV_TILE);
    int best = 1;
    long long best_waves = 1;
    for (int s = 2; s <= MAX_SPLIT && s <= items; ++s) {
        const long long waves = (base * s + sms - 1) / sms;
        if (waves * best < best_waves * s) {
            best = s;
            best_waves = waves;
        }
    }
    return best;
}

template <int D>
int launch(const Args& a, int sms, cudaStream_t stream)
{
    if (a.n_split != n_split_of<D>(a.B, a.S, a.T, a.H, a.KV, sms)) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)QL<D>::bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)KL<D>::bytes);
    if (err != cudaSuccess) return (int)err;
    const long long qblocks = (long long)((a.S + QL<D>::ROWS - 1) / QL<D>::ROWS) * a.B * a.H;
    const long long kblocks = (long long)((a.T + KL<D>::ROWS - 1) / KL<D>::ROWS) * a.B * a.KV * a.n_split;
    if (qblocks > 0x7fffffffLL || kblocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    flash_bwd_dq<D><<<(unsigned)qblocks, THREADS, QL<D>::bytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv<D><<<(unsigned)kblocks, THREADS, KL<D>::bytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess || a.n_split == 1) return (int)err;
    const long long n4 = (long long)a.B * a.T * a.KV * D / 4;
    const long long blocks = (2 * n4 + 255) / 256 < 8LL * sms ? (2 * n4 + 255) / 256 : 8LL * sms;
    flash_bwd_reduce<<<(unsigned)blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(a.part),
                                                           reinterpret_cast<float4*>(a.dk),
                                                           reinterpret_cast<float4*>(a.dv), n4,
                                                           a.n_split);
    return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block of the dq (which = 0) or dkv (which =
// 1) kernel at head dim D; 0 for a D it does not take.
extern "C" long long flash_attention_bwd_smem_bytes(int D, int which)
{
    switch (D) {
        case 64: return (long long)(which ? KL<64>::bytes : QL<64>::bytes);
        case 128: return (long long)(which ? KL<128>::bytes : QL<128>::bytes);
        case 256: return (long long)(which ? KL<256>::bytes : QL<256>::bytes);
        default: return 0;
    }
}

// The n_split the entry point takes for this shape on a card of `sms` SMs
// (0 for a D it does not take).
extern "C" int flash_attention_bwd_n_split(int B, int S, int T, int H, int KV, int D, int sms)
{
    if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || sms <= 0) return 0;
    switch (D) {
        case 64: return n_split_of<64>(B, S, T, H, KV, sms);
        case 128: return n_split_of<128>(B, S, T, H, KV, sms);
        case 256: return n_split_of<256>(B, S, T, H, KV, sms);
        default: return 0;
    }
}

// q, o, dout, dq [B, S, H, D]; k, v, dk, dv [B, T, KV, D]; lse, dsum [B, H,
// Sp] scratch with Sp = S rounded up to 64; part [2, n_split, B, T, KV, D]
// scratch (unused at n_split = 1); all contiguous float32, 16-byte aligned.
// n_split must be flash_attention_bwd_n_split(B, S, T, H, KV, D, sms).  T !=
// S (cross mode) only with causal = 0 and window <= 0; window <= 0: no
// window; softcap <= 0: no softcap.  Launches the dq kernel, the dkv kernel
// and, at n_split > 1, the reduce kernel, on `stream`.  Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o, const float* dout,
    float* dq, float* dk, float* dv, float* lse, float* dsum, float* part,
    int B, int S, int T, int H, int KV, int D, int causal, int window, float softcap,
    float sqrt_d, int sms, int n_split, void* stream)
{
    if (B <= 0 || S <= 0 || T <= 0 || H <= 0) return (int)cudaSuccess;
    if (KV <= 0 || H % KV != 0 || sms <= 0 || n_split < 1) return (int)cudaErrorInvalidValue;
    if (T != S && (causal || window > 0)) return (int)cudaErrorInvalidValue;
    const int Sp = (S + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
    Args a{q, k, v, o, dout, dq, dk, dv, lse, dsum, part, B, S, T, H, KV, Sp, causal, window,
           n_split, softcap, 1.f / sqrt_d};
    cudaStream_t st = (cudaStream_t)stream;
    switch (D) {
        case 64: return launch<64>(a, sms, st);
        case 128: return launch<128>(a, sms, st);
        case 256: return launch<256>(a, sms, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
