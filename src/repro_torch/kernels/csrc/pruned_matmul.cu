// Block-skip masked matmul for Hopper (sm_90a): plain FP32 FFMA in float32,
// bf16 mma.sync tensor-core products in bf16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pruned_matmul.py
// (_kernel / _call, and _pm_bwd, which re-orients the same kernel for dX
// and dW).  For every row b of a batch of B independent products:
//
//   y[b] = ((x[b] * in_mask[b][None, :]) @ w[b]) * out_mask[b][None, :]
//                                                * row_mask[b][:, None]
//
// x [B, M, K], w [B, K, N] are read through explicit element strides, so a
// transposed operand (the backward pass) is a stride swap and an operand
// shared by all rows has batch stride 0.  Masks are [B, len] with unit
// stride along len (batch stride 0 when shared).  y [B, M, N] is contiguous.
//
// Skipping follows the TPU kernel's compute_blocks (bm, bn, bk): an output
// tile whose enclosing M block (row_mask) or N block (out_mask) holds no
// surviving unit writes zeros; the K loop walks only the live bk-blocks, from
// a compacted per-row list the wrapper builds on the device
// (k_live[b, 0:k_count[b]], ascending).  Ragged M/K/N edges are
// bounds-checked here; nothing is padded in device memory.
//
// What bounds it on an H100.  Plain FP32 FFMA (67 TFLOP/s) at VGG16 widths,
// and inside the SM the shared-memory reads: an 8x8 register tile reads 64
// bytes of shared memory per 64 FFMAs per thread, so the LSU and the FP32
// pipes are equally loaded and a 128-register block is latency-bound on its
// own (two resident blocks per SM roughly double its rate).  Before this
// design the largest loss was elsewhere: the thin, deep products
// (conv0/conv1 dW: a 27x64 or 576x64 output per worker against 32 768
// contraction rows) had 10-50 output tiles for 132 SMs.  The design:
//
// * Split-K.  The grid is (output tiles, S slices, B).  Slice s of row b
//   walks live K blocks [s * n / S, (s + 1) * n / S) of that row's list,
//   n = k_count[b], so the split follows the live blocks on the device while
//   S itself is chosen on the host from shapes alone (pruned_matmul.py,
//   split_factor: the fewest slices within 10 % of the best modelled
//   makespan).  With S > 1 each slice writes its raw partial tile to an
//   fp32 workspace [S, B, M, N]; a second kernel sums the slices in fixed
//   order s = 0..S-1, applies out_mask * row_mask and writes zeros for dead
//   tiles.  No atomics: two runs give bit-identical outputs.
// * 128x128 output tiles, 256 threads, an 8x8 register tile per thread
//   (rows ty*4 + 64 g + i, cols tx*4 + 64 h + j): per k, four float4 shared
//   reads feed 64 FFMAs.  Where a block size of this orientation is not a
//   multiple of 128 (or the extent is at most 64) that side of the tile is
//   64 wide, so a tile always lies inside one block of each dimension and
//   the skip flags are never read at a finer grain than the blocks.
// * Every aligned operand arrives by 16-byte cp.async, DIST = 3 K steps
//   (16 deep) ahead of the FFMAs, one barrier per step.  An operand whose
//   tile rows are the unit stride (w in forward and dW, x^T in dW) lands in
//   a ring of [k][r] tiles as the FFMAs read it.  An operand with k as the
//   unit stride (x in forward and dX, w^T in dX) lands row-major in a
//   [r][k] staging ring; after the barrier the block transposes the next
//   step into a double-buffered [k][r] tile (float4 reads and scalar stores
//   free of bank conflicts), so no load waits in registers across the
//   FFMAs.  in_mask multiplies A once per landed stage, never per FFMA:
//   during the transpose (the step's 16 mask values staged beside it by
//   cp.async), or, for a row-fast A, by each thread on the chunks it
//   copied, after its own wait and before the barrier.
// * One template instance per operand layout, fixed at compile time:
//   forward (A k-fast, B n-fast), dX (A k-fast, B = w^T k-fast), dW
//   (A = x^T m-fast, B n-fast), and a generic-stride instance (scalar loads
//   through registers) for any other strides, unaligned pointers or a fast
//   extent that is not a multiple of 4 (conv0's K = 27).  The wrapper picks
//   the instance from strides and alignment.  Shared memory is 65-95 KB for
//   the 128x128 vector instances, so the host opts in with
//   cudaFuncSetAttribute; two blocks fit on an SM (the generic instance is
//   built for one).
//
// Still FP32 FFMA: the parity bar is IEEE f32 (1e-4), which TF32 cannot meet
// at K = 4 608.  wgmma/TMA tiles and a 3xTF32 mode are later work.
//
// bf16 mode (the Pallas kernel's bf16 x and w: pruned_matmul.py:84-98, 161;
// _pm_bwd casts the cotangent to x's dtype and runs dX and dW in it).  x and
// w are bf16, the masks float32.  The product of two bf16 values is exact in
// float32, so bf16 tensor-core products with float32 accumulation compute
// what the Pallas kernel computes (upcast at load, float32 dot); only the
// order of the sums differs.  The split-K workspace and its reduce stay
// float32, y is rounded to bf16 once, at its store (as the Pallas _finish
// casts the float32 accumulator), and pruned units stay exact zeros.  The
// grid, the 64/128-wide tiles, the live-K lists, the split rule, the dead
// tiles and the fixed-order reduce are the float32 mode's.
//
// What bounds the bf16 mode on an H100: at VGG16 widths the bytes (bf16
// operands read once over 3.35 TB/s take about twice the time of the
// executed FLOPs at the dense bf16 rate, 989 TFLOP/s), so the design has to
// keep HBM busy and the tensor cores fed, and mma.sync's rate suffices in
// principle.  In practice the main loop is bound inside the SM: at 64 x 32
// warp tiles each m16n8k16 takes 3/8 of an ldmatrix.x4 (1.5 shared-memory
// wavefronts), and with the cp.async writes of the tiles the shared-memory
// port is about as busy as the tensor cores (a 4096^3 product runs at about
// a third of cuBLAS's wgmma rate on the card).  The design:
//
// * Products: mma.sync.m16n8k16 bf16 x bf16 -> f32.  8 warps as 2 x 4, each
//   warp (TM/2) x (TN/4) outputs (64 x 32 at 128x128: 4 x 4 mma tiles, 64
//   float32 accumulators a thread), 128 registers, two blocks an SM.
// * Operands land in their natural major by 16-byte cp.async (8 elements)
//   into a ring: an operand whose contraction is the unit stride (x in
//   forward and dX, w^T in dX) as [r][k] tiles, read by ldmatrix; one whose
//   rows are the unit stride (w in forward and dW, x^T in dW) as [k][r]
//   tiles, read by ldmatrix.trans.  No transposing pass.  Rows are padded by
//   16 bytes, so ldmatrix's eight 16-byte rows hit distinct banks.  Steps
//   are 64 deep (a k-fast row lands as one 128-byte line) in a ring of 3
//   (32 KB of operands a stage at 128x128, two blocks an SM); a copy lands a
//   step before its products.  (Measured on the card against 32-deep
//   steps, 4- and 5-stage rings, one block an SM, 4 warps of 64 x 64, the
//   copies issued after the first k16 products and the live-K offsets read
//   a step early: each as fast or slower.)
// * in_mask multiplies A once per landed stage, never per mma: its values
//   land beside the stage by cp.async, and after the barrier that makes
//   step + 1 visible each thread scales the chunks it copied (a bf16 times 0
//   or 1 is exact); the next barrier orders that before step + 1's products.
// * One compute loop for every bf16 instance.  The generic instance (conv0's
//   K = 27, an unaligned pointer, an odd stride) lands its tiles by scalar
//   loads through registers into the same [r][k] tiles (in_mask applied
//   there; 32-deep steps, one block an SM), so instances differ only in how
//   a tile lands.
// * The output tile passes through shared memory (the ring's space) and
//   leaves in 16-byte row chunks: the products with a short contraction
//   (conv0/conv1 at K = 27 / 64 in dX) are bound by their output bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;     // 16 x 16 threads
constexpr int TK = 16;           // K step
constexpr int DIST = 3;          // cp.async issue distance, in K steps
constexpr int PAD = 4;           // [k][r] row pad: 16-byte rows, conflict-free stores
constexpr int LDK = TK + PAD;    // [r][k] staging row stride: conflict-free float4 reads

// operand layouts (the wrapper's LAYOUTS, pruned_matmul.py)
enum { L_GENERIC = 0, L_FWD = 1, L_DX = 2, L_DW = 3 };
// how one operand tile reaches the [k][r] buffer the FFMAs read:
//   K_GEN    scalar loads through registers, any strides
//   K_TRANS  k is the unit stride: 16-byte cp.async into a [r][k] staging
//            ring, then the block transposes it (and applies in_mask)
//   K_NATIVE r is the unit stride: 16-byte cp.async straight into a [k][r] ring
enum { K_GEN = 0, K_TRANS = 1, K_NATIVE = 2 };

// A and B kinds, and the resident blocks per SM each instance is built for
// (the generic instance's 64-bit stride arithmetic does not fit 128
// registers at 128x128).  in_mask always rides on A.
template <int L> struct Kinds;
template <> struct Kinds<L_GENERIC> {
    static constexpr int A = K_GEN, B = K_GEN, min_blocks = 1; };
template <> struct Kinds<L_FWD> {
    static constexpr int A = K_TRANS, B = K_NATIVE, min_blocks = 2; };
template <> struct Kinds<L_DX> {
    static constexpr int A = K_TRANS, B = K_TRANS, min_blocks = 2; };
template <> struct Kinds<L_DW> {
    static constexpr int A = K_NATIVE, B = K_NATIVE, min_blocks = 2; };

typedef __nv_bfloat16 bf16;

// the rounding of a float32 result to the output's element type
template <typename E> __device__ __forceinline__ E from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
    return __float2bfloat16_rn(v);
}

// x, w and y hold the element type of the instance (float or bf16); the
// masks and the workspace are float32
struct Params {
    const void* x; long long sxb, sxm, sxk;
    const void* w; long long swb, swk, swn;
    const float* in_mask; long long sib;
    const float* out_mask; long long sob;
    const float* row_mask; long long srb;
    const int* m_keep; const int* n_keep; const int* k_live; const int* k_count;
    void* y; float* ws;
    int B, M, N, K, bm, bn, bk, nMb, nNb, nKb, split;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? 16 : 0;     // src-size 0: zero-fill, nothing read
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One operand: tiles of R rows (M for A, N for B) by TK k.  The FFMAs read
// it as T[k][r] (row stride R + PAD).  The operand is read from global as
// g[r * sr + k * sk]; MASKED multiplies by mask[k] (in_mask).  Step `step`
// of the K walk lives in slot step % RING (K_NATIVE) or step % 2 (the other
// kinds' compute buffers; K_TRANS also has a staging ring of DIST slots, and,
// when MASKED, a ring of the steps' 16 in_mask values beside it).
template <int KIND, int R, bool MASKED>
struct Operand {
    static constexpr int LD = R + PAD;
    static constexpr int TILE = TK * LD;               // one [k][r] tile, floats
    static constexpr int RING = DIST + 1;              // K_NATIVE slots
    static constexpr int STAGE = R * LDK;              // one [r][k] staging tile
    static constexpr int NV = R * TK / 4 / THREADS;    // 16-byte chunks per thread
    static constexpr int NS = R * TK / THREADS;        // scalars per thread (K_GEN)
    static constexpr int MASKS = 2 * TILE + DIST * STAGE;   // K_TRANS mask ring offset
    static constexpr int FLOATS = KIND == K_NATIVE ? RING * TILE
                                : KIND == K_TRANS ? MASKS + (MASKED ? DIST * TK : 0) : 2 * TILE;
    static constexpr int NREG = KIND == K_GEN ? NS : 1;
    static constexpr int NMASK = !MASKED ? 1 : KIND == K_GEN ? NS : KIND == K_NATIVE ? NV : 1;

    const float* g;
    long long sr, sk;
    const float* mask;
    int r0, rext, K, t;
    bool rfast;          // K_GEN: consecutive threads walk r (else k)
    float v[NREG];
    float mv[NMASK];

    __device__ Operand(const float* g_, long long sr_, long long sk_, const float* mask_,
                       int r0_, int rext_, int K_, int t_)
        : g(g_), sr(sr_), sk(sk_), mask(mask_), r0(r0_), rext(rext_), K(K_), t(t_),
          rfast(sr_ == 1 && sk_ != 1) {}

    // the [k][r] tile of `step`
    __device__ __forceinline__ const float* tile(const float* base, int step) const {
        return base + (KIND == K_NATIVE ? step % RING : step % 2) * TILE;
    }

    // K_NATIVE copies: consecutive threads take consecutive 16 bytes along r
    __device__ __forceinline__ void nat_coord(int c, int& rr, int& kk) const {
        const int idx = c * THREADS + t;
        kk = idx / (R / 4);
        rr = (idx % (R / 4)) * 4;
    }
    // K_TRANS copies: four threads read one row's 64 bytes
    __device__ __forceinline__ void stg_coord(int c, int& rr, int& kk) const {
        const int idx = c * THREADS + t;
        rr = idx / 4;
        kk = (idx % 4) * 4;
    }
    // K_TRANS transpose: a warp takes 16 rows x 2 float4 of k, so its staging
    // reads and its [k][r] stores are free of bank conflicts
    __device__ __forceinline__ void tr_coord(int c, int& rr, int& kk) const {
        const int idx = c * THREADS + t, q = idx >> 5, lane = idx & 31;
        rr = (q % (R / 16)) * 16 + (lane & 15);
        kk = ((q / (R / 16)) * 2 + (lane >> 4)) * 4;
    }
    __device__ __forceinline__ void gen_coord(int c, int& rr, int& kk) const {
        const int idx = c * THREADS + t;
        if (rfast) { rr = idx % R; kk = idx / R; }
        else       { kk = idx % TK; rr = idx / TK; }
    }

    // cp.async of step `step` (K_NATIVE / K_TRANS; r0 + rr < rext, k < K,
    // 16-byte alignment and K % 4 == 0 are the wrapper's layout checks)
    __device__ __forceinline__ void issue(float* base, int step, int k0) const {
        if constexpr (KIND == K_NATIVE) {
            float* T = base + (step % RING) * TILE;
#pragma unroll
            for (int c = 0; c < NV; ++c) {
                int rr, kk;
                nat_coord(c, rr, kk);
                const int r = r0 + rr, k = k0 + kk;
                const bool ok = r < rext && k < K;
                cp_async16(T + kk * LD + rr, ok ? g + r + (long long)k * sk : g, ok);
            }
        } else if constexpr (KIND == K_TRANS) {
            float* S = base + 2 * TILE + (step % DIST) * STAGE;
#pragma unroll
            for (int c = 0; c < NV; ++c) {
                int rr, kk;
                stg_coord(c, rr, kk);
                const int r = r0 + rr, k = k0 + kk;
                const bool ok = r < rext && k < K;
                cp_async16(S + rr * LDK + kk, ok ? g + (long long)r * sr + k : g, ok);
            }
            if constexpr (MASKED) {
                if (t < TK) {
                    const bool ok = k0 + t < K;
                    cp_async4(base + MASKS + (step % DIST) * TK + t, ok ? mask + k0 + t : mask, ok);
                }
            }
        }
    }
    // K_NATIVE + MASKED: the mask values this thread applies to step k0
    // (fetched a step early)
    __device__ __forceinline__ void mask_prefetch(int k0) {
        if constexpr (MASKED && KIND == K_NATIVE) {
#pragma unroll
            for (int c = 0; c < NV; ++c) {
                int rr, kk;
                nat_coord(c, rr, kk);
                mv[c] = k0 + kk < K ? __ldg(mask + k0 + kk) : 0.f;
            }
        }
    }
    // K_NATIVE + MASKED: once this thread's copies of `step` landed, scale them
    __device__ __forceinline__ void fixup(float* base, int step) const {
        if constexpr (MASKED && KIND == K_NATIVE) {
            float* T = base + (step % RING) * TILE;
#pragma unroll
            for (int c = 0; c < NV; ++c) {
                int rr, kk;
                nat_coord(c, rr, kk);
                float4* q = reinterpret_cast<float4*>(T + kk * LD + rr);
                float4 a = *q;
                a.x *= mv[c]; a.y *= mv[c]; a.z *= mv[c]; a.w *= mv[c];
                *q = a;
            }
        }
    }
    // K_TRANS: staging [r][k] of `step` (visible to the block) -> [k][r],
    // times the step's staged mask values
    __device__ __forceinline__ void transpose(float* base, int step) const {
        if constexpr (KIND == K_TRANS) {
            const float* S = base + 2 * TILE + (step % DIST) * STAGE;
            const float* Ms = base + MASKS + (step % DIST) * TK;
            float* T = base + (step % 2) * TILE;
#pragma unroll
            for (int c = 0; c < NV; ++c) {
                int rr, kk;
                tr_coord(c, rr, kk);
                const float4 a = *reinterpret_cast<const float4*>(S + rr * LDK + kk);
                const float e[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if constexpr (MASKED) T[(kk + j) * LD + rr] = e[j] * Ms[kk + j];
                    else T[(kk + j) * LD + rr] = e[j];
                }
            }
        }
    }
    // K_GEN: global -> registers before the FFMAs, registers -> [k][r] after
    __device__ __forceinline__ void reg_load(int k0) {
        if constexpr (KIND == K_GEN) {
#pragma unroll
            for (int c = 0; c < NS; ++c) {
                int rr, kk;
                gen_coord(c, rr, kk);
                const int r = r0 + rr, k = k0 + kk;
                const bool ok = r < rext && k < K;
                v[c] = ok ? __ldg(g + (long long)r * sr + (long long)k * sk) : 0.f;
                if constexpr (MASKED) mv[c] = ok ? __ldg(mask + k) : 0.f;
            }
        }
    }
    __device__ __forceinline__ void reg_store(float* base, int step) const {
        if constexpr (KIND == K_GEN) {
            float* T = base + (step % 2) * TILE;
#pragma unroll
            for (int c = 0; c < NS; ++c) {
                int rr, kk;
                gen_coord(c, rr, kk);
                if constexpr (MASKED) T[kk * LD + rr] = v[c] * mv[c];
                else T[kk * LD + rr] = v[c];
            }
        }
    }
};

template <int TM, int TN, int L>
struct Shape {
    using KD = Kinds<L>;
    using OA = Operand<KD::A, TM, true>;
    using OB = Operand<KD::B, TN, false>;
    static constexpr size_t bytes = (size_t)(OA::FLOATS + OB::FLOATS) * sizeof(float);
};

// the float32 instances: FFMA on [k][r] float32 tiles
template <int TM, int TN, int LAYOUT>
__global__ void __launch_bounds__(THREADS, Kinds<LAYOUT>::min_blocks)
pm_kernel(const Params p)
{
    using SH = Shape<TM, TN, LAYOUT>;
    using OA = typename SH::OA;
    using OB = typename SH::OB;
    constexpr int RM = TM / 16, RN = TN / 16;
    extern __shared__ __align__(16) float smem[];
    float* sa = smem;
    float* sb = smem + OA::FLOATS;

    const int tilesN = (p.N + TN - 1) / TN;
    const int m0 = (blockIdx.x / tilesN) * TM;
    const int n0 = (blockIdx.x % tilesN) * TN;
    const int s = blockIdx.y;
    const int b = blockIdx.z;
    const int t = threadIdx.x;
    const int tx = t % 16, ty = t / 16;
    const bool split = p.split > 1;
    const long long MN = (long long)p.M * p.N;
    const bool vec_out = (p.N % 4) == 0;

    const bool live = p.m_keep[(long long)b * p.nMb + m0 / p.bm] != 0 &&
                      p.n_keep[(long long)b * p.nNb + n0 / p.bn] != 0;
    if (!live) {
        if (split) return;          // the reduce pass writes this tile's zeros
        float* yb = static_cast<float*>(p.y) + (long long)b * MN;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int m = m0 + ty * 4 + 64 * (i / 4) + (i % 4);
            if (m >= p.M) continue;
#pragma unroll
            for (int j = 0; j < RN; ++j) {
                const int n = n0 + tx * 4 + 64 * (j / 4) + (j % 4);
                if (n < p.N) yb[(long long)m * p.N + n] = 0.0f;
            }
        }
        return;
    }

    // this slice's share of the row's live K blocks, in 16-deep steps
    const int nlive = p.k_count[b];
    const int l0 = (int)(((long long)s * nlive) / p.split);
    const int l1 = (int)(((long long)(s + 1) * nlive) / p.split);
    const int* klist = p.k_live + (long long)b * p.nKb;
    const int spb = p.bk / TK;
    int nsteps = (l1 - l0) * spb;
    if (l1 > l0 && klist[l1 - 1] == p.nKb - 1) {     // ragged last block: its real steps only
        const int tail = p.K - (p.nKb - 1) * p.bk;
        nsteps -= spb - (tail + TK - 1) / TK;
    }
    auto k_of = [&](int step) { return klist[l0 + step / spb] * p.bk + (step % spb) * TK; };

    const float* imb = p.in_mask + (long long)b * p.sib;
    OA la(static_cast<const float*>(p.x) + (long long)b * p.sxb, p.sxm, p.sxk, imb, m0, p.M, p.K, t);
    OB lb(static_cast<const float*>(p.w) + (long long)b * p.swb, p.swn, p.swk, nullptr, n0, p.N,
          p.K, t);

    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.0f;

    // prologue: copies of steps 0..DIST-1 in flight, step 0 made ready
#pragma unroll
    for (int st = 0; st < DIST; ++st) {
        if (st < nsteps) {
            const int k0 = k_of(st);
            la.issue(sa, st, k0);
            lb.issue(sb, st, k0);
        }
        cp_async_commit();
    }
    if (nsteps > 0) {
        const int k0 = k_of(0);
        la.mask_prefetch(k0);
        la.reg_load(k0);
        lb.reg_load(k0);
        cp_async_wait<DIST - 1>();
        la.fixup(sa, 0);
        la.reg_store(sa, 0);
        lb.reg_store(sb, 0);
        __syncthreads();
        la.transpose(sa, 0);
        lb.transpose(sb, 0);
        if (nsteps > 1) {
            const int k1 = k_of(1);
            la.mask_prefetch(k1);
        }
    }

    for (int step = 0; step < nsteps; ++step) {
        const bool more = step + 1 < nsteps;
        cp_async_wait<DIST - 2>();        // this thread's copies of step + 1 landed
        if (more) la.fixup(sa, step + 1);
        // step's tiles are complete and visible; step + 1's staging is visible;
        // every thread is done with step - 1's buffers
        __syncthreads();
        if (more) {
            la.transpose(sa, step + 1);
            lb.transpose(sb, step + 1);
        }
        const int pre = step + DIST;
        if (pre < nsteps) {
            const int k0 = k_of(pre);
            la.issue(sa, pre, k0);
            lb.issue(sb, pre, k0);
        }
        cp_async_commit();
        if (step + 2 < nsteps) {
            const int k2 = k_of(step + 2);
            la.mask_prefetch(k2);
        }
        if (more) {
            const int k1 = k_of(step + 1);
            la.reg_load(k1);
            lb.reg_load(k1);
        }

        const float* Ac = la.tile(sa, step);
        const float* Bc = lb.tile(sb, step);
#pragma unroll
        for (int kk = 0; kk < TK; ++kk) {
            float a[RM], c[RN];
#pragma unroll
            for (int g = 0; g < RM / 4; ++g) {
                const float4 v = *reinterpret_cast<const float4*>(Ac + kk * OA::LD + ty * 4 + 64 * g);
                a[4 * g + 0] = v.x; a[4 * g + 1] = v.y; a[4 * g + 2] = v.z; a[4 * g + 3] = v.w;
            }
#pragma unroll
            for (int h = 0; h < RN / 4; ++h) {
                const float4 v = *reinterpret_cast<const float4*>(Bc + kk * OB::LD + tx * 4 + 64 * h);
                c[4 * h + 0] = v.x; c[4 * h + 1] = v.y; c[4 * h + 2] = v.z; c[4 * h + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
        }

        if (more) {
            la.reg_store(sa, step + 1);
            lb.reg_store(sb, step + 1);
        }
    }
    cp_async_wait<0>();

    // epilogue: S == 1 writes y with out_mask * row_mask; S > 1 writes the
    // raw partial into workspace slice s
    float* part = split ? p.ws + ((long long)s * p.B + b) * MN : nullptr;
    float* yo = static_cast<float*>(p.y) + (long long)b * MN;
    const float* omb = p.out_mask + (long long)b * p.sob;
    const float* rmb = p.row_mask + (long long)b * p.srb;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        const int m = m0 + ty * 4 + 64 * (i / 4) + (i % 4);
        if (m >= p.M) continue;
        const float rm = split ? 1.0f : rmb[m];
#pragma unroll
        for (int h = 0; h < RN / 4; ++h) {
            const int n = n0 + tx * 4 + 64 * h;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                v[j] = acc[i][4 * h + j];
                if (!split && n + j < p.N) v[j] = v[j] * omb[n + j] * rm;
            }
            const long long off = (long long)m * p.N + n;
            float* dst = (split ? part : yo) + off;
            if (vec_out && n + 3 < p.N) {
                *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (n + j < p.N) dst[j] = v[j];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// the bf16 instances: mma.sync m16n8k16 on bf16 tiles, float32 accumulators
// ---------------------------------------------------------------------------

namespace tc {

constexpr int PAD = 8;          // row pad in elements (16 bytes): ldmatrix free of bank conflicts

// how one operand tile lands in its ring slot:
//   LAND_REG  scalar loads through registers (any strides), stored [r][k]
//   LAND_K    k is the unit stride: 16-byte cp.async into [r][k]
//   LAND_R    r is the unit stride: 16-byte cp.async into [k][r]
enum { LAND_REG = 0, LAND_K = 1, LAND_R = 2 };

// A and B landings of each layout, its K step TK (in 16-deep mma k-steps
// of two or four) and ring depth, and the resident blocks per SM each
// instance is built for.  A 64-deep step lands a k-fast operand in whole
// 128-byte lines; the register loads of the generic instance keep it at 32
// (more than 128 registers a thread already).  A copy lands STAGES - 2
// steps before its products.  in_mask always rides on A.
template <int L> struct Kinds;
template <> struct Kinds<L_GENERIC> {
    static constexpr int A = LAND_REG, B = LAND_REG, TK = 32, STAGES = 4, min_blocks = 1; };
template <> struct Kinds<L_FWD> {
    static constexpr int A = LAND_K, B = LAND_R, TK = 64, STAGES = 3, min_blocks = 2; };
template <> struct Kinds<L_DX> {
    static constexpr int A = LAND_K, B = LAND_K, TK = 64, STAGES = 3, min_blocks = 2; };
template <> struct Kinds<L_DW> {
    static constexpr int A = LAND_R, B = LAND_R, TK = 64, STAGES = 3, min_blocks = 2; };
constexpr int BK_GRAIN = 64;    // every K step divides the block sizes (check_blocks)

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
// c += a b: a rows (g, g+8) x k (2t, 2t+1, 2t+8, 2t+9), b k (2t, 2t+1, 2t+8,
// 2t+9) x column g, c rows (g, g+8) x columns (2t, 2t+1)
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two bf16 values times two float32 factors, rounded back to bf16 (exact
// for factors 0 and 1)
__device__ __forceinline__ unsigned scale2(unsigned v, float f0, float f1) {
    __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
    const float2 x = __bfloat1622float2(h);
    h = __floats2bfloat162_rn(x.x * f0, x.y * f1);
    return *reinterpret_cast<unsigned*>(&h);
}

// One operand: tiles of R rows (M for A, N for B) by TK k, in a ring of
// STAGES slots.  Read from global as g[r * sr + k * sk]; MASKED scales k by
// mask[k] (in_mask).  [r][k] tiles (LAND_REG, LAND_K) have row stride
// TK + PAD, [k][r] tiles (LAND_R) R + PAD.  With MASKED and a cp.async
// landing, a ring of the steps' TK mask values follows the tiles.
template <int KIND, int R, bool MASKED, int TK, int STAGES>
struct Operand {
    static constexpr bool KMAJ = KIND != LAND_R;
    static constexpr int LD = KMAJ ? TK + PAD : R + PAD;
    static constexpr int ELEMS = KMAJ ? R * LD : TK * LD;      // one slot
    static constexpr bool STAGED_MASK = MASKED && KIND != LAND_REG;
    static constexpr size_t BYTES = (size_t)STAGES * ELEMS * sizeof(bf16)
                                  + (STAGED_MASK ? (size_t)STAGES * TK * sizeof(float) : 0);
    static constexpr int NV = R * TK / 8 / THREADS;            // 16-byte chunks per thread
    static constexpr int NS = KIND == LAND_REG ? R * TK / THREADS : 1;   // scalars per thread
    static_assert(NV >= 1 && (R * TK) % (8 * THREADS) == 0, "whole chunks per thread");

    const bf16* g;
    long long sr, sk;
    const float* mask;
    int r0, rext, K, t;
    bool rfast;              // LAND_REG: consecutive threads walk r (else k)
    unsigned short v[NS];    // LAND_REG: the next step's elements (bf16 bits)
    float mv[MASKED && KIND == LAND_REG ? NS : 1];

    __device__ Operand(const bf16* g_, long long sr_, long long sk_, const float* mask_,
                       int r0_, int rext_, int K_, int t_)
        : g(g_), sr(sr_), sk(sk_), mask(mask_), r0(r0_), rext(rext_), K(K_), t(t_),
          rfast(sr_ == 1 && sk_ != 1) {}

    __device__ __forceinline__ bf16* slot(bf16* base, int step) const {
        return base + (step % STAGES) * ELEMS;
    }
    __device__ __forceinline__ float* mask_slot(bf16* base, int step) const {
        return reinterpret_cast<float*>(base + STAGES * ELEMS) + (step % STAGES) * TK;
    }
    // chunk c of this thread: [r][k] TK / 8 threads a row, [k][r]
    // consecutive threads along r
    __device__ __forceinline__ void chunk(int c, int& rr, int& kk) const {
        const int idx = c * THREADS + t;
        if constexpr (KMAJ) { rr = idx / (TK / 8); kk = (idx % (TK / 8)) * 8; }
        else                { kk = idx / (R / 8); rr = (idx % (R / 8)) * 8; }
    }
    __device__ __forceinline__ int offset(int rr, int kk) const {
        return KMAJ ? rr * LD + kk : kk * LD + rr;
    }

    // cp.async of step `step` at k0 (LAND_K / LAND_R; r0 + rr < rext, k < K,
    // 16-byte alignment and a fast extent that is a multiple of 8 are the
    // wrapper's layout checks), with its mask values when MASKED
    __device__ __forceinline__ void issue(bf16* base, int step, int k0) const {
        if constexpr (KIND != LAND_REG) {
            bf16* T = slot(base, step);
#pragma unroll
            for (int c = 0; c < NV; ++c) {
                int rr, kk;
                chunk(c, rr, kk);
                const int r = r0 + rr, k = k0 + kk;
                const bool ok = r < rext && k < K;
                const bf16* src = KMAJ ? g + (long long)r * sr + k : g + r + (long long)k * sk;
                cp_async16(T + offset(rr, kk), ok ? src : g, ok);
            }
            if constexpr (STAGED_MASK) {
                if (t < TK) {
                    const bool ok = k0 + t < K;
                    cp_async4(mask_slot(base, step) + t, ok ? mask + k0 + t : mask, ok);
                }
            }
        }
    }
    // once step's copies are visible to the block: scale this thread's
    // chunks of it by their mask values (a chunk all of whose values are 1
    // is left alone)
    __device__ __forceinline__ void apply_mask(bf16* base, int step) const {
        if constexpr (STAGED_MASK) {
            bf16* T = slot(base, step);
            const float* Ms = mask_slot(base, step);
#pragma unroll
            for (int c = 0; c < NV; ++c) {
                int rr, kk;
                chunk(c, rr, kk);
                uint4* q = reinterpret_cast<uint4*>(T + offset(rr, kk));
                if constexpr (KMAJ) {
                    const float4 m0 = *reinterpret_cast<const float4*>(Ms + kk);
                    const float4 m1 = *reinterpret_cast<const float4*>(Ms + kk + 4);
                    if (m0.x == 1.f && m0.y == 1.f && m0.z == 1.f && m0.w == 1.f &&
                        m1.x == 1.f && m1.y == 1.f && m1.z == 1.f && m1.w == 1.f) continue;
                    uint4 u = *q;
                    u.x = scale2(u.x, m0.x, m0.y); u.y = scale2(u.y, m0.z, m0.w);
                    u.z = scale2(u.z, m1.x, m1.y); u.w = scale2(u.w, m1.z, m1.w);
                    *q = u;
                } else {
                    const float m = Ms[kk];
                    if (m == 1.f) continue;
                    uint4 u = *q;
                    u.x = scale2(u.x, m, m); u.y = scale2(u.y, m, m);
                    u.z = scale2(u.z, m, m); u.w = scale2(u.w, m, m);
                    *q = u;
                }
            }
        }
    }
    // LAND_REG: global -> registers before the products, registers -> the
    // [r][k] slot after them (in_mask applied there)
    __device__ __forceinline__ void gen_coord(int c, int& rr, int& kk) const {
        const int idx = c * THREADS + t;
        if (rfast) { rr = idx % R; kk = idx / R; }
        else       { kk = idx % TK; rr = idx / TK; }
    }
    __device__ __forceinline__ void reg_load(int k0) {
        if constexpr (KIND == LAND_REG) {
            const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
#pragma unroll
            for (int c = 0; c < NS; ++c) {
                int rr, kk;
                gen_coord(c, rr, kk);
                const int r = r0 + rr, k = k0 + kk;
                const bool ok = r < rext && k < K;
                v[c] = ok ? __ldg(gs + (long long)r * sr + (long long)k * sk) : (unsigned short)0;
                if constexpr (MASKED) mv[c] = ok ? __ldg(mask + k) : 0.f;
            }
        }
    }
    __device__ __forceinline__ void reg_store(bf16* base, int step) const {
        if constexpr (KIND == LAND_REG) {
            unsigned short* T = reinterpret_cast<unsigned short*>(slot(base, step));
#pragma unroll
            for (int c = 0; c < NS; ++c) {
                int rr, kk;
                gen_coord(c, rr, kk);
                unsigned short e = v[c];
                if constexpr (MASKED) {
                    const bf16 s = __float2bfloat16_rn(
                        __bfloat162float(*reinterpret_cast<const bf16*>(&e)) * mv[c]);
                    e = *reinterpret_cast<const unsigned short*>(&s);
                }
                T[rr * LD + kk] = e;
            }
        }
    }

    // this lane's shared address for ldmatrix.x4 (transposed from a [k][r]
    // tile): the m16 x k16 A fragment at rows rb.., k ks.. (a_addr), or the
    // k16 x n8 B fragments of n-tiles rb.. and rb + 8.. (b_addr)
    __device__ __forceinline__ unsigned a_addr(const bf16* T, int rb, int ks, int lane) const {
        const int mi = lane >> 3, rw = lane & 7;
        return KMAJ ? smem_u32(T + (rb + rw + 8 * (mi & 1)) * LD + ks + 8 * (mi >> 1))
                    : smem_u32(T + (ks + rw + 8 * (mi >> 1)) * LD + rb + 8 * (mi & 1));
    }
    __device__ __forceinline__ unsigned b_addr(const bf16* T, int rb, int ks, int lane) const {
        const int mi = lane >> 3, rw = lane & 7;
        return KMAJ ? smem_u32(T + (rb + rw + 8 * (mi >> 1)) * LD + ks + 8 * (mi & 1))
                    : smem_u32(T + (ks + rw + 8 * (mi & 1)) * LD + rb + 8 * (mi >> 1));
    }
    __device__ __forceinline__ void ldsm(unsigned (&r)[4], unsigned addr) const {
        if constexpr (KMAJ) ldsm_x4(r, addr);
        else ldsm_x4_t(r, addr);
    }
};

// The ring, and after the K walk the output tile staged for coalesced
// stores: bf16 y, or the float32 partial of a split launch (rows padded by
// 16 or 32 bytes, so the fragments' writes are free of bank conflicts).
template <int TM, int TN, int L>
struct Shape {
    using KD = Kinds<L>;
    using OA = Operand<KD::A, TM, true, KD::TK, KD::STAGES>;
    using OB = Operand<KD::B, TN, false, KD::TK, KD::STAGES>;
    static constexpr int LDY = TN + 8;                     // staged row stride, elements
    static constexpr size_t ring = OA::BYTES + OB::BYTES;
    static constexpr size_t out = (size_t)TM * LDY * sizeof(float);
    static constexpr size_t bytes = ring > out ? ring : out;
};

}  // namespace tc

template <int TM, int TN, int LAYOUT>
__global__ void __launch_bounds__(THREADS, tc::Kinds<LAYOUT>::min_blocks)
pm_kernel_bf16(const Params p)
{
    using SH = tc::Shape<TM, TN, LAYOUT>;
    using OA = typename SH::OA;
    using OB = typename SH::OB;
    constexpr int TK = tc::Kinds<LAYOUT>::TK, STAGES = tc::Kinds<LAYOUT>::STAGES;
    constexpr int WM = TM / 2, WN = TN / 4;      // one warp's outputs: 2 x 4 warps
    constexpr int MT = WM / 16, NT = WN / 8;     // its m16 and n8 tiles
    static_assert(NT % 2 == 0, "B fragments come two n-tiles at a time");
    extern __shared__ __align__(16) unsigned char smem_tc[];
    bf16* sa = reinterpret_cast<bf16*>(smem_tc);
    bf16* sb = reinterpret_cast<bf16*>(smem_tc + OA::BYTES);

    const int tilesN = (p.N + TN - 1) / TN;
    const int m0 = (blockIdx.x / tilesN) * TM;
    const int n0 = (blockIdx.x % tilesN) * TN;
    const int s = blockIdx.y;
    const int b = blockIdx.z;
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const int g = lane >> 2, q = lane & 3;
    const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
    const bool split = p.split > 1;
    const long long MN = (long long)p.M * p.N;

    const bool live = p.m_keep[(long long)b * p.nMb + m0 / p.bm] != 0 &&
                      p.n_keep[(long long)b * p.nNb + n0 / p.bn] != 0;
    if (!live) {
        if (split) return;          // the reduce pass writes this tile's zeros
        bf16* yb = static_cast<bf16*>(p.y) + (long long)b * MN;
        for (int i = t; i < TM * TN; i += THREADS) {
            const int m = m0 + i / TN, n = n0 + i % TN;
            if (m < p.M && n < p.N) yb[(long long)m * p.N + n] = __float2bfloat16_rn(0.0f);
        }
        return;
    }

    // this slice's share of the row's live K blocks, in TK-deep steps
    const int nlive = p.k_count[b];
    const int l0 = (int)(((long long)s * nlive) / p.split);
    const int l1 = (int)(((long long)(s + 1) * nlive) / p.split);
    const int* klist = p.k_live + (long long)b * p.nKb;
    const int spb = p.bk / TK;
    int nsteps = (l1 - l0) * spb;
    if (l1 > l0 && klist[l1 - 1] == p.nKb - 1) {     // ragged last block: its real steps only
        const int tail = p.K - (p.nKb - 1) * p.bk;
        nsteps -= spb - (tail + TK - 1) / TK;
    }
    auto k_of = [&](int step) { return klist[l0 + step / spb] * p.bk + (step % spb) * TK; };

    const float* imb = p.in_mask + (long long)b * p.sib;
    OA la(static_cast<const bf16*>(p.x) + (long long)b * p.sxb, p.sxm, p.sxk, imb, m0, p.M, p.K, t);
    OB lb(static_cast<const bf16*>(p.w) + (long long)b * p.swb, p.swn, p.swk, nullptr, n0, p.N,
          p.K, t);

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

    // prologue: copies of steps 0..STAGES-2 in flight; step 0 landed, visible
    // and masked before the loop's first barrier
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nsteps) {
            const int k0 = k_of(st);
            la.issue(sa, st, k0);
            lb.issue(sb, st, k0);
        }
        cp_async_commit();
    }
    if (nsteps > 0) {
        const int k0 = k_of(0);
        la.reg_load(k0);
        lb.reg_load(k0);
        la.reg_store(sa, 0);
        lb.reg_store(sb, 0);
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (nsteps > 0) la.apply_mask(sa, 0);

    for (int step = 0; step < nsteps; ++step) {
        const bool more = step + 1 < nsteps;
        cp_async_wait<STAGES - 3>();      // this thread's copies of step + 1 landed
        // step is masked and visible, step + 1 landed and visible, every
        // warp is done with step - 1's slot
        __syncthreads();
        if (more) la.apply_mask(sa, step + 1);
        const int pre = step + STAGES - 1;
        if (pre < nsteps) {
            const int k0 = k_of(pre);
            la.issue(sa, pre, k0);
            lb.issue(sb, pre, k0);
        }
        cp_async_commit();
        if (more) {
            const int k1 = k_of(step + 1);
            la.reg_load(k1);
            lb.reg_load(k1);
        }

        const bf16* Ac = la.slot(sa, step);
        const bf16* Bc = lb.slot(sb, step);
#pragma unroll
        for (int ks = 0; ks < TK; ks += 16) {
            unsigned af[MT][4], bfr[NT / 2][4];
#pragma unroll
            for (int i = 0; i < MT; ++i) la.ldsm(af[i], la.a_addr(Ac, wm + 16 * i, ks, lane));
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) lb.ldsm(bfr[j], lb.b_addr(Bc, wn + 16 * j, ks, lane));
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NT / 2; ++j) {
                    tc::mma16(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
                    tc::mma16(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
                }
        }

        if (more) {
            la.reg_store(sa, step + 1);
            lb.reg_store(sb, step + 1);
        }
    }
    cp_async_wait<0>();
    __syncthreads();                      // every warp is done with the ring

    // epilogue: S == 1 writes y with out_mask * row_mask, rounded once to
    // bf16; S > 1 writes the raw float32 partial into workspace slice s.
    // The fragments go to a [TM][LDY] tile in shared memory, which leaves in
    // 16-byte row chunks.
    constexpr int LDY = SH::LDY;
    const float* omb = p.out_mask + (long long)b * p.sob;
    const float* rmb = p.row_mask + (long long)b * p.srb;
    bf16* ty = reinterpret_cast<bf16*>(smem_tc);
    float* tw = reinterpret_cast<float*>(smem_tc);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = wm + 16 * i + g + 8 * hh;
            const int m = m0 + r;
            const float rm = split || m >= p.M ? 1.0f : rmb[m];
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int c = wn + 8 * j + 2 * q;
                float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
                if (split) {
                    *reinterpret_cast<float2*>(tw + r * LDY + c) = make_float2(v0, v1);
                } else {
                    const int n = n0 + c;
                    v0 = n < p.N ? v0 * omb[n] * rm : 0.0f;
                    v1 = n + 1 < p.N ? v1 * omb[n + 1] * rm : 0.0f;
                    *reinterpret_cast<__nv_bfloat162*>(ty + r * LDY + c) = __floats2bfloat162_rn(v0, v1);
                }
            }
        }
    __syncthreads();
    constexpr int EY = 8, EW = 4;         // elements of a 16-byte chunk: bf16 y, float32 partial
    const int per = split ? EW : EY;
    const int chunks = TN / per;
    const bool vec = p.N % per == 0;      // every row's chunks are 16-byte aligned
    for (int idx = t; idx < TM * chunks; idx += THREADS) {
        const int r = idx / chunks, c = (idx % chunks) * per;
        const int m = m0 + r, n = n0 + c;
        if (m >= p.M || n >= p.N) continue;
        const long long off = (long long)m * p.N + n;
        if (split) {
            float* dst = p.ws + ((long long)s * p.B + b) * MN + off;
            const float* src = tw + r * LDY + c;
            if (vec) *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
            else
                for (int e = 0; e < EW && n + e < p.N; ++e) dst[e] = src[e];
        } else {
            bf16* dst = static_cast<bf16*>(p.y) + (long long)b * MN + off;
            const bf16* src = ty + r * LDY + c;
            if (vec) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
            else
                for (int e = 0; e < EY && n + e < p.N; ++e) dst[e] = src[e];
        }
    }
}

// y = (sum_{s=0..S-1} ws[s]) * out_mask * row_mask on live tiles, 0 elsewhere;
// the slices are added in fixed order, so the result is deterministic; y is
// rounded once to E
template <typename E>
__global__ void __launch_bounds__(256)
pm_reduce(const float* __restrict__ ws, E* __restrict__ y,
          const float* __restrict__ out_mask, long long sob,
          const float* __restrict__ row_mask, long long srb,
          const int* __restrict__ m_keep, const int* __restrict__ n_keep,
          int B, int M, int N, int bm, int bn, int nMb, int nNb, int S)
{
    const long long total = (long long)B * M * N;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        const int n = (int)(e % N);
        const long long r = e / N;
        const int m = (int)(r % M);
        const int b = (int)(r / M);
        float v = 0.0f;
        if (m_keep[(long long)b * nMb + m / bm] != 0 && n_keep[(long long)b * nNb + n / bn] != 0) {
            float acc = ws[e];
            for (int s = 1; s < S; ++s) acc += ws[(long long)s * total + e];
            v = acc * out_mask[(long long)b * sob + n] * row_mask[(long long)b * srb + m];
        }
        y[e] = from_f32<E>(v);
    }
}

// the instance of (tile, layout, mode) and its dynamic shared memory
typedef void (*KernelFn)(const Params);

template <int TM, int TN, int L, bool BF16>
struct Kernel {
    static KernelFn fn() {
        if constexpr (BF16) return pm_kernel_bf16<TM, TN, L>;
        else return pm_kernel<TM, TN, L>;
    }
    static constexpr size_t bytes = BF16 ? tc::Shape<TM, TN, L>::bytes : Shape<TM, TN, L>::bytes;
};

template <int TM, int TN, int L, bool BF16>
int launch(const Params& p, cudaStream_t st)
{
    using KN = Kernel<TM, TN, L, BF16>;
    const KernelFn fn = KN::fn();
    // once per instance and device: opt in above 48 KB, and ask for the
    // largest shared-memory carveout so that two blocks fit on an SM
    static int configured_for = -1;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (configured_for != dev) {
        err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)KN::bytes);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute((const void*)fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   100);
        if (err != cudaSuccess) return (int)err;
        configured_for = dev;
    }
    const int tiles = ((p.M + TM - 1) / TM) * ((p.N + TN - 1) / TN);
    dim3 grid(tiles, p.split, p.B);
    fn<<<grid, THREADS, KN::bytes, st>>>(p);
    return (int)cudaGetLastError();
}

template <int TM, int TN, bool BF16>
int launch_layout(const Params& p, int layout, cudaStream_t st)
{
    switch (layout) {
        case L_GENERIC: return launch<TM, TN, L_GENERIC, BF16>(p, st);
        case L_FWD: return launch<TM, TN, L_FWD, BF16>(p, st);
        case L_DX: return launch<TM, TN, L_DX, BF16>(p, st);
        case L_DW: return launch<TM, TN, L_DW, BF16>(p, st);
    }
    return (int)cudaErrorInvalidValue;
}

template <int TM, int TN>
int launch_tile(const Params& p, int layout, bool is_bf16, cudaStream_t st)
{
    return is_bf16 ? launch_layout<TM, TN, true>(p, layout, st)
                : launch_layout<TM, TN, false>(p, layout, st);
}

struct Instance {
    const char* name;
    const void* fn;
    size_t dyn_smem;
};

#define PM_INST(TM, TN, L, BF16, NAME)                                                    \
    {"pm_kernel<" #TM "x" #TN "," NAME ">", (const void*)Kernel<TM, TN, L, BF16>::fn(),   \
     Kernel<TM, TN, L, BF16>::bytes}
#define PM_TILE(TM, TN)                                                                   \
    PM_INST(TM, TN, L_GENERIC, false, "generic"), PM_INST(TM, TN, L_FWD, false, "fwd"),   \
    PM_INST(TM, TN, L_DX, false, "dx"), PM_INST(TM, TN, L_DW, false, "dw"),               \
    PM_INST(TM, TN, L_GENERIC, true, "generic,bf16"), PM_INST(TM, TN, L_FWD, true, "fwd,bf16"), \
    PM_INST(TM, TN, L_DX, true, "dx,bf16"), PM_INST(TM, TN, L_DW, true, "dw,bf16")

const Instance INSTANCES[] = {
    PM_TILE(128, 128), PM_TILE(128, 64), PM_TILE(64, 128), PM_TILE(64, 64),
    {"pm_reduce", (const void*)pm_reduce<float>, 0},
    {"pm_reduce<bf16>", (const void*)pm_reduce<bf16>, 0},
};
constexpr int N_INSTANCES = sizeof(INSTANCES) / sizeof(INSTANCES[0]);

int run(const Params& p, int layout, int tile_m, int tile_n, bool is_bf16, cudaStream_t st)
{
    if (p.B <= 0 || p.M <= 0 || p.N <= 0) return (int)cudaSuccess;
    if (p.split < 1 || (p.split > 1 && p.ws == nullptr) || p.bk % (is_bf16 ? tc::BK_GRAIN : TK) != 0)
        return (int)cudaErrorInvalidValue;
    int rc;
    if (tile_m == 128 && tile_n == 128) rc = launch_tile<128, 128>(p, layout, is_bf16, st);
    else if (tile_m == 128 && tile_n == 64) rc = launch_tile<128, 64>(p, layout, is_bf16, st);
    else if (tile_m == 64 && tile_n == 128) rc = launch_tile<64, 128>(p, layout, is_bf16, st);
    else if (tile_m == 64 && tile_n == 64) rc = launch_tile<64, 64>(p, layout, is_bf16, st);
    else return (int)cudaErrorInvalidValue;
    if (rc != 0 || p.split == 1) return rc;
    const long long total = (long long)p.B * p.M * p.N;
    const long long want = (total + 255) / 256;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    if (is_bf16)
        pm_reduce<bf16><<<blocks, 256, 0, st>>>(
            p.ws, static_cast<bf16*>(p.y), p.out_mask, p.sob, p.row_mask, p.srb,
            p.m_keep, p.n_keep, p.B, p.M, p.N, p.bm, p.bn, p.nMb, p.nNb, p.split);
    else
        pm_reduce<float><<<blocks, 256, 0, st>>>(
            p.ws, static_cast<float*>(p.y), p.out_mask, p.sob, p.row_mask, p.srb,
            p.m_keep, p.n_keep, p.B, p.M, p.N, p.bm, p.bn, p.nMb, p.nNb, p.split);
    return (int)cudaGetLastError();
}

}  // namespace

#define PM_ARGS(T)                                                         \
    const T* x, long long sxb, long long sxm, long long sxk,              \
    const T* w, long long swb, long long swk, long long swn,              \
    const float* in_mask, long long sib,                                  \
    const float* out_mask, long long sob,                                 \
    const float* row_mask, long long srb,                                 \
    const int* m_keep, const int* n_keep,                                 \
    const int* k_live, const int* k_count,                                \
    T* y, float* ws,                                                      \
    int B, int M, int N, int K, int bm, int bn, int bk,                   \
    int nMb, int nNb, int nKb,                                            \
    int layout, int tile_m, int tile_n, int split,                        \
    void* stream
#define PM_PARAMS                                                          \
    Params{x, sxb, sxm, sxk, w, swb, swk, swn, in_mask, sib, out_mask, sob, \
           row_mask, srb, m_keep, n_keep, k_live, k_count, y, ws,          \
           B, M, N, K, bm, bn, bk, nMb, nNb, nKb, split}

// x, w, y float32; any layout.  Returns a cudaError_t.
extern "C" int pruned_matmul_f32(PM_ARGS(float))
{
    return run(PM_PARAMS, layout, tile_m, tile_n, false, (cudaStream_t)stream);
}

// x, w, y bfloat16, masks and workspace float32; any layout.
extern "C" int pruned_matmul_bf16(PM_ARGS(__nv_bfloat16))
{
    return run(PM_PARAMS, layout, tile_m, tile_n, true, (cudaStream_t)stream);
}

extern "C" int pruned_matmul_instance_count() { return N_INSTANCES; }

// name, and {registers, local bytes (spills and stack), static shared bytes,
// dynamic shared bytes, max threads per block} of instance i
extern "C" int pruned_matmul_instance_info(int i, char* name, int name_len, int* out)
{
    if (i < 0 || i >= N_INSTANCES || name_len <= 0) return (int)cudaErrorInvalidValue;
    strncpy(name, INSTANCES[i].name, name_len - 1);
    name[name_len - 1] = '\0';
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, INSTANCES[i].fn);
    if (err != cudaSuccess) return (int)err;
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    out[2] = (int)a.sharedSizeBytes;
    out[3] = (int)INSTANCES[i].dyn_smem;
    out[4] = a.maxThreadsPerBlock;
    return 0;
}
