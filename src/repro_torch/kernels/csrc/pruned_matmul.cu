// Block-skip masked matmul for Hopper (sm_90a), plain FP32 FFMA.
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
// w are bf16, the masks float32; each element is converted to float32 as it
// is loaded, the products, the accumulators, the split-K workspace and its
// reduce stay float32 as above, and y is rounded to bf16 once, at its store
// (as the Pallas _finish casts the float32 accumulator).  Pruned units stay
// exact zeros.  Every direction runs one instance kind: the generic one,
// whose loads go through registers (where the conversion happens) and whose
// strides are free, so forward, dX and dW each get a bf16 instance per
// output tile with the same skip and split rules.  The cp.async layouts in
// bf16 (16-byte copies of 8 elements, converted in shared memory) and bf16
// tensor-core products are later work.

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

// element conversions of the bf16 mode
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename E> __device__ __forceinline__ E from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
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
// when MASKED, a ring of the steps' 16 in_mask values beside it).  E is the
// operand's element type in global memory (bf16 only with K_GEN, whose
// register loads convert it; the shared tiles are float32 either way).
template <int KIND, int R, bool MASKED, typename E = float>
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

    const E* g;
    long long sr, sk;
    const float* mask;
    int r0, rext, K, t;
    bool rfast;          // K_GEN: consecutive threads walk r (else k)
    float v[NREG];
    float mv[NMASK];

    __device__ Operand(const E* g_, long long sr_, long long sk_, const float* mask_,
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
                v[c] = ok ? to_f32(__ldg(g + (long long)r * sr + (long long)k * sk)) : 0.f;
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

template <int TM, int TN, int L, typename E = float>
struct Shape {
    using KD = Kinds<L>;
    using OA = Operand<KD::A, TM, true, E>;
    using OB = Operand<KD::B, TN, false, E>;
    static constexpr size_t bytes = (size_t)(OA::FLOATS + OB::FLOATS) * sizeof(float);
};

template <int TM, int TN, int LAYOUT, typename E = float>
__global__ void __launch_bounds__(THREADS, Kinds<LAYOUT>::min_blocks)
pm_kernel(const Params p)
{
    static_assert(sizeof(E) == 4 || LAYOUT == L_GENERIC, "bf16 runs the generic instance");
    using SH = Shape<TM, TN, LAYOUT, E>;
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
        E* yb = static_cast<E*>(p.y) + (long long)b * MN;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int m = m0 + ty * 4 + 64 * (i / 4) + (i % 4);
            if (m >= p.M) continue;
#pragma unroll
            for (int j = 0; j < RN; ++j) {
                const int n = n0 + tx * 4 + 64 * (j / 4) + (j % 4);
                if (n < p.N) yb[(long long)m * p.N + n] = from_f32<E>(0.0f);
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
    OA la(static_cast<const E*>(p.x) + (long long)b * p.sxb, p.sxm, p.sxk, imb, m0, p.M, p.K, t);
    OB lb(static_cast<const E*>(p.w) + (long long)b * p.swb, p.swn, p.swk, nullptr, n0, p.N,
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

    // epilogue: S == 1 writes y with out_mask * row_mask (rounded once to E);
    // S > 1 writes the raw float32 partial into workspace slice s
    float* part = split ? p.ws + ((long long)s * p.B + b) * MN : nullptr;
    E* yo = static_cast<E*>(p.y) + (long long)b * MN;
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
            if (split) {
                float* dst = part + off;
                if (vec_out && n + 3 < p.N) {
                    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
                } else {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (n + j < p.N) dst[j] = v[j];
                }
            } else {
                E* dst = yo + off;
                if (sizeof(E) == 4 && vec_out && n + 3 < p.N) {
                    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
                } else {
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (n + j < p.N) dst[j] = from_f32<E>(v[j]);
                }
            }
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

template <int TM, int TN, int L, typename E>
int launch(const Params& p, cudaStream_t st)
{
    constexpr size_t bytes = Shape<TM, TN, L, E>::bytes;
    // once per instance and device: opt in above 48 KB, and ask for the
    // largest shared-memory carveout so that two blocks fit on an SM
    static int configured_for = -1;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (configured_for != dev) {
        err = cudaFuncSetAttribute(
            pm_kernel<TM, TN, L, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
        err = cudaFuncSetAttribute(pm_kernel<TM, TN, L, E>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout, 100);
        if (err != cudaSuccess) return (int)err;
        configured_for = dev;
    }
    const int tiles = ((p.M + TM - 1) / TM) * ((p.N + TN - 1) / TN);
    dim3 grid(tiles, p.split, p.B);
    pm_kernel<TM, TN, L, E><<<grid, THREADS, bytes, st>>>(p);
    return (int)cudaGetLastError();
}

template <int TM, int TN>
int launch_layout(const Params& p, int layout, bool bf16, cudaStream_t st)
{
    if (bf16) {
        if (layout != L_GENERIC) return (int)cudaErrorInvalidValue;
        return launch<TM, TN, L_GENERIC, __nv_bfloat16>(p, st);
    }
    switch (layout) {
        case L_GENERIC: return launch<TM, TN, L_GENERIC, float>(p, st);
        case L_FWD: return launch<TM, TN, L_FWD, float>(p, st);
        case L_DX: return launch<TM, TN, L_DX, float>(p, st);
        case L_DW: return launch<TM, TN, L_DW, float>(p, st);
    }
    return (int)cudaErrorInvalidValue;
}

struct Instance {
    const char* name;
    const void* fn;
    size_t dyn_smem;
};

#define PM_INST(TM, TN, L, E, NAME)                                          \
    {"pm_kernel<" #TM "x" #TN "," NAME ">", (const void*)pm_kernel<TM, TN, L, E>, \
     Shape<TM, TN, L, E>::bytes}
#define PM_TILE(TM, TN)                                                                   \
    PM_INST(TM, TN, L_GENERIC, float, "generic"), PM_INST(TM, TN, L_FWD, float, "fwd"),   \
    PM_INST(TM, TN, L_DX, float, "dx"), PM_INST(TM, TN, L_DW, float, "dw"),               \
    PM_INST(TM, TN, L_GENERIC, __nv_bfloat16, "generic,bf16")

const Instance INSTANCES[] = {
    PM_TILE(128, 128), PM_TILE(128, 64), PM_TILE(64, 128), PM_TILE(64, 64),
    {"pm_reduce", (const void*)pm_reduce<float>, 0},
    {"pm_reduce<bf16>", (const void*)pm_reduce<__nv_bfloat16>, 0},
};
constexpr int N_INSTANCES = sizeof(INSTANCES) / sizeof(INSTANCES[0]);

int run(const Params& p, int layout, int tile_m, int tile_n, bool bf16, cudaStream_t st)
{
    if (p.B <= 0 || p.M <= 0 || p.N <= 0) return (int)cudaSuccess;
    if (p.split < 1 || (p.split > 1 && p.ws == nullptr) || p.bk % TK != 0)
        return (int)cudaErrorInvalidValue;
    int rc;
    if (tile_m == 128 && tile_n == 128) rc = launch_layout<128, 128>(p, layout, bf16, st);
    else if (tile_m == 128 && tile_n == 64) rc = launch_layout<128, 64>(p, layout, bf16, st);
    else if (tile_m == 64 && tile_n == 128) rc = launch_layout<64, 128>(p, layout, bf16, st);
    else if (tile_m == 64 && tile_n == 64) rc = launch_layout<64, 64>(p, layout, bf16, st);
    else return (int)cudaErrorInvalidValue;
    if (rc != 0 || p.split == 1) return rc;
    const long long total = (long long)p.B * p.M * p.N;
    const long long want = (total + 255) / 256;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    if (bf16)
        pm_reduce<__nv_bfloat16><<<blocks, 256, 0, st>>>(
            p.ws, static_cast<__nv_bfloat16*>(p.y), p.out_mask, p.sob, p.row_mask, p.srb,
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

// x, w, y bfloat16, masks and workspace float32; layout must be generic (0).
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
