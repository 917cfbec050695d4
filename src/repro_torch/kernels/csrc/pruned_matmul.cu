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
// surviving unit writes zeros and returns; the K loop walks only the live
// bk-blocks, from a compacted per-row list the wrapper builds on the device
// (k_live[b, 0:k_count[b]], ascending).  The keep flags are computed outside
// the kernel, as the TPU kernel's scalar-prefetched flags are.  Ragged M/K/N
// edges are bounds-checked here; nothing is padded in device memory.
//
// Tiles: 64x64 outputs per 256-thread block, a 4x4 register tile per thread,
// a K step of 16 through shared memory.  Every block size must be a multiple
// of 64 so that a tile lies inside one block of each dimension (the wrapper,
// KERNEL_TILE in pruned_matmul.py, checks this and names compute_blocks).
//
// What bounds it on an H100: FP32 FFMA throughput (67 TFLOP/s peak) at
// VGG16 widths, well below the tensor cores, and the thin, very deep dW
// products (conv0/conv1: M = 32*32*32 = 32768 contraction rows per worker
// against a 576 x 64 output), where only B * 9 output tiles exist and each
// walks the whole contraction serially.  This design does nothing about
// either beyond skipping dead blocks; wgmma/TMA tiles, split-K for dW and a
// bf16 mode are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;    // output tile rows
constexpr int TN = 64;    // output tile cols
constexpr int TK = 16;    // K step
constexpr int PAD = 4;    // shared-memory row pad (bank conflicts, 16B rows)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pruned_matmul_kernel(
    const float* __restrict__ x, long long sxb, long long sxm, long long sxk,
    const float* __restrict__ w, long long swb, long long swk, long long swn,
    const float* __restrict__ in_mask, long long sib,
    const float* __restrict__ out_mask, long long sob,
    const float* __restrict__ row_mask, long long srb,
    const int* __restrict__ m_keep, const int* __restrict__ n_keep,
    const int* __restrict__ k_live, const int* __restrict__ k_count,
    float* __restrict__ y,
    int M, int N, int K, int bm, int bn, int bk,
    int nMb, int nNb, int nKb)
{
    __shared__ __align__(16) float As[TK][TM + PAD];   // As[k][m]
    __shared__ __align__(16) float Bs[TK][TN + PAD];   // Bs[k][n]

    const int b = blockIdx.z;
    const int m0 = blockIdx.y * TM;
    const int n0 = blockIdx.x * TN;
    const int t = threadIdx.x;
    const int tx = t % 16;          // column group: n = n0 + tx*4 + j
    const int ty = t / 16;          // row group:    m = m0 + ty*4 + i

    float* yb = y + (long long)b * M * N;
    const bool live =
        m_keep[(long long)b * nMb + m0 / bm] != 0 &&
        n_keep[(long long)b * nNb + n0 / bn] != 0;
    if (!live) {
        for (int i = 0; i < 4; ++i) {
            const int m = m0 + ty * 4 + i;
            if (m >= M) break;
            for (int j = 0; j < 4; ++j) {
                const int n = n0 + tx * 4 + j;
                if (n < N) yb[(long long)m * N + n] = 0.0f;
            }
        }
        return;
    }

    const float* xb = x + (long long)b * sxb;
    const float* wb = w + (long long)b * swb;
    const float* imb = in_mask + (long long)b * sib;
    const int* klist = k_live + (long long)b * nKb;
    const int nlive = k_count[b];
    // load mappings: put consecutive threads on the operand's unit stride
    const bool x_k_fast = (sxk == 1) || (sxm != 1);
    const bool w_n_fast = (swn == 1);

    float acc[4][4];
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int li = 0; li < nlive; ++li) {
        const int kb = klist[li];
        const int k_lo = kb * bk;
        const int k_hi = min(k_lo + bk, K);
        for (int k0 = k_lo; k0 < k_hi; k0 += TK) {
            // x tile [TM x TK] -> As[k][m], in_mask applied as it is loaded
            for (int r = 0; r < 4; ++r) {
                int mm, kk;
                if (x_k_fast) { kk = t % TK; mm = t / TK + 16 * r; }
                else          { mm = t % TM; kk = t / TM + 4 * r; }
                const int m = m0 + mm, k = k0 + kk;
                float v = 0.0f;
                if (m < M && k < k_hi)
                    v = xb[(long long)m * sxm + (long long)k * sxk] * imb[k];
                As[kk][mm] = v;
            }
            // w tile [TK x TN] -> Bs[k][n]
            for (int r = 0; r < 4; ++r) {
                int kk, nn;
                if (w_n_fast) { nn = t % TN; kk = t / TN + 4 * r; }
                else          { kk = t % TK; nn = t / TK + 16 * r; }
                const int k = k0 + kk, n = n0 + nn;
                float v = 0.0f;
                if (k < k_hi && n < N)
                    v = wb[(long long)k * swk + (long long)n * swn];
                Bs[kk][nn] = v;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < TK; ++kk) {
                const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
                const float4 c = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
            }
            __syncthreads();
        }
    }

    // epilogue: out_mask * row_mask, bounds-checked stores
    const float* omb = out_mask + (long long)b * sob;
    const float* rmb = row_mask + (long long)b * srb;
    for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty * 4 + i;
        if (m >= M) break;
        const float rm = rmb[m];
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx * 4 + j;
            if (n < N) yb[(long long)m * N + n] = acc[i][j] * omb[n] * rm;
        }
    }
}

}  // namespace

extern "C" int pruned_matmul_f32(
    const float* x, long long sxb, long long sxm, long long sxk,
    const float* w, long long swb, long long swk, long long swn,
    const float* in_mask, long long sib,
    const float* out_mask, long long sob,
    const float* row_mask, long long srb,
    const int* m_keep, const int* n_keep,
    const int* k_live, const int* k_count,
    float* y,
    int B, int M, int N, int K, int bm, int bn, int bk,
    int nMb, int nNb, int nKb,
    void* stream)
{
    if (B <= 0 || M <= 0 || N <= 0) return (int)cudaSuccess;
    dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, B);
    pruned_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        x, sxb, sxm, sxk, w, swb, swk, swn,
        in_mask, sib, out_mask, sob, row_mask, srb,
        m_keep, n_keep, k_live, k_count, y,
        M, N, K, bm, bn, bk, nMb, nNb, nKb);
    return (int)cudaGetLastError();
}
