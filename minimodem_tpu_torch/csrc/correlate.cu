// correlate.cu — K3, the stage-1 sliding correlation on its own.
//
// Replaces both TPU kernels of minimodem_tpu/ops/pallas_demod.py:
//   K3a  _build        (one stream; a banded [128, KDIM] x [KDIM, 512]
//                       MXU matmul per 16K-offset tile)
//   K3b  _build_batch  (the same with streams on a leading grid axis,
//                       reached through its custom_vmap rule)
// The host engines' scorer (ops/demod.py DemodScorer) calls it: one row
// per chunk for `score`, up to 64 overlapping chunk rows of one stream for
// `score_chunks`.
//
//   corr[b, c, s] = sum_{j < nb} basis[c, j] * x[b, s + j],  s < s_len
//
// x: rows of >= s_len + nb - 1 float32 samples at a row stride (so
// overlapping chunk windows of one padded stream, x.unfold(0, L, step),
// need no copy); basis: [4, nb] float32; out: [B, 4, s_len] float32,
// row-major (the JAX layout per stream).  nb <= 4096 is served (beyond,
// the scorer takes the FFT route, as the JAX package does).
//
// One CTA per (tile of `tile` <= 2048 offsets, stream), one thread per 8
// offsets, the tile from ops/correlate.py pick_tile:
//   1. the tile's tile + nb - 1 samples into shared memory by a 1-D TMA
//      bulk copy where the row start is 16-byte aligned (by plain loads
//      where it is not: an odd row stride), the basis as [nb8] float4;
//   2. each thread scores 8 consecutive offsets with the register-blocked
//      correlation K1 uses (correlate.cuh): the ascending-j __fmaf_rn
//      chain, bit-identical with the plain version (ops/demod.py
//      correlate) and through it with the JAX package's _correlate_direct
//      on the CPU;
//   3. it stores them as two 16-byte streaming stores (__stcs: the 46 MB
//      of K3b's output pass through L2 evict-first; faster than default
//      stores, and the channel math that reads them is no slower) per
//      output plane, so a warp writes 1 KB of a plane contiguously
//      (scalar stores where s_len % 4 != 0 or at the ragged end of the
//      row).
//
// Bound: an offset costs 4 * nb FMAs against 16 bytes of output and ~4 of
// input.  Bell-202 (nb = 40) at the host engines' K3b shape, 22 chunk rows
// of 131472 offsets: 463 M FMAs, 14 us at the FP32 peak, against 58 MB,
// 17 us at the HBM rate, so both bounds meet.  The first port gave a
// thread one offset and read 1 audio and 4 basis words from shared memory
// for 4 FMAs: shared-memory issue bound at ~4.5x the bound.  The register
// blocking gives ~16 FMAs per shared-memory load; the tile rule keeps the
// halo (nb - 1 samples staged twice) under 1/8 of a tile up to the CTA's
// 2048 offsets where the grid still fills the card, and otherwise gives
// the SMs their CTAs first: the halo costs only its staging, no offset is
// computed twice, and CTAs of more offsets (fewer resident warps next to
// a large basis) ran slower.

#include <cuda_runtime.h>
#include <cstdint>

#include "correlate.cuh"

namespace {

using corr::kR;

constexpr int kMaxThreads = 256;

__device__ __forceinline__ void store4(float* p, float4 v) {
    __stcs(reinterpret_cast<float4*>(p), v);
}

__global__ void __launch_bounds__(kMaxThreads)
correlate_kernel(const float* __restrict__ x, long long x_stride, int s_len,
                 const float* __restrict__ basis, int nb, int tile,
                 float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    __shared__ uint64_t bar;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int b = blockIdx.y;
    const int s0 = blockIdx.x * tile;
    const int n_s = min(tile, s_len - s0);        // offsets this CTA scores
    const int x_cnt = n_s + nb - 1;               // samples they read
    const int nb8 = (nb + 7) & ~7;

    float4* bs = reinterpret_cast<float4*>(smem);     // [nb8] basis taps
    float* xs = smem + 4 * nb8;                       // [tile + nb8] audio

    const float* xrow = x + (long long)b * x_stride + s0;
    const bool tma = corr::stage_audio(xs, xrow, x_cnt, &bar, tid, nthreads);
    corr::stage_basis(bs, basis, nb, tid, nthreads);
    __syncthreads();
    if (tma) sm90::mbar_wait(&bar, 0);

    const long long plane = (long long)s_len;
    float* orow = out + (long long)b * 4 * plane + s0;
    const bool vec_ok = (s_len & 3) == 0 &&
                        (reinterpret_cast<uintptr_t>(orow) & 15u) == 0u;
    const int i0 = tid * kR;                      // this thread's offsets
    if (i0 >= n_s) return;
    float acc[kR][4];
    corr::correlate8(acc, xs + i0, bs, nb);
    if (vec_ok && i0 + kR <= n_s) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            float* o = orow + c * plane + i0;
            store4(o, make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]));
            store4(o + 4,
                   make_float4(acc[4][c], acc[5][c], acc[6][c], acc[7][c]));
        }
    } else {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            if (i0 + r >= n_s) break;
#pragma unroll
            for (int c = 0; c < 4; ++c) orow[c * plane + i0 + r] = acc[r][c];
        }
    }
}

}  // namespace

extern "C" int mm_correlate(const void* x, long long x_stride, int batch,
                            int s_len, const void* basis, int nb, int tile,
                            int smem_bytes, void* out, void* stream) {
    // one thread per kR offsets; the batch on the grid's y axis
    if (tile < kR || tile % kR != 0 || tile > kR * kMaxThreads || nb < 1 ||
        batch > 65535)
        return (int)cudaErrorInvalidValue;
    if (smem_bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            correlate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem_bytes);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((s_len + tile - 1) / tile, batch);
    correlate_kernel<<<grid, tile / kR, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), x_stride, s_len,
        static_cast<const float*>(basis), nb, tile, static_cast<float*>(out));
    return (int)cudaGetLastError();
}
