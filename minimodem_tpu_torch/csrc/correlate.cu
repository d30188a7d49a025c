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
// row-major (the JAX layout per stream).
//
// One CTA per (tile of kTile offsets, stream): the tile's kTile + nb - 1
// samples and the basis are staged in shared memory, then each thread
// scores offsets with four FP32 accumulators on the CUDA cores (no tensor
// cores, no TF32) as a chain of __fmaf_rn in ascending j.  That is the
// chain K1's stage 1 computes (fused_score.cu), the chain XLA compiles the
// JAX package's _correlate_direct into on the CPU, and the plain version's
// (ops/demod.py correlate, an exact FMA emulation): the result matches it
// bit for bit.  The TPU kernel's MAX_NB VMEM gate, banded W and 1024-
// aligned flat layout are not carried over; nb <= 4096 is served (beyond,
// the scorer takes the FFT route, as the JAX package does).
//
// Bound: for Bell-202 (nb = 40) an offset costs 4 * 40 FMAs = 320 FLOP
// against 20 bytes of device memory (4 read, 16 written), ~16 FLOP/B,
// near the H100's FP32-to-HBM balance point (67 TFLOP/s / 3.35 TB/s =
// 20 FLOP/B), so neither bound is far.  Basis reads are warp broadcasts and
// sample reads consecutive across lanes: shared memory is conflict-free,
// and the four output rows are written coalesced.
//
// A later PR would block several offsets per thread in registers (one
// basis load feeding several FMAs), vectorise the stores, or serve the
// host engine from K1 directly so the correlation never reaches memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;     // offsets per CTA

__global__ void __launch_bounds__(kThreads)
correlate_kernel(const float* __restrict__ x, long long x_stride, int s_len,
                 const float* __restrict__ basis, int nb,
                 float* __restrict__ out) {
    extern __shared__ float smem[];
    const int b = blockIdx.y;
    const int s0 = blockIdx.x * kTile;
    const int n_s = min(kTile, s_len - s0);      // offsets this CTA scores
    const int x_cnt = n_s + nb - 1;

    float* xs = smem;                            // [kTile + nb - 1]
    float* bs = xs + kTile + nb - 1;             // [4 * nb]

    const float* xrow = x + (long long)b * x_stride + s0;
    for (int i = threadIdx.x; i < x_cnt; i += blockDim.x) xs[i] = xrow[i];
    for (int i = threadIdx.x; i < 4 * nb; i += blockDim.x) bs[i] = basis[i];
    __syncthreads();

    const long long plane = (long long)s_len;
    float* orow = out + (long long)b * 4 * plane + s0;
    for (int i = threadIdx.x; i < n_s; i += blockDim.x) {
        float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
        const float* xp = xs + i;
        for (int j = 0; j < nb; ++j) {
            const float v = xp[j];
            c0 = __fmaf_rn(bs[j], v, c0);
            c1 = __fmaf_rn(bs[nb + j], v, c1);
            c2 = __fmaf_rn(bs[2 * nb + j], v, c2);
            c3 = __fmaf_rn(bs[3 * nb + j], v, c3);
        }
        orow[i] = c0;
        orow[plane + i] = c1;
        orow[2 * plane + i] = c2;
        orow[3 * plane + i] = c3;
    }
}

}  // namespace

extern "C" int mm_correlate(const void* x, long long x_stride, int batch,
                            int s_len, const void* basis, int nb, void* out,
                            void* stream) {
    const int smem_bytes =
        (int)sizeof(float) * (kTile + nb - 1 + 4 * nb);
    if (smem_bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            correlate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem_bytes);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((s_len + kTile - 1) / kTile, batch);
    correlate_kernel<<<grid, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), x_stride, s_len,
        static_cast<const float*>(basis), nb, static_cast<float*>(out));
    return (int)cudaGetLastError();
}
