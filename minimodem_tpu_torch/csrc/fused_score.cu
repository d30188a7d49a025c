// fused_score.cu — K1, the fused FSK scorer (stages 1 and 2 in one kernel).
//
// Replaces minimodem_tpu/ops/pallas_score.py::_build, the fused Pallas
// scorer.  For every candidate frame offset t of a stream it computes the
// frame confidence, amplitude and packed frame bits (reference:
// src/fsk.c:107-174 bit analysis, :178-446 frame analysis, CONFIDENCE_ALGO
// 6) and writes them as int32 score planes [B, P, t_len]:
//   0 conf_data  1 ampl_data  2 bits_lo  (3 conf_sync  4 ampl_sync when
//   the sync expect string differs from the data one).
//
// One CTA per (tile of `tile` offsets, stream):
//   1. stage the tile's audio plus its halo (max_begin + nb samples) and
//      the [4, nb] basis in shared memory;
//   2. correlate: for each of tile + max_begin sample offsets, four
//      length-nb dot products in FP32 on the CUDA cores (no tensor cores,
//      no TF32) as a chain of __fmaf_rn in ascending j — the chain XLA
//      compiles the JAX package's _correlate_direct into, and the plain
//      version's (ops/demod.py correlate, an exact FMA emulation), so the
//      planes match it bit for bit.  (A chain of separately rounded
//      products drifted 4e-6 relative from both JAX scorers on NOAA
//      SAME's near-cancelling noise bands.);
//   3. band magnitudes sqrtf(c*c + s*s) * scal (the TPU kernel's formula,
//      pallas_score.py:228-231), the strict bit mark > space, and the
//      signed signal plane ss (the sign carries the bit) and the noise
//      plane gated at FLT_EPSILON, both into shared memory;
//   4. pass 1 (comb sums over the n_bits taps at bit_begin[k]) and pass 2
//      (divergence) as shifted shared-memory reads, one offset per thread.
//
// Bound: FP32 work, 4 * nb FMAs per sample offset for the correlation,
// against 12-20 bytes written per offset.  Tiles of up to 2048 offsets keep the halo recompute at
// max_begin / tile (20% for Bell-202 at 48 kHz) and the CTA's shared
// memory at ~30 KB, so several CTAs share an SM and hide the smem
// latency.  The basis reads are warp broadcasts and the audio reads are
// consecutive across lanes, so shared memory is conflict-free.
//
// Built without --use_fast_math: the SNR relies on IEEE x/0 = inf and
// 0/0 = nan (pallas_score.py:377), and sqrtf / division must round
// correctly for the planes to match the plain version.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kFltEpsilon = 1.1920928955078125e-07f;

__global__ void __launch_bounds__(kThreads)
fused_score_kernel(const float* __restrict__ x, long long x_stride,
                   int t_len, const float* __restrict__ basis, int nb,
                   const int* __restrict__ bit_begin, int n_bits,
                   int max_begin, float scal, unsigned d_mask,
                   unsigned d_val, unsigned s_mask, unsigned s_val,
                   int n_planes, int tile, int* __restrict__ out) {
    extern __shared__ float smem[];
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * tile;
    const int n_t = min(tile, t_len - t0);       // offsets this CTA scores
    const int span = tile + max_begin;            // plane length per CTA
    const int s_cnt = n_t + max_begin;            // correlated offsets
    const int x_cnt = s_cnt + nb - 1;

    float* xs = smem;                             // [span + nb]
    float* bs = xs + span + nb;                   // [4 * nb]
    float* ss = bs + 4 * nb;                      // [span] signed signal
    float* ng = ss + span;                        // [span] gated noise
    int* beg = reinterpret_cast<int*>(ng + span); // [n_bits]

    const float* xrow = x + (long long)b * x_stride + t0;
    for (int i = threadIdx.x; i < x_cnt; i += blockDim.x) xs[i] = xrow[i];
    for (int i = threadIdx.x; i < 4 * nb; i += blockDim.x) bs[i] = basis[i];
    for (int i = threadIdx.x; i < n_bits; i += blockDim.x)
        beg[i] = bit_begin[i];
    __syncthreads();

    // ---- stage 1: correlation -> magnitudes -> ss / ng planes ----
    for (int i = threadIdx.x; i < s_cnt; i += blockDim.x) {
        float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
        const float* xp = xs + i;
        for (int j = 0; j < nb; ++j) {
            const float v = xp[j];
            c0 = __fmaf_rn(bs[j], v, c0);
            c1 = __fmaf_rn(bs[nb + j], v, c1);
            c2 = __fmaf_rn(bs[2 * nb + j], v, c2);
            c3 = __fmaf_rn(bs[3 * nb + j], v, c3);
        }
        const float mm =
            __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(c0, c0), __fmul_rn(c1, c1))),
                      scal);
        const float ms =
            __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(c2, c2), __fmul_rn(c3, c3))),
                      scal);
        const bool bit = mm > ms;                 // fsk.c:161 strict
        const float sig = bit ? mm : ms;
        const float noise = bit ? ms : mm;
        ss[i] = bit ? sig : -sig;
        ng[i] = noise > kFltEpsilon ? noise : 0.0f;
    }
    __syncthreads();

    // ---- stage 2: comb sums (pass 1) and divergence (pass 2) ----
    const float n_bits_f = (float)n_bits;
    const long long plane = (long long)t_len;
    int* orow = out + (long long)b * n_planes * plane + t0;
    for (int t = threadIdx.x; t < n_t; t += blockDim.x) {
        float total_sig = 0.0f, total_noise = 0.0f, mark_sig = 0.0f;
        int n_mark = 0;
        unsigned bits = 0u;
        for (int k = 0; k < n_bits; ++k) {
            const int s = t + beg[k];
            const float v = ss[s];
            const float sb = fabsf(v);
            const bool bk = v > 0.0f;
            total_sig = __fadd_rn(total_sig, sb);
            total_noise = __fadd_rn(total_noise, ng[s]);
            if (bk) {
                mark_sig = __fadd_rn(mark_sig, sb);
                ++n_mark;
                bits |= 1u << k;
            }
        }
        const float n_mark_f = (float)n_mark;
        const float n_space_f = __fsub_rn(n_bits_f, n_mark_f);
        const float space_sig = __fsub_rn(total_sig, mark_sig);
        // averages guarded like C (reference: src/fsk.c:298-301)
        const float avg_mark =
            n_mark_f > 0.0f ? __fdiv_rn(mark_sig, n_mark_f) : 0.0f;
        const float avg_space =
            n_space_f > 0.0f ? __fdiv_rn(space_sig, n_space_f) : 0.0f;
        float div = 0.0f;
        for (int k = 0; k < n_bits; ++k) {
            const float v = ss[t + beg[k]];
            const float own = v > 0.0f ? avg_mark : avg_space;
            div = __fadd_rn(div, __fdiv_rn(fabsf(__fsub_rn(fabsf(v), own)),
                                           own));
        }
        div = __fdiv_rn(__fmul_rn(div, 2.0f), n_bits_f);
        const float snr = __fdiv_rn(total_sig, total_noise);  // x/0 = inf
        const float conf = __fmul_rn(snr, __fsub_rn(1.0f, div));
        const float ampl = __fdiv_rn(total_sig, n_bits_f);
        const bool ok_d = ((bits ^ d_val) & d_mask) == 0u;
        orow[t] = __float_as_int(ok_d ? conf : 0.0f);
        orow[plane + t] = __float_as_int(ok_d ? ampl : 0.0f);
        orow[2 * plane + t] = (int)bits;
        if (n_planes == 5) {
            const bool ok_s = ((bits ^ s_val) & s_mask) == 0u;
            orow[3 * plane + t] = __float_as_int(ok_s ? conf : 0.0f);
            orow[4 * plane + t] = __float_as_int(ok_s ? ampl : 0.0f);
        }
    }
}

}  // namespace

extern "C" int mm_fused_score(const void* x, long long x_stride, int batch,
                              int t_len, const void* basis, int nb,
                              const void* bit_begin, int n_bits,
                              int max_begin, float scal, unsigned d_mask,
                              unsigned d_val, unsigned s_mask,
                              unsigned s_val, int n_planes, int tile,
                              int smem_bytes, void* out, void* stream) {
    if (smem_bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            fused_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem_bytes);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((t_len + tile - 1) / tile, batch);
    fused_score_kernel<<<grid, kThreads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), x_stride, t_len,
        static_cast<const float*>(basis), nb,
        static_cast<const int*>(bit_begin), n_bits, max_begin, scal, d_mask,
        d_val, s_mask, s_val, n_planes, tile, static_cast<int*>(out));
    return (int)cudaGetLastError();
}
