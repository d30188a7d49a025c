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
//   1. one thread stages the tile's audio plus its halo (max_begin + nb
//      samples) into shared memory with a 1-D TMA bulk copy; the others
//      stage the basis interleaved as [nb][4] (one float4 per tap);
//   2. correlate, register-blocked (correlate.cuh, shared with K3): each
//      thread scores kR = 8 consecutive sample offsets, each sum the
//      ascending-j __fmaf_rn chain of the plain version, so the planes
//      match it bit for bit;
//   3. band magnitudes sqrtf(c*c + s*s) * scal (pallas_score.py:228-231),
//      the strict bit mark > space, the signed signal plane ss (the sign
//      carries the bit) and the noise plane gated at FLT_EPSILON, both into
//      shared memory in a phase-major layout (sample s at (s % 4) * P +
//      s / 4), so that stage 2's four-offsets-per-thread reads are
//      conflict-free;
//   4. pass 1 (comb sums over the n_bits taps at bit_begin[k]) and pass 2
//      (divergence), each sum in ascending k as before, four consecutive
//      offsets per thread, stored as 16-byte vectors along t.
//
// Bound: 4 * nb FMAs per scored offset (Bell-202 at 48 kHz: 160, ~0.67
// GFLOP per 2^21-sample segment, 10 us at the FP32 peak) against ~16 bytes
// of device memory per offset (33.6 MB, 10 us at the HBM rate): both
// bounds meet.  The first port read the basis from shared memory for every
// FMA (shared-memory bound) and recomputed a 20% halo: 0.1075 ms per
// segment.  The register blocking cuts shared-memory traffic per FMA by
// ~6x, whole blocks of 8 taps run unguarded (only the last nb % 8 taps
// test j < nb), the tile (ops/fused_score.py pick_tile: at least 8 *
// max_begin, 4096 for Bell-202) cuts the halo to ~10% while 512 CTAs of
// ~55 KB fill the 132 SMs in one wave, and stage 2 reads each tap's four
// phase-major offsets as one int4 and counts marks with a popcount.  What
// remains is stage 2's arithmetic: an IEEE division per tap in pass 2,
// which exactness keeps.  Measured (chip_smoke.py; NVIDIA H100 80GB HBM3,
// 700.00 W): 0.063 ms per segment.
//
// Built without --use_fast_math: the SNR relies on IEEE x/0 = inf and
// 0/0 = nan (pallas_score.py:377), and sqrtf / division must round
// correctly for the planes to match the plain version.

#include <cuda_runtime.h>
#include <cstdint>

#include "correlate.cuh"

namespace {

using corr::kR;

constexpr int kThreads = 256;
constexpr float kFltEpsilon = 1.1920928955078125e-07f;

// band magnitudes -> (signed signal, gated noise) of one offset
__device__ __forceinline__ void magnitudes(const float* c, float scal,
                                           float& sig, float& noise) {
    const float mm =
        __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(c[0], c[0]), __fmul_rn(c[1], c[1]))),
                  scal);
    const float ms =
        __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(c[2], c[2]), __fmul_rn(c[3], c[3]))),
                  scal);
    const bool bit = mm > ms;                 // fsk.c:161 strict
    const float s = bit ? mm : ms;
    const float n = bit ? ms : mm;
    sig = bit ? s : -s;
    noise = n > kFltEpsilon ? n : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
fused_score_kernel(const float* __restrict__ x, long long x_stride,
                   int t_len, const float* __restrict__ basis, int nb,
                   const int* __restrict__ bit_begin, int n_bits,
                   int max_begin, float scal, unsigned d_mask,
                   unsigned d_val, unsigned s_mask, unsigned s_val,
                   int n_planes, int tile, int* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    __shared__ uint64_t bar;
    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * tile;
    const int n_t = min(tile, t_len - t0);        // offsets this CTA scores
    const int s_cnt = n_t + max_begin;            // correlated offsets
    const int x_cnt = s_cnt + nb - 1;             // audio samples they read
    const int nb8 = (nb + 7) & ~7;
    const int span8 = (tile + max_begin + 7) & ~7;
    const int ph = span8 / 4;                     // phase-major plane stride

    float4* bs = reinterpret_cast<float4*>(smem);     // [nb8] basis taps
    float* xs = smem + 4 * nb8;                       // [span8 + nb8] audio
    float* ss = xs + span8 + nb8;                     // [span8] signal
    float* ng = ss + span8;                           // [span8] noise
    int4* offq = reinterpret_cast<int4*>(ng + span8); // [n_bits]

    // ---- stage 0: the audio (by TMA where aligned), the basis and the
    // bit offsets ----
    const float* xrow = x + (long long)b * x_stride + t0;
    const bool tma = corr::stage_audio(xs, xrow, x_cnt, &bar, tid, kThreads);
    corr::stage_basis(bs, basis, nb, tid, kThreads);
    // tap k of offset 4u + q sits at offq[k].q + u in the phase-major planes
    for (int k = tid; k < n_bits; k += kThreads) {
        const int bk = bit_begin[k];
        offq[k] = make_int4((bk & 3) * ph + (bk >> 2),
                            ((bk + 1) & 3) * ph + ((bk + 1) >> 2),
                            ((bk + 2) & 3) * ph + ((bk + 2) >> 2),
                            ((bk + 3) & 3) * ph + ((bk + 3) >> 2));
    }
    __syncthreads();
    if (tma) sm90::mbar_wait(&bar, 0);

    // ---- stage 1: correlation -> magnitudes -> ss / ng planes ----
    const int n_task = (s_cnt + kR - 1) / kR;
    for (int task = tid; task < n_task; task += kThreads) {
        const int i0 = task * kR;
        float acc[kR][4];
        corr::correlate8(acc, xs + i0, bs, nb);
        // offsets i0 + q and i0 + 4 + q share phase q: two adjacent words
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            float s0, n0, s1, n1;
            magnitudes(acc[q], scal, s0, n0);
            magnitudes(acc[q + 4], scal, s1, n1);
            const int at = q * ph + i0 / 4;
            *reinterpret_cast<float2*>(ss + at) = make_float2(s0, s1);
            *reinterpret_cast<float2*>(ng + at) = make_float2(n0, n1);
        }
    }
    __syncthreads();

    // ---- stage 2: comb sums (pass 1) and divergence (pass 2), offsets
    // 4u .. 4u + 3 per thread ----
    const float n_bits_f = (float)n_bits;
    const long long plane = (long long)t_len;
    int* orow = out + (long long)b * n_planes * plane + t0;
    const bool vec_ok = (t_len & 3) == 0;
    const int n_u = (n_t + 3) / 4;
    for (int u = tid; u < n_u; u += kThreads) {
        float tsig[4], tnoise[4], msig[4];
        unsigned bits[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            tsig[q] = tnoise[q] = msig[q] = 0.0f;
            bits[q] = 0u;
        }
        for (int k = 0; k < n_bits; ++k) {
            const int4 o = offq[k];
            const int at[4] = {o.x + u, o.y + u, o.z + u, o.w + u};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float v = ss[at[q]];
                const float sb = fabsf(v);
                tsig[q] = __fadd_rn(tsig[q], sb);
                tnoise[q] = __fadd_rn(tnoise[q], ng[at[q]]);
                if (v > 0.0f) {
                    msig[q] = __fadd_rn(msig[q], sb);
                    bits[q] |= 1u << k;
                }
            }
        }
        float avg_mark[4], avg_space[4], div[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float n_mark_f = (float)__popc(bits[q]);  // marks counted
            const float n_space_f = __fsub_rn(n_bits_f, n_mark_f);
            const float space_sig = __fsub_rn(tsig[q], msig[q]);
            // averages guarded like C (reference: src/fsk.c:298-301)
            avg_mark[q] = n_mark_f > 0.0f ? __fdiv_rn(msig[q], n_mark_f) : 0.0f;
            avg_space[q] =
                n_space_f > 0.0f ? __fdiv_rn(space_sig, n_space_f) : 0.0f;
            div[q] = 0.0f;
        }
        for (int k = 0; k < n_bits; ++k) {
            const int4 o = offq[k];
            const int at[4] = {o.x + u, o.y + u, o.z + u, o.w + u};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float v = ss[at[q]];
                const float own = v > 0.0f ? avg_mark[q] : avg_space[q];
                div[q] = __fadd_rn(
                    div[q], __fdiv_rn(fabsf(__fsub_rn(fabsf(v), own)), own));
            }
        }
        int cd[4], ad[4], cs[4], as[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float dv = __fdiv_rn(__fmul_rn(div[q], 2.0f), n_bits_f);
            const float snr = __fdiv_rn(tsig[q], tnoise[q]);  // x/0 = inf
            const float conf = __fmul_rn(snr, __fsub_rn(1.0f, dv));
            const float ampl = __fdiv_rn(tsig[q], n_bits_f);
            const bool ok_d = ((bits[q] ^ d_val) & d_mask) == 0u;
            const bool ok_s = ((bits[q] ^ s_val) & s_mask) == 0u;
            cd[q] = __float_as_int(ok_d ? conf : 0.0f);
            ad[q] = __float_as_int(ok_d ? ampl : 0.0f);
            cs[q] = __float_as_int(ok_s ? conf : 0.0f);
            as[q] = __float_as_int(ok_s ? ampl : 0.0f);
        }
        const int t = 4 * u;
        if (vec_ok && t + 4 <= n_t) {
            *reinterpret_cast<int4*>(orow + t) =
                make_int4(cd[0], cd[1], cd[2], cd[3]);
            *reinterpret_cast<int4*>(orow + plane + t) =
                make_int4(ad[0], ad[1], ad[2], ad[3]);
            *reinterpret_cast<int4*>(orow + 2 * plane + t) =
                make_int4((int)bits[0], (int)bits[1], (int)bits[2],
                          (int)bits[3]);
            if (n_planes == 5) {
                *reinterpret_cast<int4*>(orow + 3 * plane + t) =
                    make_int4(cs[0], cs[1], cs[2], cs[3]);
                *reinterpret_cast<int4*>(orow + 4 * plane + t) =
                    make_int4(as[0], as[1], as[2], as[3]);
            }
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (t + q >= n_t) break;
                orow[t + q] = cd[q];
                orow[plane + t + q] = ad[q];
                orow[2 * plane + t + q] = (int)bits[q];
                if (n_planes == 5) {
                    orow[3 * plane + t + q] = cs[q];
                    orow[4 * plane + t + q] = as[q];
                }
            }
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
    // the phase-major planes need (tile + max_begin) rounded to 8, and the
    // bit mask 32 bits
    if (tile % 8 != 0 || n_bits > 32 || n_bits < 1 || nb < 1)
        return (int)cudaErrorInvalidValue;
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
