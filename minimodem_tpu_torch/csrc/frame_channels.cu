// frame_channels.cu — K5, the frame channels: band magnitudes -> the six
// per-offset frame channels (reference: src/fsk.c:107-174 bit analysis,
// :178-446 frame analysis, CONFIDENCE_ALGO 6).
//
// Replaces the XLA fusion of minimodem_tpu/ops/demod.py::
// score_frame_channels (:215), which jax.jit compiles into the host
// engines' scorer (_build_score_fn, demod.py:299-325) and into the device
// receiver's scorer for the geometries the fused Pallas scorer does not
// take (make_score_packer, device_rx.py:244-309, inside the receiver
// jitted at :998); it has no pallas_call.  The port calls it from
// ops/demod.py::_build_score_fn (DemodScorer, the host engines, the
// fleet's sharded_score_fn) and ops/device_rx.py::make_score_packer (more
// than 32 frame bits, float64 geometries, bit spans past K1's shared
// memory), through ops/frame_channels.py FrameChannels.
//
// In: the stage-1 correlation corr [B, 4, >= n + max_begin], float32 or
// float64, unit column stride, any stream and row stride (the FFT route
// hands over a slice).  Out: for each offset t < n, the channels in the
// order of ops/demod.py CHANNELS (conf_data, conf_sync, ampl_data,
// ampl_sync as float bits, bits_lo, bits_hi) as int32 words at
// out[b * out_b + rows[c] * out_r + t0 + t], for each channel c whose
// row is >= 0: the device packer's plane rows of one tile, or the host
// scorer's [B, 6, t_len].
//
// Two kernels, one C entry:
//   1. magnitudes, one thread per (correlated offset s < n + max_begin,
//      stream): the band magnitudes rounded to float32, the strict bit
//      mark > space, and one float2 per offset in a scratch row: the
//      signal with the bit as its sign (K1 keeps it so) and the noise
//      gated at FLT_EPSILON;
//   2. channels, one thread per (offset t < n, stream): pass 2a (the
//      comb sums, the marks, the frame bits) and pass 2b (the divergence)
//      over the n_bits taps in ascending k, each reading the scratch at
//      t + bit_begin[k]; a warp reads 256 contiguous bytes a tap, and
//      where the taps' windows overlap they re-read lines from L1 and L2.
//
// Exactness: the plain version (ops/demod.py score_frame_channels) is the
// yardstick, matched bit for bit, NaN and inf included.  Every rounding
// is an explicit _rn intrinsic in its order: the float32 magnitude
// sqrt((double)(re*re + im*im)) rounded to float32, times scal; the
// float64 one sqrt(re*re + im*im) * scal in float64, then rounded; the
// sums in ascending k; the guarded averages (reference: src/fsk.c:
// 298-301); |sig - own| / own; div * 2 / n_bits; snr * (1 - div); IEEE
// x/0 = inf and 0/0 = nan for the SNR.  A tap whose bit is 0 adds nothing
// to the mark sum, where the plain version adds +0.0: the same bits, as
// the sum is never -0.
//
// Bound: bytes.  An offset of a uic-train tile (47 frame bits) reads 16
// bytes of correlation and writes 16 of planes, against ~5 float32
// operations a tap (~250): at the HBM rate and the FP32 peak the bytes
// take ~2.7x longer.  The design is the simple one: the magnitudes pass
// streams (one read, one 8-byte write an offset), and the channels pass
// reads the scratch row n_bits times in each pass from the caches, with
// an IEEE division a tap in pass 2b, which exactness keeps.  Measured
// (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 0.333 ms for a
// uic-train tile of 16 x 2^18 offsets against its 0.040 ms bound, and
// 3-4x the bound at 11 taps a bit window apart, whose reads share no
// cache lines.
//
// Built without --use_fast_math and with -fmad=false (ops/_kernels.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBits = 64;               // bits_lo and bits_hi
constexpr int kChannels = 6;
constexpr float kFltEpsilon = 1.1920928955078125e-07f;

struct Rows {
    int r[kChannels];                      // destination row, -1: none
};

// one band's magnitude, rounded to float32 as the plain version rounds it
__device__ __forceinline__ float band_mag(float re, float im, float scal) {
    const float sq = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
    return __fmul_rn(__double2float_rn(__dsqrt_rn((double)sq)), scal);
}

__device__ __forceinline__ float band_mag(double re, double im, float scal) {
    const double sq = __dadd_rn(__dmul_rn(re, re), __dmul_rn(im, im));
    return __double2float_rn(__dmul_rn(__dsqrt_rn(sq), (double)scal));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
magnitudes_kernel(const T* __restrict__ corr, long long corr_b,
                  long long corr_c, int s_cnt, float scal,
                  float2* __restrict__ sn) {
    const int s = blockIdx.x * kThreads + threadIdx.x;
    if (s >= s_cnt) return;
    const int b = blockIdx.y;
    const T* c = corr + (long long)b * corr_b + s;
    const float mm = band_mag(c[0], c[corr_c], scal);
    const float ms = band_mag(c[2 * corr_c], c[3 * corr_c], scal);
    const bool bit = mm > ms;                  // fsk.c:161 strict
    const float sig = bit ? mm : ms;
    const float noise = bit ? ms : mm;
    // mm > ms >= 0 where the bit is set, so the sign carries it
    sn[(long long)b * s_cnt + s] =
        make_float2(bit ? sig : -sig, noise > kFltEpsilon ? noise : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
channels_kernel(const float2* __restrict__ sn, int s_cnt, int n,
                const int* __restrict__ bit_begin, int n_bits,
                unsigned long long d_mask, unsigned long long d_val,
                unsigned long long s_mask, unsigned long long s_val,
                Rows rows, int* __restrict__ out, long long out_b,
                long long out_r, int t0) {
    __shared__ int begin[kMaxBits];
    for (int k = threadIdx.x; k < n_bits; k += kThreads)
        begin[k] = bit_begin[k];
    __syncthreads();
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= n) return;
    const int b = blockIdx.y;
    const float2* row = sn + (long long)b * s_cnt + t;
    const float* sig_row = reinterpret_cast<const float*>(row);

    // ---- pass 2a: comb sums over the frame's bit windows ----
    float tsig = 0.0f, tnoise = 0.0f, msig = 0.0f;
    unsigned long long bits = 0ull;
    for (int k = 0; k < n_bits; ++k) {
        const float2 v = row[begin[k]];
        const float s = fabsf(v.x);
        tsig = __fadd_rn(tsig, s);
        tnoise = __fadd_rn(tnoise, v.y);
        if (v.x > 0.0f) {
            msig = __fadd_rn(msig, s);
            bits |= 1ull << k;
        }
    }
    const float n_bits_f = (float)n_bits;
    const float n_mark_f = (float)__popcll(bits);
    const float n_space_f = __fsub_rn(n_bits_f, n_mark_f);
    const float space_sig = __fsub_rn(tsig, msig);
    // averages guarded like C (reference: src/fsk.c:298-301)
    const float avg_mark = n_mark_f > 0.0f ? __fdiv_rn(msig, n_mark_f) : 0.0f;
    const float avg_space =
        n_space_f > 0.0f ? __fdiv_rn(space_sig, n_space_f) : 0.0f;

    // ---- pass 2b: divergence (CONFIDENCE_ALGO 6) ----
    float div = 0.0f;
    for (int k = 0; k < n_bits; ++k) {
        const float v = sig_row[2 * begin[k]];
        const float own = v > 0.0f ? avg_mark : avg_space;
        div = __fadd_rn(div, __fdiv_rn(fabsf(__fsub_rn(fabsf(v), own)), own));
    }
    const float dv = __fdiv_rn(__fmul_rn(div, 2.0f), n_bits_f);
    const float snr = __fdiv_rn(tsig, tnoise);        // x/0 = inf, 0/0 = nan
    const float conf = __fmul_rn(snr, __fsub_rn(1.0f, dv));
    const float ampl = __fdiv_rn(tsig, n_bits_f);
    // when the frame is rejected the reference leaves ampl at 0
    // (reference: src/fsk.c:211-212)
    const bool ok_d = ((bits ^ d_val) & d_mask) == 0ull;
    const bool ok_s = ((bits ^ s_val) & s_mask) == 0ull;
    const int vals[kChannels] = {
        __float_as_int(ok_d ? conf : 0.0f), __float_as_int(ok_s ? conf : 0.0f),
        __float_as_int(ok_d ? ampl : 0.0f), __float_as_int(ok_s ? ampl : 0.0f),
        (int)(unsigned)bits, (int)(unsigned)(bits >> 32)};
    int* o = out + (long long)b * out_b + t0 + t;
#pragma unroll
    for (int c = 0; c < kChannels; ++c)
        if (rows.r[c] >= 0) o[(long long)rows.r[c] * out_r] = vals[c];
}

}  // namespace

extern "C" int mm_frame_channels(
    const void* corr, int f64, long long corr_b, long long corr_c, int batch,
    int n, const void* bit_begin, int n_bits, int max_begin, float scal,
    unsigned long long d_mask, unsigned long long d_val,
    unsigned long long s_mask, unsigned long long s_val, const int* rows,
    void* scratch, void* out, long long out_b, long long out_r, int t0,
    void* stream) {
    if (n_bits < 1 || n_bits > kMaxBits || n < 0 || max_begin < 0 ||
        batch < 0 || batch > 65535)
        return (int)cudaErrorInvalidValue;
    if (n == 0 || batch == 0) return 0;
    const int s_cnt = n + max_begin;
    Rows r;
    for (int c = 0; c < kChannels; ++c) r.r[c] = rows[c];
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float2* sn = static_cast<float2*>(scratch);
    const dim3 g1((s_cnt + kThreads - 1) / kThreads, batch);
    if (f64)
        magnitudes_kernel<double><<<g1, kThreads, 0, st>>>(
            static_cast<const double*>(corr), corr_b, corr_c, s_cnt, scal, sn);
    else
        magnitudes_kernel<float><<<g1, kThreads, 0, st>>>(
            static_cast<const float*>(corr), corr_b, corr_c, s_cnt, scal, sn);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const dim3 g2((n + kThreads - 1) / kThreads, batch);
    channels_kernel<<<g2, kThreads, 0, st>>>(
        sn, s_cnt, n, static_cast<const int*>(bit_begin), n_bits, d_mask,
        d_val, s_mask, s_val, r, static_cast<int*>(out), out_b, out_r, t0);
    return (int)cudaGetLastError();
}
