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
// One CTA per (run of `run` consecutive tiles of `tile` offsets, stream),
// which walks its run's tiles in order:
//   0. the basis is staged once, interleaved as [nb][4] (one float4 per
//      tap); each tile's audio by a 1-D TMA bulk copy, the first tile's
//      before stage 1, each later tile's while stage 2 of the one before
//      runs;
//   1. the first tile of a run correlates its n_t offsets plus max_begin
//      of halo.  A later tile first moves the (signal, noise) pairs of the
//      previous tile's last `carry` offsets (max_begin rounded up to a
//      task of 8) to the front of its plane, where they are its own first
//      offsets, and correlates only the rest.  An offset's correlation is
//      a function of its nb samples alone, so a pair is the same whichever
//      tile computed it.  Correlation is register-blocked (correlate.cuh,
//      shared with K3): each thread scores kR = 8 consecutive sample
//      offsets, each sum the ascending-j __fmaf_rn chain of the plain
//      version, so the planes match it bit for bit;
//   2. band magnitudes sqrtf(c*c + s*s) * scal (pallas_score.py:228-231),
//      the strict bit mark > space, the signed signal (the sign carries
//      the bit) and the noise gated at FLT_EPSILON, stored as one (signal,
//      noise) pair an offset in a phase-major plane (offset s at (s % 4) *
//      P + s / 4), so that stage 2's reads are conflict-free;
//   3. stage 2: pass 1 (comb sums over the n_bits taps at bit_begin[k])
//      and pass 2 (divergence), each sum in ascending k as before.  The
//      kernel is built for three buckets of bit counts, which the launcher
//      picks by n_bits: <= 8 (four offsets a thread) and 9..16 (one; every
//      preset is in one of the two), where pass 1 unrolls, builds the bits
//      with constant shifts and holds each tap's signed signal in
//      registers for pass 2; 17..32 (four), where pass 2 reads the taps
//      again.  Each tap divides
//      through the reciprocal of its bit's average, hoisted once an
//      offset, by Markstein's step (div_rcp: the correctly rounded
//      quotient, as __fdiv_rn gives it); the averages, dv and ampl divide
//      by a bit count through a table of RN(1 / k).  A per-offset guard
//      takes the IEEE division where a value lies outside the step's
//      window (silence, overflow, NaN).
//
// Bound: 4 * nb FMAs per scored offset (Bell-202 at 48 kHz: 160, ~0.67 GFLOP
// per 2^21-sample segment, 10 us at the FP32 peak) against ~16 bytes of device
// memory per offset (33.6 MB, 10 us at the HBM rate). The register blocking of
// stage 1 cuts shared-memory traffic per FMA by ~6x, whole blocks of 8 taps
// run unguarded (only the last nb % 8 taps test j < nb), and the tile
// (ops/fused_score.py pick_tile: at least 8 * max_begin, 4096 for Bell-202)
// keeps CTAs of ~55 KB 4 to an SM.  A run of tiles (ops/fused_score.py
// pick_run: as long as the grid keeps its waves of CTAs) pays the halo once
// a run instead of once a tile: RTTY's 7,392-offset halo over a 4096 tile
// made each CTA correlate 2.80 offsets a scored one, runs of 23 tiles at
// skimmer32's shape 1.08 (K1 queued 57.23 → 23.70 ms; alerts128's 15.15 →
// 12.63, runs of 34 with SAME's bucket at 3 CTAs an SM; scripts/k1_ab.py,
// NVIDIA H100 80GB HBM3, 700.00 W). What bounds K1 is
// the issue rate of its instructions: ~4.4 a tap and offset in stage 1's loop
// (scripts/k1_ab.py census) and, before the step, stage 2's two tap loops of
// 107 and 183 instructions a pair of taps for four offsets, 8 MUFU reciprocals
// behind __fdiv_rn's range checks in the second: 16 an offset with the
// averages and the epilogue. At the headline loopback buffer [128, 3146168]
// (scripts/k1_ab.py; NVIDIA H100 80GB HBM3, 700.00 W) K1 took 11.75 ms alone
// and 11.73 ms queued; stage 1 with the planes' store alone 4.98 ms, so stage
// 2 took ~6.75 ms (58%), its IEEE divisions ~3.56 ms (each a multiply: 8.17
// ms). With the step and the held taps: 9.08 ms alone, 9.07 ms queued, stage 2
// ~4.33 ms (48%); Bell-202's kernel at 63 registers before and after, 4 CTAs
// an SM; 3 MUFU operations an offset in stage 2 (two reciprocals, the SNR's
// division); 1.04% of the buffer's offsets (the silent tails past each stream)
// take the IEEE division. One offset a thread suits Bell-202 (two: 107
// registers, 2 CTAs an SM, 10.78 ms against 9.43 in one call) and four RTTY,
// alone on its SM at 121 registers (57.22 ms at skimmer32's shape against one
// offset's 59.46 and 57.75 before).
//
// Built without --use_fast_math: the SNR relies on IEEE x/0 = inf and
// 0/0 = nan (pallas_score.py:377), and sqrtf / division must round
// correctly for the planes to match the plain version.

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#include "correlate.cuh"

namespace {

using corr::kR;

constexpr int kThreads = 256;
constexpr float kFltEpsilon = 1.1920928955078125e-07f;
// The window of Markstein's step (div_rcp): every divisor of a tap lies in
// it, and every numerator of a division by a bit count is 0 or lies in it
// (tests/test_torch_fused_score_div.py holds the step to __fdiv_rn there).
constexpr float kRcpLo = 0x1p-60f;
constexpr float kRcpHi = 0x1p+60f;

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

__device__ __forceinline__ bool in_window(float x) {
    return x >= kRcpLo && x <= kRcpHi;       // false for NaN
}

// a / b as __fdiv_rn rounds it, from y = RN(1 / b): q = RN(a y) lies within
// an ulp of a / b, r = a - q b is exact, and RN(q + r y) is the correctly
// rounded quotient (Markstein's theorem), as long as no step under- or
// overflows, which the callers' windows ensure.  Three FP32 operations in
// place of __fdiv_rn's reciprocal, refinement, range check and branch.
__device__ __forceinline__ float div_rcp(float a, float b, float y) {
    const float q = __fmul_rn(a, y);
    return __fmaf_rn(__fmaf_rn(-q, b, a), y, q);
}

// a / k for a bit count k in [1, 32] and y = RN(1 / k): the step where a is
// 0 or in the window, else the IEEE division
__device__ __forceinline__ float div_count(float a, float k, float y) {
    return a == 0.0f || in_window(a) ? div_rcp(a, k, y) : __fdiv_rn(a, k);
}

// one offset's comb sums (pass 1), each in ascending k
struct Comb {
    float tsig, tnoise, msig;
    unsigned bits;
};

__device__ __forceinline__ void comb_tap(Comb& c, float2 sn, int k) {
    const float sb = fabsf(sn.x);
    c.tsig = __fadd_rn(c.tsig, sb);
    c.tnoise = __fadd_rn(c.tnoise, sn.y);
    if (sn.x > 0.0f) {
        c.msig = __fadd_rn(c.msig, sb);
        c.bits |= 1u << k;
    }
}

// one offset's averages (guarded like C, reference: src/fsk.c:298-301),
// their reciprocals, and whether each of its taps may divide through them:
// every |v| <= tsig <= kRcpHi and each average a tap divides by in the
// window.  Then a tap's numerator ||v| - own| is 0 or at least own 2^-25
// (Sterbenz where |v| is within a factor 2 of own), so no step under- or
// overflows.
struct Own {
    float mark, space, y_mark, y_space;
    bool fast;
};

__device__ __forceinline__ Own averages(const Comb& c, int n_bits,
                                        float n_bits_f, const float* rcp_n) {
    const int n_mark = __popc(c.bits);
    const float n_mark_f = (float)n_mark;
    const float n_space_f = __fsub_rn(n_bits_f, n_mark_f);
    const float space_sig = __fsub_rn(c.tsig, c.msig);
    Own o;
    o.mark = n_mark_f > 0.0f ? div_count(c.msig, n_mark_f, rcp_n[n_mark])
                             : 0.0f;
    o.space = n_space_f > 0.0f
                  ? div_count(space_sig, n_space_f, rcp_n[n_bits - n_mark])
                  : 0.0f;
    const bool mark_ok = in_window(o.mark), space_ok = in_window(o.space);
    o.fast = c.tsig <= kRcpHi && (n_mark == 0 || mark_ok) &&
             (n_mark == n_bits || space_ok);
    o.y_mark = __frcp_rn(mark_ok ? o.mark : 1.0f);
    o.y_space = __frcp_rn(space_ok ? o.space : 1.0f);
    return o;
}

// one tap's divergence term |(|v| - own)| / own, own the average of the
// tap's bit (v > 0: mark); kFast: through the hoisted reciprocal
template <bool kFast>
__device__ __forceinline__ float tap_div(float v, const Own& o) {
    const bool mark = v > 0.0f;
    const float own = mark ? o.mark : o.space;
    const float a = fabsf(__fsub_rn(fabsf(v), own));
    if constexpr (kFast)
        return div_rcp(a, own, mark ? o.y_mark : o.y_space);
    else
        return __fdiv_rn(a, own);
}

// kQ consecutive int32 words at p (p aligned to them)
template <int kQ>
__device__ __forceinline__ void store_q(int* p, const int* v) {
    if constexpr (kQ == 4)
        *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
    else if constexpr (kQ == 2)
        *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
    else
        *p = v[0];
}

// Stage 2 over the CTA's n_t offsets, kQ consecutive offsets a thread: the
// warps of a step take 32 consecutive quads u and the same kQ phases g kQ
// .. g kQ + kQ - 1 of them, offsets t = 4u + g kQ + j, so a warp's reads
// of the phase-major plane sn (signed signal, gated noise) stay
// conflict-free; tap k of offset 4u + q sits at sn[offq[k].q + u].
// kHold: frame bits kMinBits..kMaxBits, pass 1 unrolled, each tap's
// signed signal held in registers for pass 2; otherwise (up to 32 bits)
// pass 2 reads the taps again from sn.
template <int kMinBits, int kMaxBits, int kQ, bool kHold>
__device__ __forceinline__ void stage2(
    const float2* sn, const int4* offq, const float* rcp_n, int n_bits,
    int n_t, int tid, int* orow, long long plane, bool vec_ok,
    unsigned d_mask, unsigned d_val, unsigned s_mask, unsigned s_val,
    int n_planes) {
    constexpr int kG = 4 / kQ;                    // thread groups a quad
    const float n_bits_f = (float)n_bits;
    const float y_nb = rcp_n[n_bits];             // RN(1 / n_bits)
    const int n_w = (n_t + 127) / 128 * 32 * kG;
    for (int w = tid; w < n_w; w += kThreads) {
        const int g = (w >> 5) % kG;
        const int u = w / (32 * kG) * 32 + (w & 31);
        const int t = 4 * u + g * kQ;             // the thread's first offset
        if (t >= n_t) continue;
        const float2* su = sn + u;
        const int* og = reinterpret_cast<const int*>(offq) + g * kQ;
        Comb c[kQ];
#pragma unroll
        for (int j = 0; j < kQ; ++j) c[j] = Comb{0.0f, 0.0f, 0.0f, 0u};
        // held taps (signed); zero past n_bits, so that no tap a pass
        // skips carries a value round the tile loop, across stage 1
        float v[kHold ? kMaxBits : 1][kQ] = {};
        if constexpr (kHold) {
#pragma unroll
            for (int k = 0; k < kMaxBits; ++k) {
                if (k < kMinBits || k < n_bits) {
#pragma unroll
                    for (int j = 0; j < kQ; ++j) {
                        const float2 p = su[og[4 * k + j]];
                        v[k][j] = p.x;
                        comb_tap(c[j], p, k);
                    }
                }
            }
        } else {
            for (int k = 0; k < n_bits; ++k) {
#pragma unroll
                for (int j = 0; j < kQ; ++j)
                    comb_tap(c[j], su[og[4 * k + j]], k);
            }
        }
        Own o[kQ];
        bool fast = true;
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
            o[j] = averages(c[j], n_bits, n_bits_f, rcp_n);
            fast = fast && o[j].fast;
        }
        // pass 2: divergence (reference CONFIDENCE_ALGO 6), ascending k
        float div[kQ];
#pragma unroll
        for (int j = 0; j < kQ; ++j) div[j] = 0.0f;
        auto pass2 = [&](auto fast_tag) {
            constexpr bool kFast = decltype(fast_tag)::value;
            if constexpr (kHold) {
#pragma unroll
                for (int k = 0; k < kMaxBits; ++k) {
                    if (k < kMinBits || k < n_bits) {
#pragma unroll
                        for (int j = 0; j < kQ; ++j)
                            div[j] = __fadd_rn(div[j],
                                               tap_div<kFast>(v[k][j], o[j]));
                    }
                }
            } else {
                for (int k = 0; k < n_bits; ++k) {
#pragma unroll
                    for (int j = 0; j < kQ; ++j)
                        div[j] = __fadd_rn(
                            div[j], tap_div<kFast>(su[og[4 * k + j]].x, o[j]));
                }
            }
        };
        if (fast)
            pass2(std::true_type{});
        else
            pass2(std::false_type{});
        int cd[kQ], ad[kQ], bw[kQ], cs[kQ], as[kQ];
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
            const float dv =
                div_count(__fmul_rn(div[j], 2.0f), n_bits_f, y_nb);
            const float snr = __fdiv_rn(c[j].tsig, c[j].tnoise);  // x/0 = inf
            const float conf = __fmul_rn(snr, __fsub_rn(1.0f, dv));
            const float ampl = div_count(c[j].tsig, n_bits_f, y_nb);
            const bool ok_d = ((c[j].bits ^ d_val) & d_mask) == 0u;
            const bool ok_s = ((c[j].bits ^ s_val) & s_mask) == 0u;
            cd[j] = __float_as_int(ok_d ? conf : 0.0f);
            ad[j] = __float_as_int(ok_d ? ampl : 0.0f);
            bw[j] = (int)c[j].bits;
            cs[j] = __float_as_int(ok_s ? conf : 0.0f);
            as[j] = __float_as_int(ok_s ? ampl : 0.0f);
        }
        if (vec_ok && t + kQ <= n_t) {
            store_q<kQ>(orow + t, cd);
            store_q<kQ>(orow + plane + t, ad);
            store_q<kQ>(orow + 2 * plane + t, bw);
            if (n_planes == 5) {
                store_q<kQ>(orow + 3 * plane + t, cs);
                store_q<kQ>(orow + 4 * plane + t, as);
            }
        } else {
#pragma unroll
            for (int j = 0; j < kQ; ++j) {
                if (t + j >= n_t) break;
                orow[t + j] = cd[j];
                orow[plane + t + j] = ad[j];
                orow[2 * plane + t + j] = bw[j];
                if (n_planes == 5) {
                    orow[3 * plane + t + j] = cs[j];
                    orow[4 * plane + t + j] = as[j];
                }
            }
        }
    }
}

// The samples of the tile at t0 that stage 1 reads from its offset a on:
// those of its offsets up to n_t + max_begin rounded up to a task of 8,
// as far as the row's t_len + max_begin + nb - 1 samples hold them.  So
// the rounded offsets past the halo hold their true pairs too wherever
// the next tile reads them (each offset it scores lies before the row's
// end), and a carry of max_begin rounded up to 8 leaves every later full
// tile exactly tile / 8 tasks.
__device__ __forceinline__ int tile_samples(int t0, int t_len, int tile,
                                            int max_begin, int nb, int a) {
    const int n_t = min(tile, t_len - t0);
    const int s_cnt = min((n_t + max_begin + 7) & ~7, t_len - t0 + max_begin);
    return max(s_cnt - a + nb - 1, 0);
}

// The audio of one tile, x_cnt samples of xrow into xs (16-byte aligned).
// tma: xrow is 16-byte aligned (for every tile of a row or for none, a
// tile's first sample lying a multiple of 8 past the row's); then thread 0
// completes a phase of bar with a 1-D TMA bulk copy of the 16-byte body (an
// arrival alone where the body is empty), after a proxy fence that orders
// the threads' earlier reads of xs before it, and the CTA's threads load
// the rest.  Each thread waits on bar at the phase's parity, after a
// __syncthreads, before it reads xs.
__device__ __forceinline__ void stage_tile_audio(float* xs,
                                                 const float* xrow,
                                                 int x_cnt, uint64_t* bar,
                                                 bool tma, int tid) {
    const int bulk = tma ? (x_cnt & ~3) : 0;
    if (tid == 0 && tma) {
        sm90::fence_proxy_async();
        sm90::mbar_arrive_expect_tx(bar, 4u * bulk);
        if (bulk) sm90::tma_load_1d(xs, xrow, 4u * bulk, bar);
    }
    for (int i = bulk + tid; i < x_cnt; i += kThreads) xs[i] = xrow[i];
}

// The (signal, noise) pairs of the previous tile's last `carry` offsets
// (local tile .. tile + carry - 1) to the front of the plane (local 0 ..
// carry - 1), where this tile's first offsets sit.  tile is a multiple of
// 8, so an offset keeps its phase and each phase's segment shifts a run of
// carry / 4 pairs down by tile / 4, two pairs a 16-byte word, in rounds of
// at most tile / 4 pairs so that no round writes what it or a later round
// reads; each round starts with a __syncthreads (the first: stage 2 of the
// previous tile has read the plane).
__device__ __forceinline__ void carry_halo(float2* sn, int ph, int tile,
                                           int carry, int tid) {
    float4* w = reinterpret_cast<float4*>(sn);
    const int ph2 = ph / 2, step = tile / 8, n = carry / 8;
    for (int r0 = 0; r0 < n; r0 += step) {
        __syncthreads();
        const int m = min(step, n - r0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            float4* seg = w + q * ph2 + r0;
            for (int i = tid; i < m; i += kThreads) seg[i] = seg[i + step];
        }
    }
}

// The CTAs an SM holds in each bucket, which bound its registers: up to 8
// frame bits, 3 (SAME's 59 KB CTA at 80 registers, where 2 at ~104 took
// 5% longer at alerts128's shape; RTTY's CTA is alone on its SM by its
// shared memory); 9..16, 4 (Bell-202's 55 KB CTA at 64); past 16, 3.
constexpr int bucket_ctas(int max_bits) {
    return max_bits <= 8 ? 3 : max_bits <= 16 ? 4 : 3;
}

template <int kMinBits, int kMaxBits, int kQ, bool kHold>
__global__ void __launch_bounds__(kThreads, bucket_ctas(kMaxBits))
fused_score_kernel(const float* __restrict__ x, long long x_stride,
                   int t_len, const float* __restrict__ basis, int nb,
                   const int* __restrict__ bit_begin, int n_bits,
                   int max_begin, float scal, unsigned d_mask,
                   unsigned d_val, unsigned s_mask, unsigned s_val,
                   int n_planes, int tile, int run, int* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    __shared__ uint64_t bar;
    __shared__ float rcp_n[33];                   // RN(1 / k), k <= 32
    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int k0 = blockIdx.x * run;              // the run's first tile
    const int k_end = min(k0 + run, (t_len + tile - 1) / tile);
    // the offsets a later tile of the run takes over from the one before:
    // the halo rounded up to whole tasks, so stage 1's stay aligned
    const int carry = (max_begin + kR - 1) & ~(kR - 1);
    const int nb8 = (nb + 7) & ~7;
    const int span8 = (tile + max_begin + 7) & ~7;
    const int ph = span8 / 4;                     // phase-major plane stride

    float4* bs = reinterpret_cast<float4*>(smem);     // [nb8] basis taps
    float* xs = smem + 4 * nb8;                       // [span8 + nb8] audio
    float2* sn = reinterpret_cast<float2*>(xs + span8 + nb8);  // [span8]
    int4* offq = reinterpret_cast<int4*>(sn + span8); // [n_bits]

    // ---- stage 0: the first tile's audio (by TMA where aligned), the
    // basis, the bit offsets and the reciprocals of the bit counts ----
    const float* xrow = x + (long long)b * x_stride;
    const bool tma = (reinterpret_cast<uintptr_t>(xrow) & 15u) == 0u;
    if (tid == 0 && tma) {
        sm90::mbar_init(&bar, 1);
        sm90::mbar_init_fence();
    }
    stage_tile_audio(xs, xrow + (long long)k0 * tile,
                     tile_samples(k0 * tile, t_len, tile, max_begin, nb, 0),
                     &bar, tma, tid);
    corr::stage_basis(bs, basis, nb, tid, kThreads);
    // tap k of offset 4u + q sits at offq[k].q + u in the phase-major plane
    for (int k = tid; k < n_bits; k += kThreads) {
        const int bk = bit_begin[k];
        offq[k] = make_int4((bk & 3) * ph + (bk >> 2),
                            ((bk + 1) & 3) * ph + ((bk + 1) >> 2),
                            ((bk + 2) & 3) * ph + ((bk + 2) >> 2),
                            ((bk + 3) & 3) * ph + ((bk + 3) >> 2));
    }
    if (tid <= 32) rcp_n[tid] = tid ? __frcp_rn((float)tid) : 0.0f;

    for (int k = k0; k < k_end; ++k) {
        const int t0 = k * tile;
        const int n_t = min(tile, t_len - t0);    // offsets this tile scores
        // offsets taken over from the previous tile; xs holds the audio
        // from offset a on
        const int a = k == k0 ? 0 : carry;
        if (a) carry_halo(sn, ph, tile, carry, tid);
        __syncthreads();
        if (tma) sm90::mbar_wait(&bar, (k - k0) & 1);

        // ---- stage 1: correlation -> magnitudes -> (signal, noise)
        // plane, for offsets a .. n_t + max_begin ----
        const int n_task = (n_t + max_begin + kR - 1) / kR;
        for (int task = a / kR + tid; task < n_task; task += kThreads) {
            const int i0 = task * kR;
            float acc[kR][4];
            corr::correlate8(acc, xs + (i0 - a), bs, nb);
            // offsets i0 + q and i0 + 4 + q share phase q: adjacent pairs
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                float s0, n0, s1, n1;
                magnitudes(acc[q], scal, s0, n0);
                magnitudes(acc[q + 4], scal, s1, n1);
                *reinterpret_cast<float4*>(sn + q * ph + i0 / 4) =
                    make_float4(s0, n0, s1, n1);
            }
        }
        __syncthreads();
        // the next tile's audio past its carry, while stage 2 runs
        if (k + 1 < k_end)
            stage_tile_audio(
                xs, xrow + (long long)(t0 + tile + carry),
                tile_samples(t0 + tile, t_len, tile, max_begin, nb, carry),
                &bar, tma, tid);

        // ---- stage 2: comb sums (pass 1) and divergence (pass 2) ----
        const long long plane = (long long)t_len;
        stage2<kMinBits, kMaxBits, kQ, kHold>(
            sn, offq, rcp_n, n_bits, n_t, tid,
            out + (long long)b * n_planes * plane + t0, plane,
            (t_len & 3) == 0, d_mask, d_val, s_mask, s_val, n_planes);
    }
}

// a stage-2 bucket (mm_fused_score): its kernel
template <int kMinBits, int kMaxBits, int kQ, bool kHold>
struct Bucket {
    static auto kernel() {
        return fused_score_kernel<kMinBits, kMaxBits, kQ, kHold>;
    }
};

// stage 2's bucket by the frame's bit count (ops/fused_score.py REG_BITS):
// each offset's taps held in registers up to 16 bits; four offsets a
// thread up to 8 (RTTY's 159 KB CTA sits alone on an SM and wants the
// parallelism) and past 16, one from 9 to 16 (Bell-202's 55 KB CTAs sit 4
// to an SM at its 64 registers); bucket_ctas bounds each one's registers
template <class F>
int by_bucket(int n_bits, F&& f) {
    if (n_bits <= 8) return f(Bucket<1, 8, 4, true>{});
    if (n_bits <= 16) return f(Bucket<9, 16, 1, true>{});
    return f(Bucket<17, 32, 4, false>{});
}

// the dynamic shared memory a CTA of the kernel may take
template <class K>
cudaError_t allow_smem(K kernel, int smem_bytes) {
    if (smem_bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

}  // namespace

extern "C" int mm_fused_score(const void* x, long long x_stride, int batch,
                              int t_len, const void* basis, int nb,
                              const void* bit_begin, int n_bits,
                              int max_begin, float scal, unsigned d_mask,
                              unsigned d_val, unsigned s_mask,
                              unsigned s_val, int n_planes, int tile,
                              int run, int smem_bytes, void* out,
                              void* stream) {
    // the phase-major planes need (tile + max_begin) rounded to 8, and the
    // bit mask 32 bits
    if (tile % 8 != 0 || n_bits > 32 || n_bits < 1 || nb < 1 || run < 1)
        return (int)cudaErrorInvalidValue;
    return by_bucket(n_bits, [&](auto bucket) {
        const auto kernel = decltype(bucket)::kernel();
        cudaError_t e = allow_smem(kernel, smem_bytes);
        if (e != cudaSuccess) return (int)e;
        const int n_tiles = (t_len + tile - 1) / tile;
        dim3 grid((n_tiles + run - 1) / run, batch);
        kernel<<<grid, kThreads, smem_bytes,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(x), x_stride, t_len,
            static_cast<const float*>(basis), nb,
            static_cast<const int*>(bit_begin), n_bits, max_begin, scal,
            d_mask, d_val, s_mask, s_val, n_planes, tile, run,
            static_cast<int*>(out));
        return (int)cudaGetLastError();
    });
}

// The CTAs of K1's kernel for n_bits frame bits that one SM holds at
// smem_bytes of dynamic shared memory, into *ctas.
extern "C" int mm_fused_score_ctas(int n_bits, int smem_bytes, int* ctas) {
    if (n_bits > 32 || n_bits < 1) return (int)cudaErrorInvalidValue;
    return by_bucket(n_bits, [&](auto bucket) {
        const auto kernel = decltype(bucket)::kernel();
        cudaError_t e = allow_smem(kernel, smem_bytes);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                ctas, kernel, kThreads, smem_bytes);
        return (int)e;
    });
}
