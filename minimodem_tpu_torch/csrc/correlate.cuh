// correlate.cuh — the stage-1 correlation that K1 (fused_score.cu) and K3
// (correlate.cu) share: the audio tile staged by TMA, the basis staged as
// [nb8] float4, and a register-blocked scorer of 8 consecutive offsets.
//
//   acc[r][c] = sum_{j < nb} basis[c, j] * xs[r + j],  r < kR
//
// Each thread holds a sliding register window of the audio, so one 16-byte
// broadcast of the basis feeds 32 FMAs and two 16-byte loads of audio feed
// eight taps (~16 FMAs per shared-memory load, against 0.8 for one offset
// a thread).  Each of the four sums is still a chain of __fmaf_rn in
// ascending j — the chain XLA compiles the JAX package's _correlate_direct
// into on the CPU, and the plain version's (ops/demod.py correlate, an
// exact FMA emulation) — so the result matches it bit for bit.  Whole
// blocks of 8 taps run unguarded; only the last nb % 8 taps test j < nb,
// and padding taps are never multiplied (a zero weight would turn an
// infinite sample into NaN).
#pragma once

#include <cstdint>

#include "sm90.cuh"

namespace corr {

constexpr int kR = 8;                 // offsets per thread

__device__ __forceinline__ void load8(float* v, const float* p) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// one tap for kR consecutive offsets: v[r] the sample of offset r, w the
// four basis values of the tap
__device__ __forceinline__ void taps(float (*acc)[4], const float* v,
                                     float4 w) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
        acc[r][0] = __fmaf_rn(w.x, v[r], acc[r][0]);
        acc[r][1] = __fmaf_rn(w.y, v[r], acc[r][1]);
        acc[r][2] = __fmaf_rn(w.z, v[r], acc[r][2]);
        acc[r][3] = __fmaf_rn(w.w, v[r], acc[r][3]);
    }
}

// The correlation of kR consecutive offsets.  xs: 16-byte aligned, read
// at [0, nb8 + 8) with nb8 = nb rounded up to 8 (samples past kR + nb - 2
// are loaded but never multiplied); bs: the basis as [nb8] float4.
__device__ __forceinline__ void correlate8(float (*acc)[4], const float* xs,
                                           const float4* bs, int nb) {
#pragma unroll
    for (int r = 0; r < kR; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.0f;
    float v[2 * kR];              // v[q] = xs[j + q], q < 16
    load8(v, xs);
    int j = 0;
    for (; j + 8 <= nb; j += 8) {                 // whole blocks of 8 taps
        load8(v + 8, xs + j + 8);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) taps(acc, v + jj, bs[j + jj]);
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = v[q + 8];
    }
    if (j < nb) {                                 // the last nb % 8 taps
        load8(v + 8, xs + j + 8);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
            if (j + jj < nb) taps(acc, v + jj, bs[j + jj]);
    }
}

// The basis [4, nb] from global memory into bs [nb8] as one float4 per
// tap, zero past nb, by the CTA's threads.
__device__ __forceinline__ void stage_basis(float4* bs, const float* basis,
                                            int nb, int tid, int nthreads) {
    const int nb8 = (nb + 7) & ~7;
    for (int j = tid; j < nb8; j += nthreads)
        bs[j] = j < nb ? make_float4(basis[j], basis[nb + j],
                                     basis[2 * nb + j], basis[3 * nb + j])
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// x_cnt samples of xrow into xs (16-byte aligned).  Where xrow is 16-byte
// aligned, thread 0 starts a 1-D TMA bulk copy of the 16-byte body on bar
// and the CTA's threads load the last x_cnt % 4 samples; otherwise (an
// odd row stride) they load every sample.  Returns whether a copy is in
// flight: then, after the __syncthreads that follows, each thread waits
// on bar at parity 0 before it reads xs.
__device__ __forceinline__ bool stage_audio(float* xs, const float* xrow,
                                            int x_cnt, uint64_t* bar,
                                            int tid, int nthreads) {
    const bool tma = (reinterpret_cast<uintptr_t>(xrow) & 15u) == 0u &&
                     x_cnt >= 4;
    const int bulk = tma ? (x_cnt & ~3) : 0;
    if (tid == 0 && tma) {
        sm90::mbar_init(bar, 1);
        sm90::mbar_init_fence();
        sm90::mbar_arrive_expect_tx(bar, 4u * bulk);
        sm90::tma_load_1d(xs, xrow, 4u * bulk, bar);
    }
    for (int i = bulk + tid; i < x_cnt; i += nthreads) xs[i] = xrow[i];
    return tma;
}

}  // namespace corr
