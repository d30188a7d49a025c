// mega_rx.cu — K2, the carrier state machine as one kernel.
//
// Replaces minimodem_tpu/ops/pallas_rx.py::build_mega_rx, the Pallas
// megakernel.  Each stream's receive loop (reference:
// src/minimodem.c:1137-1463, src/fsk.c:449-538) runs in one thread over
// the score planes K1 wrote (csrc/fused_score.cu):
//   - the center-out coarse frame search with early exit at the search
//     limit and strict-improvement ties (earliest tried candidate wins);
//   - the fine rescan on acquisition or confidence drop;
//   - the confidence and amplitude squelch, the 20-scan carrier drop;
//   - f32 tracking and stats in reference order: track = (track+ampl)/2,
//     conf_total +=, ampl_total += (pallas_rx.py:664-668);
//   - the compact byte decode and the event records
//     (pallas_rx.py:547-580, :676-723);
//   - carry in and out, and the final NOCARRIER flush (:1073-1088).
// The scalar skeleton is native/hostrx.cpp::mm_hostrx_run.  Reads at or
// past the scored length never improve a search, like the zero-signal
// scores the TPU kernel reads there.  The event and byte bounds and the
// loop condition are the TPU kernel's: max_events (:287), b_cap (:292),
// n_ev < max_events - 2 (:733).
//
// Bound: latency, not bandwidth or FLOPs.  Each decoded frame is a short
// chain of dependent reads (the coarse candidates' confidences, then the
// winner's amplitude and bits) from the planes, which K1 has just left
// in the 50 MB L2.  The design issues every candidate's confidence load
// of a search at once, before the sequential early-exit replay, so a
// frame costs about two L2 round trips.  Streams are independent, one
// thread each; a batch fills the card with more threads.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMax = 16;              // candidate table width (mega_rx.py)
constexpr int kMaxNoConfidence = 20;  // reference: src/minimodem.c:1290
constexpr int kEvCarrier = 1;
constexpr int kEvNoCarrier = 2;

}  // namespace

extern "C" {

struct MegaParams {
    int batch, n_planes, t_scored, expect_nsamples, frame_nsamples,
        overscan, try_max0, try_max1, coarse_step0, coarse_step1,
        max_events, b_cap, rx_one, finalize, n_data_bits, data_shift,
        msb_first, sync_ok, sync_byte, dual;
    float conf_threshold, conf_search_limit;
    int cand_c[2][kMax];
    int cand_f[2][kMax];
};

}  // extern "C"

namespace {

struct Found {
    float c, a;
    unsigned blo;
    int t;
};

// fsk_find_frame replay: candidates in table order (-1 ends the table),
// strict improvement from 0, stop at the first running best >= limit.
__device__ Found find_frame(const float* __restrict__ conf,
                            const float* __restrict__ ampl,
                            const int* __restrict__ bits, int t_scored,
                            int pos, const int* cand, float limit) {
    float cv[kMax];
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
        const int t = cand[k];
        const long long idx = (long long)pos + t;
        cv[k] = (t >= 0 && idx >= 0 && idx < t_scored) ? __ldcg(conf + idx)
                                                       : 0.0f;
    }
    float best = 0.0f;
    int bk = -1;
#pragma unroll
    for (int k = 0; k < kMax; ++k) {
        if (cand[k] < 0) break;
        if (best < cv[k]) {               // NaN never improves
            best = cv[k];
            bk = k;
            if (best >= limit) break;
        }
    }
    Found f{0.0f, 0.0f, 0u, 0};
    if (bk >= 0) {
        const long long idx = (long long)pos + cand[bk];
        f.c = best;
        f.a = __ldcg(ampl + idx);
        f.blo = (unsigned)__ldcg(bits + idx);
        f.t = cand[bk];
    }
    return f;
}

__device__ inline void store_event(int* rec, int p0, int p1, int p2, int p3,
                                   int p4, int type) {
    rec[0] = p0; rec[1] = p1; rec[2] = p2; rec[3] = p3;
    rec[4] = p4; rec[5] = 0; rec[6] = type; rec[7] = 0;
}

__global__ void mega_rx_kernel(MegaParams p, const int* __restrict__ planes,
                               const int* __restrict__ totals,
                               const int* __restrict__ carry_i,
                               const float* __restrict__ carry_f,
                               int* __restrict__ ev, int* __restrict__ n_ev_out,
                               unsigned char* __restrict__ bytes,
                               int* __restrict__ n_by_out,
                               int* __restrict__ ci_out,
                               float* __restrict__ cf_out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= p.batch) return;
    const long long T = p.t_scored;
    const int* row = planes + (long long)b * p.n_planes * T;
    const float* cd = reinterpret_cast<const float*>(row);
    const float* ad = reinterpret_cast<const float*>(row + T);
    const int* bl = row + 2 * T;
    const float* cs = p.dual ? reinterpret_cast<const float*>(row + 3 * T) : cd;
    const float* as = p.dual ? reinterpret_cast<const float*>(row + 4 * T) : ad;
    int* evb = ev + (long long)b * p.max_events * 8;
    unsigned char* byb = bytes + (long long)b * p.b_cap;

    const int total = totals[b];
    int pos = carry_i[b * 8 + 0];
    int carrier = carry_i[b * 8 + 1];
    int noconf = carry_i[b * 8 + 2];
    int nframes = carry_i[b * 8 + 3];
    int carrier_ns = carry_i[b * 8 + 4];
    int stop = carry_i[b * 8 + 5];
    float track = carry_f[b * 4 + 0];
    float peak = carry_f[b * 4 + 1];
    float conf_tot = carry_f[b * 4 + 2];
    float ampl_tot = carry_f[b * 4 + 3];
    int n_ev = 0, n_by = 0;
    const float thr = p.conf_threshold;
    const float inf = __int_as_float(0x7f800000);
    const unsigned data_mask = (1u << p.n_data_bits) - 1u;

    while (stop == 0 && pos + p.expect_nsamples <= total &&
           n_ev < p.max_events - 2) {
        const int cw = carrier;
        Found f = find_frame(cw ? cd : cs, cw ? ad : as, bl, (int)T, pos,
                             p.cand_c[cw], p.conf_search_limit);
        float c = f.c, a = f.a;
        unsigned blo = f.blo;
        int fs = f.t;
        const bool refine = c < __fmul_rn(peak, 0.75f);
        if (refine) peak = 0.0f;
        if (a < __fmul_rn(track, 0.25f)) c = 0.0f;
        const bool got = !(c <= thr);
        noconf = got ? 0 : noconf + 1;
        const bool drop = !got && noconf > kMaxNoConfidence;
        const bool drop_report = drop && cw == 1;
        const bool acquired = got && cw == 0;
        const int fs_coarse = fs;
        const int try_step = cw ? p.coarse_step1 : p.coarse_step0;
        if (got && (refine || acquired) && c < inf && try_step > 1) {
            // fine rescan: same window, data expect, no early exit
            Found f2 = find_frame(cd, ad, bl, (int)T, pos, p.cand_f[cw], inf);
            if (f2.c > c) {           // confidence itself is not updated
                a = f2.a;
                blo = f2.blo;
                fs = f2.t;
            }
        }
        int advance;
        if (got) {
            carrier_ns += p.frame_nsamples + (cw ? fs_coarse - p.overscan : 0);
            track = __fdiv_rn(__fadd_rn(track, a), 2.0f);
            if (peak < c) peak = c;
            conf_tot = __fadd_rn(conf_tot, c);
            ampl_tot = __fadd_rn(ampl_tot, a);
            ++nframes;
            advance = fs + p.frame_nsamples - p.overscan;
        } else {
            advance = cw ? p.try_max1 : p.try_max0;
        }
        if (drop_report) {
            store_event(evb + n_ev * 8, nframes, __float_as_int(conf_tot),
                        __float_as_int(ampl_tot), carrier_ns, n_by,
                        kEvNoCarrier);
            ++n_ev;
        } else if (acquired) {
            store_event(evb + n_ev * 8, n_by, 0, 0, 0, 0, kEvCarrier);
            ++n_ev;
        }
        if (got) {
            // frame bits -> data byte (minimodem.c:1414-1439)
            unsigned word = (blo >> p.data_shift) & data_mask;
            if (p.msb_first) {
                unsigned rev = 0u;
                for (int k = 0; k < p.n_data_bits; ++k)
                    rev |= ((word >> k) & 1u) << (p.n_data_bits - 1 - k);
                word = rev;
            }
            if (!(p.sync_ok && word == (unsigned)p.sync_byte)) {
                if (n_by < p.b_cap) byb[n_by] = (unsigned char)word;
                ++n_by;               // the host raises past b_cap
            }
        }
        pos += advance;
        carrier = got ? 1 : (drop ? 0 : cw);
        if (drop_report) {
            track = conf_tot = ampl_tot = 0.0f;
            nframes = carrier_ns = 0;
            if (p.rx_one) stop = 1;
        }
    }

    // carry-out = loop-exit state (before the final flush)
    int* co = ci_out + b * 8;
    co[0] = pos; co[1] = carrier; co[2] = noconf; co[3] = nframes;
    co[4] = carrier_ns; co[5] = stop; co[6] = 0; co[7] = 0;
    float* fo = cf_out + b * 4;
    fo[0] = track; fo[1] = peak; fo[2] = conf_tot; fo[3] = ampl_tot;
    if (p.finalize && carrier) {
        store_event(evb + n_ev * 8, nframes, __float_as_int(conf_tot),
                    __float_as_int(ampl_tot), carrier_ns, n_by, kEvNoCarrier);
        ++n_ev;
    }
    n_ev_out[b] = n_ev;
    n_by_out[b] = n_by;
}

}  // namespace

extern "C" int mm_mega_rx(const void* params, const void* planes,
                          const void* totals, const void* carry_i,
                          const void* carry_f, void* ev, void* n_ev,
                          void* bytes, void* n_bytes, void* ci_out,
                          void* cf_out, void* stream) {
    const MegaParams p = *static_cast<const MegaParams*>(params);
    const int threads = p.batch < 32 ? p.batch : 32;
    const int blocks = (p.batch + threads - 1) / threads;
    mega_rx_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const int*>(planes), static_cast<const int*>(totals),
        static_cast<const int*>(carry_i), static_cast<const float*>(carry_f),
        static_cast<int*>(ev), static_cast<int*>(n_ev),
        static_cast<unsigned char*>(bytes), static_cast<int*>(n_bytes),
        static_cast<int*>(ci_out), static_cast<float*>(cf_out));
    return (int)cudaGetLastError();
}
