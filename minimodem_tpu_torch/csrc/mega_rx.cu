// mega_rx.cu — K2, the carrier state machine as one kernel.
//
// Replaces minimodem_tpu/ops/pallas_rx.py::build_mega_rx, the Pallas
// megakernel.  Each stream's receive loop (reference:
// src/minimodem.c:1137-1463, src/fsk.c:449-538) runs in one CTA over the
// score planes K1 wrote (csrc/fused_score.cu):
//   - the center-out coarse frame search with early exit at the search
//     limit and strict-improvement ties (earliest tried candidate wins);
//   - the fine rescan on acquisition or confidence drop;
//   - the confidence and amplitude squelch, the 20-scan carrier drop;
//   - f32 tracking and stats in reference order: track = (track+ampl)/2,
//     conf_total +=, ampl_total += (pallas_rx.py:664-668);
//   - the compact byte decode and the event records
//     (pallas_rx.py:547-580, :676-723);
//   - carry in and out, and the final NOCARRIER flush (:1073-1088).
// It serves as well the modes of the JAX package's XLA receiver
// (minimodem_tpu/ops/device_rx.py::_build_device_rx): wide records, one
// per frame with its raw bits, the high word from a bits_hi plane for
// frames of more than 32 bits (:779-802), and a stream that stops at every
// no-confidence overflow with each record's scan position (:822-827).
// The scalar skeleton is native/hostrx.cpp::mm_hostrx_run.  The event and
// byte bounds (max_events, b_cap) are those of the JAX route that serves
// the geometry (ops/mega_rx.py MegaStatics), and the loop runs while
// n_ev < max_events - 2, as both JAX routes do.
//
// Bound: a chain of dependent decisions, not bytes or FLOPs.  A frame's
// position depends on the previous frame's decision, so each stream is a
// sequence of searches: up to 16 candidate confidences at pos + t, then a
// pick.  The planes themselves (<= 25 MB per 2^21-sample segment, ~0.1 MB
// of it at the candidates) would take ~7.5 us at the HBM rate; the chain
// takes at least frames x (one shared-memory round trip + the decision),
// estimated ~5,250 x ~50 ns ~ 0.26 ms per Bell-202 segment on an H100.
// The first port (one thread per stream, every candidate a dependent L2
// load) took 0.72 us a frame (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// Design: one CTA of two warps per stream.
//  - A ring of score windows in shared memory.  The TPU kernel kept a
//    resident window of the planes in VMEM, refilled by DMA
//    (pallas_rx.py:381-410).  Here lane 0 of warp 1 is the producer: it
//    streams the planes the ring holds, window after window of G = 1024
//    samples, with 1-D TMA bulk copies (cp.async.bulk ... complete_tx,
//    no tensor map) into S stages, each with a full and an empty mbarrier.
//    pos only grows, so warp 0 (the consumer) releases a stage once pos
//    has passed its end, and the producer stays up to S - 1 stages ahead.
//    Window w lands in stage w mod S, so sample i sits at ring offset
//    i mod (S * G) whatever the (unaligned, even negative) carried pos.
//    No copy reaches past the planes; a candidate outside [0, t_scored)
//    reads whatever word sits at its ring offset and discards it for 0,
//    which never improves a search, as the TPU kernel's zero-signal
//    scores there.
//  - The ring's geometry (ops/mega_rx.py ring_geometry) follows from the
//    geometry alone: G * (S - 1) covers the widest scan window plus one
//    frame's largest advance, so the next frame's windows are in flight
//    while this frame decides.  The ring holds every plane when that fits
//    in 227 KB, else the confidence plane(s) only, and the winner's ampl
//    and bits come from global memory; where not even those cover an
//    advance (scan windows of thousands of samples) it takes the stages
//    that fit, always more than the scan window.
//    Where not even a scan window fits (scan windows of tens of thousands
//    of samples, dual planes at slow bauds) there is no ring: no producer,
//    and the warp reads its candidates straight from global memory
//    (__ldcg, through L2).
//  - A warp-parallel search.  Lane k holds candidate k's offset in a
//    register, loaded once from shared memory (no kernel parameter is
//    indexed at run time), and reads its confidence (and, with every
//    plane held, its ampl and bits) from the ring.  The winner is the
//    sequential replay's (fsk.c:477-516; ops/mega_rx.py
//    find_frame_parallel): the first candidate in table order with
//    cv >= limit and cv > 0; else the first index of the largest cv > 0;
//    NaN never wins; with no cv > 0 there is no winner.  One max-reduction
//    over a 32-bit key decides both (see search), then a ballot and
//    find-first-set.
//  - The scalar state (carrier, counters, f32 tracking and stats in
//    reference order) is warp-uniform: every lane computes it, so no
//    broadcast sits on the chain, and lane 0 stores the events and carry.
//    A lone warp on the SM pays every branch in full, so the frame is
//    straight-line code where it can be: selects, predicated stores, and
//    the bytes kept one per lane and stored 32 at a time.  (A loop rotated
//    to read the next frame's candidates before this frame's bookkeeping,
//    and a single guard compare in place of the loop and ring tests, both
//    ran slower as compiled.)
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700.00 W): 1.79 ms per
// 2^21-sample Bell-202 segment, 0.34 us per frame search, from 3.81 ms;
// still ~7x the chain estimate: a lone warp issues each frame's
// instructions one after another, each waiting on the one before.

#include <cuda_runtime.h>
#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kMax = 16;              // candidate table width (mega_rx.py)
constexpr int kLanes = 32;
constexpr int kMaxNoConfidence = 20;  // reference: src/minimodem.c:1290
constexpr int kEvFrame = 0;
constexpr int kEvCarrier = 1;
constexpr int kEvNoCarrier = 2;
constexpr int kEvAcquired = 1 << 8;   // a frame that acquired the carrier
constexpr int kLogG = 10;             // ring window: G = 1024 samples
constexpr int kG = 1 << kLogG;
constexpr int kThreads = 2 * kLanes;  // warp 0 consumer, warp 1 producer
constexpr unsigned kWarp = 0xffffffffu;

}  // namespace

extern "C" {

struct MegaParams {
    int batch, n_planes, t_scored, expect_nsamples, frame_nsamples,
        overscan, try_max0, try_max1, coarse_step0, coarse_step1,
        max_events, b_cap, rx_one, finalize, n_data_bits, data_shift,
        msb_first, sync_ok, sync_byte, dual, hold_all, window, stages,
        smem_bytes, compact, stop_on_overflow, bits_hi;
    float conf_threshold, conf_search_limit;
    int cand_c[2][kMax];
    int cand_f[2][kMax];
};

}  // extern "C"

namespace {

using namespace sm90;

// Where the search reads its candidates: a ring holding every plane, a
// ring of the confidence plane(s) only, or global memory.
enum Mode { kRingAll, kRingConf, kNoRing };

// Dynamic shared memory: the ring [held][S * G] words, then full[S] and
// empty[S] mbarriers, the four candidate tables [4][32] and the done
// flag.  ops/mega_rx.py ring_smem_bytes mirrors this.
__host__ __device__ constexpr int smem_bytes(int held, int stages) {
    return 4 * held * stages * kG + 16 * stages + 4 * 4 * kLanes + 16;
}

// Window k of a stream's ring sequence: its stage and its phase parity
// (the k-th use of stage (w_start + k) mod S is phase k / S).
struct Cursor {
    int k, slot, lap;
    unsigned par;
    __device__ void next(int stages) {
        ++k;
        if (++slot == stages) slot = 0;
        if (++lap == stages) {
            lap = 0;
            par ^= 1u;
        }
    }
};

// The producer: windows w_start .. w_start + n_win - 1 of the held planes,
// each after the consumer released the window S before it.  Stops early
// when the consumer is done, then waits out the copies in flight (the
// CTA's shared memory must not be left to a running copy).
template <int kHeld, bool kAll>
__device__ void produce(const int* row, int t_scored, int w_start, int n_win,
                        int stages, int slot0, int* ring, int ring_len,
                        uint64_t* full, uint64_t* empty, volatile int* done) {
    Cursor c{0, slot0, 0, 0u};
    for (; c.k < n_win; c.next(stages)) {
        if (*done) break;
        if (c.k >= stages) {
            bool quit = false;
            const unsigned long long t0 = now_ns();
            while (!mbar_try_wait(empty + c.slot, c.par ^ 1u)) {
                if (*done) {
                    quit = true;
                    break;
                }
                hang_check(t0);
            }
            if (quit) break;
        }
        const long long w = (long long)w_start + c.k;
        const long long left = (long long)t_scored - w * kG;
        const unsigned n =
            (w < 0 || left <= 0) ? 0u : (unsigned)(left < kG ? left : kG);
        mbar_arrive_expect_tx(full + c.slot, kHeld * 4u * n);
        if (n == 0u) continue;
#pragma unroll
        for (int h = 0; h < kHeld; ++h) {
            const int plane = kAll ? h : 3 * h;   // conf only: cd (0), cs (3)
            tma_load_1d(ring + (long long)h * ring_len + c.slot * kG,
                        row + (long long)plane * t_scored + w * kG, 4u * n,
                        full + c.slot);
        }
    }
    const int issued = c.k;
    const int first = issued > stages ? issued - stages : 0;
    Cursor d{first, (slot0 + first % stages) % stages, first % stages,
             (unsigned)((first / stages) & 1)};
    for (; d.k < issued; d.next(stages)) mbar_wait(full + d.slot, d.par);
}

// A lane's candidate offset t, as the search uses it: idx = t, or far
// below 0 where -1 ends the table (so pos + idx is never in range), and
// ring = max(t, 0), its ring offset from pos.
struct Lane {
    int idx, ring;
};

__device__ __forceinline__ Lane lane_offset(int t) {
    return Lane{t >= 0 ? t : -(1 << 30), max(t, 0)};
}

struct Pick {
    float c, a;
    unsigned blo, bhi;
    int t;
};

// One search over a candidate table, all 32 lanes: lane k's offset t,
// the ring's confidence (and ampl and bits, kRingAll) planes, the global
// planes (the confidence plane gc without a ring; ampl and bits read for
// the winner unless the ring holds them; with kHi the bits_hi plane gh,
// or null where the frame has <= 32 bits).  Straight-line code: a lone
// warp on the SM pays every branch in full, so every lane reads the ring
// (a stale or foreign word where it is out of range, then zeroed) and the
// two rules are both evaluated and selected.
template <Mode kMode, bool kHi>
__device__ __forceinline__ Pick search(Lane t, int pos, int pr, int ring_len,
                                       int t_scored, const float* rc,
                                       const float* ra, const int* rb,
                                       const float* gc, const float* ga,
                                       const int* gb, const int* gh,
                                       float limit, int lane) {
    const bool in = (unsigned)(pos + t.idx) < (unsigned)t_scored;
    float cv = 0.0f, av = 0.0f;
    int bv = 0;
    if constexpr (kMode == kNoRing) {
        cv = in ? __ldcg(gc + pos + t.idx) : 0.0f;
    } else {
        int o = pr + t.ring;                  // t < ring_len, pr < ring_len
        o = o >= ring_len ? o - ring_len : o;
        cv = rc[o];
        if constexpr (kMode == kRingAll) {
            av = ra[o];
            bv = rb[o];
        }
        cv = in ? cv : 0.0f;
    }
    // the first cv >= limit (cv > 0) in table order; else the first of
    // the largest cv > 0.  One max-reduction does both: positive floats
    // order as their unsigned bits (at most 0x7f800000, +inf), and a hit
    // ranks above every cv, the lower lane first.
    const bool pos_cv = cv > 0.0f;            // NaN is not
    const unsigned key =
        pos_cv && cv >= limit ? 0xff000000u | (unsigned)(kLanes - 1 - lane)
                              : (pos_cv ? __float_as_uint(cv) : 0u);
    const unsigned top = __reduce_max_sync(kWarp, key);
    const int wk = __ffs(__ballot_sync(kWarp, top != 0u && key == top)) - 1;
    const int src = max(wk, 0);               // wk -1: no winner
    Pick f;
    f.c = __shfl_sync(kWarp, cv, src);
    f.t = __shfl_sync(kWarp, t.idx, src);
    f.a = __shfl_sync(kWarp, av, src);
    f.blo = (unsigned)__shfl_sync(kWarp, bv, src);
    const bool won = wk >= 0;
    if (kMode != kRingAll && won) {
        f.a = __ldcg(ga + pos + f.t);
        f.blo = (unsigned)__ldcg(gb + pos + f.t);
    }
    f.bhi = 0u;
    if constexpr (kHi)
        f.bhi = gh != nullptr && won ? (unsigned)__ldcg(gh + pos + f.t) : 0u;
    f.c = won ? f.c : 0.0f;
    f.a = won ? f.a : 0.0f;
    f.blo = won ? f.blo : 0u;
    f.t = won ? f.t : 0;
    return f;
}

// lanes 0 .. n - 1 store their byte at base + lane, below cap
__device__ __forceinline__ void put_bytes(unsigned char* byb, int base, int n,
                                          int mine, int lane, int cap) {
    if (lane < n && base + lane < cap) byb[base + lane] = (unsigned char)mine;
}

__device__ __forceinline__ void store_event(int* rec, int p0, int p1, int p2,
                                            int p3, int p4, int p5, int type) {
    int4* r = reinterpret_cast<int4*>(rec);
    r[0] = make_int4(p0, p1, p2, p3);
    r[1] = make_int4(p4, p5, type, 0);
}

// kWide: wide records (one per frame, its raw bits; stop-on-overflow and
// bits_hi as the parameters say), else compact (data bytes and carrier
// transitions): two instantiations, so the compact loop carries none of
// the wide mode's selects.
template <Mode kMode, bool kDual, bool kWide>
__global__ void __launch_bounds__(kThreads)
mega_rx_kernel(const MegaParams p, const int* __restrict__ planes,
               const int* __restrict__ totals,
               const int* __restrict__ carry_i,
               const float* __restrict__ carry_f, int* __restrict__ ev,
               int* __restrict__ n_ev_out, unsigned char* __restrict__ bytes,
               int* __restrict__ n_by_out, int* __restrict__ ci_out,
               float* __restrict__ cf_out) {
    constexpr bool kAll = kMode == kRingAll;
    constexpr int kHeld =
        kMode == kNoRing ? 0 : (kAll ? (kDual ? 5 : 3) : (kDual ? 2 : 1));
    extern __shared__ __align__(128) unsigned char smem[];
    const int stages = p.stages;
    const int ring_len = stages * kG;
    int* ring = reinterpret_cast<int*>(smem);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + kHeld * ring_len);
    uint64_t* empty = full + stages;
    int* tables = reinterpret_cast<int*>(empty + stages);
    volatile int* done = tables + 4 * kLanes;

    const int b = blockIdx.x;
    const int T = p.t_scored;
    const int* row = planes + (long long)b * p.n_planes * T;
    const int total = totals[b];
    int pos = carry_i[b * 8 + 0];
    int stop = carry_i[b * 8 + 5];

    // the windows the consumer can read: while the loop runs,
    // pos + expect <= total, and a search reads below pos + w_scan
    const int w_scan = max(p.try_max0, p.try_max1);
    const int w_start = pos >> kLogG;                 // floor, pos may be < 0
    const int last = min(total - p.expect_nsamples + w_scan - 1, T - 1);
    const bool runs = stop == 0 && pos + p.expect_nsamples <= total;
    const int n_win = runs && last >= pos ? (last >> kLogG) - w_start + 1 : 0;
    int slot0 = stages ? w_start % stages : 0;
    if (slot0 < 0) slot0 += stages;

    if (threadIdx.x == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 1);
        }
#pragma unroll
        for (int k = 0; k < kMax; ++k) {
            tables[k] = p.cand_c[0][k];
            tables[kLanes + k] = p.cand_c[1][k];
            tables[2 * kLanes + k] = p.cand_f[0][k];
            tables[3 * kLanes + k] = p.cand_f[1][k];
        }
#pragma unroll
        for (int k = kMax; k < kLanes; ++k) {
            tables[k] = tables[kLanes + k] = tables[2 * kLanes + k] =
                tables[3 * kLanes + k] = -1;
        }
        *done = 0;
        mbar_init_fence();
    }
    __syncthreads();

    if (threadIdx.x >= kLanes) {
        if constexpr (kMode != kNoRing) {
            if (threadIdx.x == kLanes)
                produce<kHeld, kAll>(row, T, w_start, n_win, stages, slot0,
                                     ring, ring_len, full, empty, done);
        }
        return;
    }

    // ---- the consumer warp ----
    const int lane = threadIdx.x;
    const Lane tc0 = lane_offset(tables[lane]);
    const Lane tc1 = lane_offset(tables[kLanes + lane]);
    const Lane tf0 = lane_offset(tables[2 * kLanes + lane]);
    const Lane tf1 = lane_offset(tables[3 * kLanes + lane]);
    const float* rf = reinterpret_cast<const float*>(ring);
    const float* r_cd = rf;
    const float* r_ad = kAll ? rf + ring_len : nullptr;
    const int* r_bl = kAll ? ring + 2 * ring_len : nullptr;
    const float* r_cs =
        kDual ? (kAll ? rf + 3 * ring_len : rf + ring_len) : r_cd;
    const float* r_as = kAll && kDual ? rf + 4 * ring_len : r_ad;
    const float* g_cd = reinterpret_cast<const float*>(row);
    const float* g_ad = reinterpret_cast<const float*>(row + T);
    const int* g_bl = row + 2 * T;
    const float* g_cs =
        kDual ? reinterpret_cast<const float*>(row + 3 * (long long)T) : g_cd;
    const float* g_as =
        kDual ? reinterpret_cast<const float*>(row + 4 * (long long)T) : g_ad;
    const int* g_bh =
        p.bits_hi ? row + (long long)(p.n_planes - 1) * T : nullptr;
    int* evb = ev + (long long)b * p.max_events * 8;
    unsigned char* byb = bytes + (long long)b * p.b_cap;

    int carrier = carry_i[b * 8 + 1];
    int noconf = carry_i[b * 8 + 2];
    int nframes = carry_i[b * 8 + 3];
    int carrier_ns = carry_i[b * 8 + 4];
    float track = carry_f[b * 4 + 0];
    float peak = carry_f[b * 4 + 1];
    float conf_tot = carry_f[b * 4 + 2];
    float ampl_tot = carry_f[b * 4 + 3];
    int n_ev = 0, n_by = 0;
    const float thr = p.conf_threshold;
    const float lim = p.conf_search_limit;
    const float inf = __int_as_float(0x7f800000);
    const unsigned data_mask = (1u << p.n_data_bits) - 1u;  // compact only
    int pr = ring_len ? pos % ring_len : 0;           // pos mod (S * G)
    if (pr < 0) pr += ring_len;
    Cursor rel{0, slot0, 0, 0u};     // next window to release
    Cursor ready{0, slot0, 0, 0u};   // next window to wait for
    // pos at which window rel.k is passed; samples below ready_to landed
    int rel_at = (w_start + 1) * kG;
    int ready_to = w_start * kG;
    int mine = 0;                    // lane k: byte k of the current run of 32

    const int tm0 = p.try_max0, tm1 = p.try_max1;
    const int step = p.frame_nsamples - p.overscan;

    // The loop body is straight-line code where the frame allows: stats,
    // events and bytes are selects and predicated stores, so they overlap
    // the search's latencies; only the ring's window turns, the fine
    // rescan and a full run of bytes branch.
    while (stop == 0 && pos + p.expect_nsamples <= total &&
           n_ev < p.max_events - 2) {
        const int cw = carrier;
        const int tm = cw ? tm1 : tm0;
        // release the windows pos has passed, wait for those this frame
        // may read ([pos, pos + w_scan) covers both tables of both states)
        if (kMode != kNoRing && (pos >= rel_at || pos + w_scan > ready_to)) {
            while (pos >= rel_at && rel.k < n_win) {
                if (rel.k == ready.k) {
                    mbar_wait(full + ready.slot, ready.par);
                    ready.next(stages);
                    ready_to += kG;
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + rel.slot);
                rel.next(stages);
                rel_at += kG;
            }
            while (pos + w_scan > ready_to && ready.k < n_win) {
                mbar_wait(full + ready.slot, ready.par);
                ready.next(stages);
                ready_to += kG;
            }
        }

        Pick f = search<kMode, kWide>(cw ? tc1 : tc0, pos, pr, ring_len, T,
                                      cw ? r_cd : r_cs, cw ? r_ad : r_as,
                                      r_bl, cw ? g_cd : g_cs,
                                      cw ? g_ad : g_as, g_bl, g_bh, lim,
                                      lane);
        float c = f.c, a = f.a;
        unsigned blo = f.blo, bhi = f.bhi;
        int fs = f.t;
        const bool refine = c < __fmul_rn(peak, 0.75f);
        peak = refine ? 0.0f : peak;
        c = a < __fmul_rn(track, 0.25f) ? 0.0f : c;
        const bool got = !(c <= thr);
        noconf = got ? 0 : noconf + 1;
        const bool drop = !got && noconf > kMaxNoConfidence;
        const bool drop_report = drop && cw == 1;
        const bool acquired = got && cw == 0;
        const int fs_coarse = fs;
        const int try_step = cw ? p.coarse_step1 : p.coarse_step0;
        if (got && (refine || acquired) && c < inf && try_step > 1) {
            // fine rescan: same window, data expect, no early exit
            Pick f2 = search<kMode, kWide>(cw ? tf1 : tf0, pos, pr, ring_len,
                                           T, r_cd, r_ad, r_bl, g_cd, g_ad,
                                           g_bl, g_bh, inf, lane);
            if (f2.c > c) {           // confidence itself is not updated
                a = f2.a;
                blo = f2.blo;
                bhi = f2.bhi;
                fs = f2.t;
            }
        }
        // the NOCARRIER event reports the stats before this frame, which
        // leaves them unchanged (drop_report implies !got).  Compact: the
        // carrier transitions, at their byte positions.  Wide: every frame
        // with its raw bits, and lane 5 the scan position where the stream
        // stops on overflow.
        const bool event = drop_report || (kWide ? got : acquired);
        if constexpr (kWide) {
            const int at = p.stop_on_overflow ? pos : 0;
            if (event && lane == 0) {
                if (drop_report)
                    store_event(evb + n_ev * 8, nframes,
                                __float_as_int(conf_tot),
                                __float_as_int(ampl_tot), carrier_ns, 0, at,
                                kEvNoCarrier);
                else
                    store_event(evb + n_ev * 8, (int)blo, (int)bhi,
                                __float_as_int(c), __float_as_int(a), fs, at,
                                kEvFrame | (acquired ? kEvAcquired : 0));
            }
        } else if (event && lane == 0) {
            store_event(evb + n_ev * 8, drop_report ? nframes : n_by,
                        drop_report ? __float_as_int(conf_tot) : 0,
                        drop_report ? __float_as_int(ampl_tot) : 0,
                        drop_report ? carrier_ns : 0, drop_report ? n_by : 0,
                        0, drop_report ? kEvNoCarrier : kEvCarrier);
        }
        n_ev += event;
        // x / 2 and x * 0.5 round the same real number: bit-identical
        const float track_got = __fmul_rn(__fadd_rn(track, a), 0.5f);
        const float conf_got = __fadd_rn(conf_tot, c);
        const float ampl_got = __fadd_rn(ampl_tot, a);
        carrier_ns += got ? p.frame_nsamples + (cw ? fs_coarse - p.overscan : 0)
                          : 0;
        track = got ? track_got : track;
        peak = got && peak < c ? c : peak;
        conf_tot = got ? conf_got : conf_tot;
        ampl_tot = got ? ampl_got : ampl_tot;
        nframes += got;
        const int advance = got ? fs + step : tm;
        if constexpr (!kWide) {
            // frame bits -> data byte (minimodem.c:1414-1439); lane n_by %
            // 32 keeps it, and a full run of 32 is stored at once
            unsigned word = (blo >> p.data_shift) & data_mask;
            if (p.msb_first) word = __brev(word) >> (32 - p.n_data_bits);
            const bool keep =
                got && !(p.sync_ok && word == (unsigned)p.sync_byte);
            mine = keep && lane == (n_by & (kLanes - 1)) ? (int)word : mine;
            n_by += keep;             // the host raises past b_cap
            if (keep && (n_by & (kLanes - 1)) == 0)
                put_bytes(byb, n_by - kLanes, kLanes, mine, lane, p.b_cap);
        }
        pos += advance;
        if constexpr (kMode != kNoRing) {
            pr += advance;
            pr = pr >= ring_len ? pr - ring_len : pr;
            if (pr >= ring_len) pr %= ring_len;   // an advance beyond the ring
        }
        carrier = got ? 1 : (drop ? 0 : cw);
        // a reported drop resets the stats (a silent one leaves them)
        track = drop_report ? 0.0f : track;
        conf_tot = drop_report ? 0.0f : conf_tot;
        ampl_tot = drop_report ? 0.0f : ampl_tot;
        nframes = drop_report ? 0 : nframes;
        carrier_ns = drop_report ? 0 : carrier_ns;
        stop = drop_report && p.rx_one ? 1 : stop;
        // -a re-arms its carrier detection at every overflow, reported or
        // not (minimodem.c:1295-1297): the host retunes there
        if constexpr (kWide) stop = drop && p.stop_on_overflow ? 1 : stop;
    }
    put_bytes(byb, n_by & ~(kLanes - 1), n_by & (kLanes - 1), mine, lane,
              p.b_cap);
    if (lane != 0) return;
    *done = 1;                        // the producer stops streaming

    // carry-out = loop-exit state (before the final flush)
    int* co = ci_out + b * 8;
    co[0] = pos; co[1] = carrier; co[2] = noconf; co[3] = nframes;
    co[4] = carrier_ns; co[5] = stop; co[6] = 0; co[7] = 0;
    float* fo = cf_out + b * 4;
    fo[0] = track; fo[1] = peak; fo[2] = conf_tot; fo[3] = ampl_tot;
    if (p.finalize && carrier) {
        store_event(evb + n_ev * 8, nframes, __float_as_int(conf_tot),
                    __float_as_int(ampl_tot), carrier_ns, n_by, 0,
                    kEvNoCarrier);
        ++n_ev;
    }
    n_ev_out[b] = n_ev;
    n_by_out[b] = n_by;
}

template <Mode kMode, bool kDual, bool kWide>
int launch(const MegaParams& p, const int* planes, const int* totals,
           const int* carry_i, const float* carry_f, int* ev, int* n_ev,
           unsigned char* bytes, int* n_by, int* ci_out, float* cf_out,
           cudaStream_t stream) {
    auto kernel = mega_rx_kernel<kMode, kDual, kWide>;
    if (p.smem_bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<p.batch, kThreads, p.smem_bytes, stream>>>(
        p, planes, totals, carry_i, carry_f, ev, n_ev, bytes, n_by, ci_out,
        cf_out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mm_mega_rx(const void* params, const void* planes,
                          const void* totals, const void* carry_i,
                          const void* carry_f, void* ev, void* n_ev,
                          void* bytes, void* n_bytes, void* ci_out,
                          void* cf_out, void* stream) {
    const MegaParams p = *static_cast<const MegaParams*>(params);
    const int base = p.dual ? 5 : 3;
    const int held = p.stages == 0 ? 0 : (p.hold_all ? base : (p.dual ? 2 : 1));
    if (p.window != kG || p.n_planes != base + (p.bits_hi != 0) ||
        p.stages == 1 || p.stages < 0 || (p.stages == 0 && p.hold_all) ||
        p.t_scored % 4 != 0 || p.smem_bytes != smem_bytes(held, p.stages) ||
        (p.compact && (p.n_data_bits > 8 || p.stop_on_overflow)))
        return (int)cudaErrorInvalidValue;
    auto args = [&](auto fn) {
        return fn(p, static_cast<const int*>(planes),
                  static_cast<const int*>(totals),
                  static_cast<const int*>(carry_i),
                  static_cast<const float*>(carry_f), static_cast<int*>(ev),
                  static_cast<int*>(n_ev), static_cast<unsigned char*>(bytes),
                  static_cast<int*>(n_bytes), static_cast<int*>(ci_out),
                  static_cast<float*>(cf_out),
                  static_cast<cudaStream_t>(stream));
    };
    // Mode x layout x output: the ring's planes, single or dual, compact
    // or wide
    auto by_output = [&](auto compact_fn, auto wide_fn) {
        return p.compact ? args(compact_fn) : args(wide_fn);
    };
    if (p.stages == 0)
        return p.dual ? by_output(launch<kNoRing, true, false>,
                                  launch<kNoRing, true, true>)
                      : by_output(launch<kNoRing, false, false>,
                                  launch<kNoRing, false, true>);
    if (p.hold_all)
        return p.dual ? by_output(launch<kRingAll, true, false>,
                                  launch<kRingAll, true, true>)
                      : by_output(launch<kRingAll, false, false>,
                                  launch<kRingAll, false, true>);
    return p.dual ? by_output(launch<kRingConf, true, false>,
                              launch<kRingConf, true, true>)
                  : by_output(launch<kRingConf, false, false>,
                              launch<kRingConf, false, true>);
}
