// hostrx.cpp — native host-side RX carrier state machine.
//
// C++ replay of the receive loop (the same decision sequence as
// rx/engine.py and ops/device_rx.py stage 3; behavioral reference:
// src/minimodem.c:1137-1463, src/fsk.c:449-538 in the upstream project).
// Consumes precomputed per-offset score arrays and emits the same event
// stream as the device receiver: (type, payload[6]) records.
//
// All comparisons and accumulations are C float (binary32) to match the
// float32 semantics of the other engines.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int FSK_ANALYZE_NSTEPS = 3;
constexpr int FSK_ANALYZE_NSTEPS_FINE = 8;
constexpr int FSK_MAX_NOCONFIDENCE_BITS = 20;

constexpr int EV_FRAME = 0;
constexpr int EV_CARRIER = 1;
constexpr int EV_NOCARRIER = 2;

struct Best {
    float c = 0.0f;
    float a = 0.0f;
    uint32_t blo = 0;
    uint32_t bhi = 0;
    int32_t t = 0;
};

}  // namespace

extern "C" {

#pragma pack(push, 1)
struct MmRxConfig {
    int64_t total;             // valid stream length in samples
    int64_t t_scored;          // length of the score arrays
    int32_t expect_nsamples;
    int32_t frame_nsamples;
    int32_t overscan;
    int32_t try_max_carrier;     // incl. overscan
    int32_t try_max_nocarrier;   // incl. overscan
    int32_t rx_one;
    float conf_threshold;
    float conf_search_limit;
};
#pragma pack(pop)

// Returns number of events written (<= max_events), or -1 on overflow.
long long mm_hostrx_run(
    const MmRxConfig* cfg,
    const float* conf_data, const float* conf_sync,
    const float* ampl_data, const float* ampl_sync,
    const uint32_t* bits_lo, const uint32_t* bits_hi,
    int32_t* ev_type,           // [max_events]
    uint32_t* ev_pay,           // [max_events * 6]
    long long max_events) {
    const int64_t total = cfg->total;
    const int64_t t_scored = cfg->t_scored;
    long long n_events = 0;

    auto emit = [&](int type, uint32_t p0, uint32_t p1, uint32_t p2,
                    uint32_t p3, uint32_t p4) -> bool {
        if (n_events >= max_events) return false;
        ev_type[n_events] = type;
        uint32_t* p = ev_pay + n_events * 6;
        p[0] = p0; p[1] = p1; p[2] = p2; p[3] = p3; p[4] = p4; p[5] = 0;
        ++n_events;
        return true;
    };
    auto fbits = [](float v) -> uint32_t {
        uint32_t u;
        std::memcpy(&u, &v, 4);
        return u;
    };

    // center-out scan with early exit (fsk_find_frame replay)
    auto find_frame = [&](int64_t pos, int try_first, int try_max,
                          int try_step, float limit, bool use_sync) -> Best {
        const float* conf = use_sync ? conf_sync : conf_data;
        const float* ampl = use_sync ? ampl_sync : ampl_data;
        Best best;
        for (int j = 0;; ++j) {
            int up = (j % 2) ? 1 : -1;
            int t = try_first + up * ((j + 1) / 2) * try_step;
            if (t >= try_max) break;
            if (t < 0) continue;
            int64_t idx = pos + t;
            if (idx >= t_scored) continue;  // zero-padded region
            float c = conf[idx];
            if (best.c < c) {
                best.c = c;
                best.a = ampl[idx];
                best.blo = bits_lo[idx];
                best.bhi = bits_hi[idx];
                best.t = t;
                if (best.c >= limit) break;
            }
        }
        return best;
    };

    int64_t pos = 0;
    bool carrier = false;
    int noconfidence = 0;
    float track_amplitude = 0.0f;
    float peak_confidence = 0.0f;
    float conf_total = 0.0f;
    float ampl_total = 0.0f;
    uint32_t nframes = 0;
    uint32_t carrier_nsamples = 0;

    while (pos + cfg->expect_nsamples <= total) {
        int try_max = carrier ? cfg->try_max_carrier : cfg->try_max_nocarrier;
        int try_step = try_max / FSK_ANALYZE_NSTEPS;
        if (try_step == 0) try_step = 1;
        int try_first = carrier ? cfg->overscan : 0;
        bool use_sync = !carrier;

        Best b = find_frame(pos, try_first, try_max, try_step,
                            cfg->conf_search_limit, use_sync);
        float confidence = b.c;
        float amplitude = b.a;

        bool do_refine = false;
        if (confidence < peak_confidence * 0.75f) {
            do_refine = true;
            peak_confidence = 0.0f;
        }
        if (amplitude < track_amplitude * 0.25f) confidence = 0.0f;

        if (confidence <= cfg->conf_threshold) {
            if (++noconfidence > FSK_MAX_NOCONFIDENCE_BITS) {
                if (carrier) {
                    if (!emit(EV_NOCARRIER, nframes, fbits(conf_total),
                              fbits(ampl_total), carrier_nsamples, 0))
                        return -1;
                    carrier = false;
                    carrier_nsamples = 0;
                    conf_total = 0.0f;
                    ampl_total = 0.0f;
                    nframes = 0;
                    track_amplitude = 0.0f;
                    if (cfg->rx_one) break;
                }
            }
            pos += try_max;
            continue;
        }

        carrier_nsamples += (uint32_t)cfg->frame_nsamples;
        if (carrier) {
            carrier_nsamples += (uint32_t)b.t;
            carrier_nsamples -= (uint32_t)cfg->overscan;
        } else {
            if (!emit(EV_CARRIER, 0, 0, 0, 0, 0)) return -1;
            carrier = true;
            do_refine = true;
        }

        if (do_refine && confidence < INFINITY && try_step > 1) {
            int fine_step = try_max / FSK_ANALYZE_NSTEPS_FINE;
            if (fine_step == 0) fine_step = 1;
            // carrier is now on: data expect (reference: :1373-1378)
            Best b2 = find_frame(pos, try_first, try_max, fine_step,
                                 INFINITY, false);
            if (b2.c > confidence) {
                // NB: confidence itself not updated (reference: :1383-1387)
                amplitude = b2.a;
                b.blo = b2.blo;
                b.bhi = b2.bhi;
                b.t = b2.t;
            }
        }

        track_amplitude = (track_amplitude + amplitude) / 2.0f;
        if (peak_confidence < confidence) peak_confidence = confidence;
        conf_total += confidence;
        ampl_total += amplitude;
        ++nframes;
        noconfidence = 0;

        if (!emit(EV_FRAME, b.blo, b.bhi, fbits(confidence),
                  fbits(amplitude), (uint32_t)b.t))
            return -1;

        pos += (int64_t)b.t + cfg->frame_nsamples - cfg->overscan;
    }

    if (carrier) {
        if (!emit(EV_NOCARRIER, nframes, fbits(conf_total), fbits(ampl_total),
                  carrier_nsamples, 0))
            return -1;
    }
    return n_events;
}

}  // extern "C"
