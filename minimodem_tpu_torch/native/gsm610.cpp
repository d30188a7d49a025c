// GSM 06.10 full-rate (RPE-LTP) decoder, implemented from the ETSI
// 06.10 specification's fixed-point arithmetic so that decoded samples
// are bit-exact with libsndfile's embedded libgsm — the reference's
// file layer decodes GSM-compressed containers transparently through
// sf_readf_float (reference: src/simpleaudio-sndfile.c:46-70), so the
// parity bar is sample-exactness against that stack.
//
// Two frame packings are supported, matching libsndfile's container
// rules:
//   - standard 33-byte frames (0xD magic nibble, MSB-first fields):
//     AIFF / AU / RAW
//   - WAV49 65-byte blocks (two 260-bit frames, LSB-first fields,
//     no magic): WAV / W64
//
// Every arithmetic helper follows the spec's saturating 16-bit ops;
// divergence anywhere breaks sample-exactness, which
// tests/test_sndfile_interop.py enforces against the bundled
// libsndfile oracle.

#include <cstdint>
#include <cstring>

namespace {

typedef int16_t word;
typedef int32_t lw;

inline word sat16(lw x) {
    return x > 32767 ? (word)32767 : x < -32768 ? (word)-32768 : (word)x;
}
inline word gadd(word a, word b) { return sat16((lw)a + (lw)b); }
inline word gsub(word a, word b) { return sat16((lw)a - (lw)b); }
// mult_r: rounding Q15 multiply with the spec's MIN*MIN special case
inline word gmultr(word a, word b) {
    if (a == -32768 && b == -32768) return 32767;
    return (word)(((lw)a * (lw)b + 16384) >> 15);
}
inline word gasr(word a, int n) {     // arithmetic shift right, n in [0,15]
    return (word)(a >> n);
}

// quantized LTP gain levels (spec table 4.3b)
const word QLB[4] = {3277, 11469, 21299, 32767};
// APCM mantissa scale factors (spec table 4.12.15 / NRFAC inverse)
const word FAC[8] = {18431, 20479, 22527, 24575, 26623, 28671, 30719, 32767};
// LAR decode tables (spec section 4.2.8): INVA = 32768*8/A, MIC = min LARc
const word INVA[8] = {13107, 13107, 13107, 13107, 19223, 17476, 31454, 29708};
const word MIC[8] = {-32, -32, -16, -16, -8, -8, -4, -4};
const word BTAB[8] = {0, 0, 2048, -2560, 94, -1792, -341, -1144};

struct State {
    word dp[160];      // reconstructed short-term residual: 120 history
                       // samples + the current 40-sample subframe
    word v[9];         // short-term synthesis lattice state
    word LARpp_prev[8];
    word msr;          // de-emphasis memory
    word nrp;          // last valid LTP lag
};

void state_init(State *s) {
    std::memset(s, 0, sizeof(*s));
    s->nrp = 40;
}

// ---- 4.12.15: xmaxc -> (exponent, mantissa) ----------------------------
void xmaxc_to_exp_mant(word xmaxc, word *exp_out, word *mant_out) {
    word exp = 0;
    if (xmaxc > 15) exp = (word)((xmaxc >> 3) - 1);
    word mant = (word)(xmaxc - (exp << 3));
    if (mant == 0) {
        exp = -4;
        mant = 7;
    } else {
        while (mant <= 7) {
            mant = (word)(mant << 1 | 1);
            exp--;
        }
        mant = (word)(mant - 8);
    }
    *exp_out = exp;
    *mant_out = mant;
}

// ---- 4.2.16 inverse APCM + 4.2.17 grid positioning ----------------------
void rpe_decode(word xmaxc, word Mc, const word *xMc, word *erp /*[40]*/) {
    word exp, mant;
    xmaxc_to_exp_mant(xmaxc, &exp, &mant);
    word temp1 = FAC[mant];
    word temp2 = gsub(6, exp);            // in [0, 10]
    word temp3 = (word)(temp2 >= 1 ? (1 << (temp2 - 1)) : 0);
    word xMp[13];
    for (int i = 0; i < 13; i++) {
        word temp = (word)(((xMc[i] << 1) - 7) << 12);   // restore sign, Q12
        temp = gmultr(temp1, temp);
        temp = gadd(temp, temp3);
        xMp[i] = gasr(temp, temp2);
    }
    for (int k = 0; k < 40; k++) erp[k] = 0;
    for (int i = 0; i < 13; i++) erp[Mc + 3 * i] = xMp[i];
}

// ---- 4.3.2: long-term synthesis into drp = s->dp + 120 ------------------
void long_term_synthesis(State *s, word Nc, word bc, const word *erp) {
    word Nr = (Nc < 40 || Nc > 120) ? s->nrp : Nc;
    s->nrp = Nr;
    word brp = QLB[bc];
    word *drp = s->dp + 120;
    for (int k = 0; k < 40; k++) {
        word drpp = gmultr(brp, drp[k - Nr]);
        drp[k] = gadd(erp[k], drpp);
    }
    // shift the 160-sample residual window left by one subframe
    for (int k = 0; k < 120; k++) s->dp[k] = s->dp[k + 40];
}

// ---- 4.2.8: coded LARc -> LARpp ------------------------------------------
void decode_LARs(const word *LARc, word *LARpp) {
    for (int i = 0; i < 8; i++) {
        word temp1 = (word)(gadd(LARc[i], MIC[i]) << 10);
        word temp2 = (word)(BTAB[i] << 1);
        temp1 = gsub(temp1, temp2);
        temp1 = gmultr(INVA[i], temp1);
        LARpp[i] = gadd(temp1, temp1);
    }
}

// ---- 4.2.9.1: zone interpolation of LARpp -> LARp ------------------------
void coefficients(int zone, const word *prev, const word *cur, word *LARp) {
    for (int i = 0; i < 8; i++) {
        switch (zone) {
        case 0:
            LARp[i] = gadd(gasr(prev[i], 2), gasr(cur[i], 2));
            LARp[i] = gadd(LARp[i], gasr(prev[i], 1));
            break;
        case 1:
            LARp[i] = gadd(gasr(prev[i], 1), gasr(cur[i], 1));
            break;
        case 2:
            LARp[i] = gadd(gasr(prev[i], 2), gasr(cur[i], 2));
            LARp[i] = gadd(LARp[i], gasr(cur[i], 1));
            break;
        default:
            LARp[i] = cur[i];
        }
    }
}

// ---- 4.2.9.2: LARp -> reflection coefficients rp --------------------------
void LARp_to_rp(word *LARp) {
    for (int i = 0; i < 8; i++) {
        word temp;
        if (LARp[i] < 0) {
            temp = (word)(LARp[i] == -32768 ? 32767 : -LARp[i]);
            LARp[i] = (word)(-(temp < 11059 ? (word)(temp << 1)
                               : temp < 20070 ? (word)(temp + 11059)
                                              : gadd(gasr(temp, 2), 26112)));
        } else {
            temp = LARp[i];
            LARp[i] = temp < 11059 ? (word)(temp << 1)
                      : temp < 20070 ? (word)(temp + 11059)
                                     : gadd(gasr(temp, 2), 26112);
        }
    }
}

// ---- 4.3.4: short-term synthesis lattice filter ---------------------------
void short_term_filter(State *s, const word *rrp, int k, const word *wt,
                       word *sr) {
    word *v = s->v;
    while (k--) {
        word sri = *wt++;
        for (int i = 8; i--;) {
            sri = gsub(sri, gmultr(rrp[i], v[i]));
            v[i + 1] = gadd(v[i], gmultr(rrp[i], sri));
        }
        *sr++ = v[0] = sri;
    }
}

void short_term_synthesis(State *s, const word *LARcr, const word *wt,
                          word *sout) {
    word LARpp[8], LARp[8];
    decode_LARs(LARcr, LARpp);
    static const int bounds[5] = {0, 13, 27, 40, 160};
    for (int z = 0; z < 4; z++) {
        coefficients(z, s->LARpp_prev, LARpp, LARp);
        LARp_to_rp(LARp);
        short_term_filter(s, LARp, bounds[z + 1] - bounds[z], wt + bounds[z],
                          sout + bounds[z]);
    }
    std::memcpy(s->LARpp_prev, LARpp, sizeof(LARpp));
}

// ---- 4.3.5: de-emphasis + upscale + truncation -----------------------------
void postprocess(State *s, word *sbuf) {
    word msr = s->msr;
    for (int k = 0; k < 160; k++) {
        msr = gadd(sbuf[k], gmultr(msr, 28180));
        sbuf[k] = (word)(((lw)gadd(msr, msr)) & ~(lw)7);
    }
    s->msr = msr;
}

// ---- one frame from unpacked parameters ------------------------------------
void decode_frame(State *s, const word *LARc, const word *Nc, const word *bc,
                  const word *Mc, const word *xmaxc, const word *xMc,
                  word *out /*[160]*/) {
    word erp[40];
    word wt[160];
    for (int j = 0; j < 4; j++) {
        rpe_decode(xmaxc[j], Mc[j], xMc + 13 * j, erp);
        long_term_synthesis(s, Nc[j], bc[j], erp);
        // the just-synthesized subframe sits at drp[0..39] = dp[120..159]
        // (the history shift leaves it in place)
        std::memcpy(wt + 40 * j, s->dp + 120, 40 * sizeof(word));
    }
    short_term_synthesis(s, LARc, wt, out);
    postprocess(s, out);
}

// ---- bit unpacking -----------------------------------------------------------
struct BitsMSB {
    const uint8_t *p;
    long long pos = 0;
    unsigned get(int n) {
        unsigned v = 0;
        while (n--) {
            v = (v << 1) | ((p[pos >> 3] >> (7 - (pos & 7))) & 1u);
            pos++;
        }
        return v;
    }
};

struct BitsLSB {
    const uint8_t *p;
    long long pos = 0;
    unsigned get(int n) {
        unsigned v = 0;
        for (int i = 0; i < n; i++) {
            v |= (unsigned)((p[pos >> 3] >> (pos & 7)) & 1u) << i;
            pos++;
        }
        return v;
    }
};

const int LAR_BITS[8] = {6, 6, 5, 5, 4, 4, 3, 3};

template <class Bits>
void unpack_params(Bits &br, word *LARc, word *Nc, word *bc, word *Mc,
                   word *xmaxc, word *xMc) {
    for (int i = 0; i < 8; i++) LARc[i] = (word)br.get(LAR_BITS[i]);
    for (int j = 0; j < 4; j++) {
        Nc[j] = (word)br.get(7);
        bc[j] = (word)br.get(2);
        Mc[j] = (word)br.get(2);
        xmaxc[j] = (word)br.get(6);
        for (int i = 0; i < 13; i++) xMc[13 * j + i] = (word)br.get(3);
    }
}

}  // namespace

extern "C" {

// Decode a run of GSM 06.10 frames.
//   wav49 = 0: 33-byte frames (magic 0xD, MSB-first)  -> 160 samples each
//   wav49 = 1: 65-byte blocks (2 LSB-first frames)    -> 320 samples each
// Returns samples written, or -1 on a bad frame magic / short buffer.
long long mm_gsm610_decode(const uint8_t *data, long long nbytes, int wav49,
                           int16_t *out, long long out_cap) {
    State st;
    state_init(&st);
    word LARc[8], Nc[4], bc[4], Mc[4], xmaxc[4], xMc[52];
    long long written = 0;
    if (wav49) {
        long long nblocks = nbytes / 65;
        for (long long b = 0; b < nblocks; b++) {
            if (written + 320 > out_cap) return -1;
            BitsLSB br{data + 65 * b};
            for (int half = 0; half < 2; half++) {
                unpack_params(br, LARc, Nc, bc, Mc, xmaxc, xMc);
                decode_frame(&st, LARc, Nc, bc, Mc, xmaxc, xMc,
                             out + written);
                written += 160;
            }
        }
    } else {
        long long nframes = nbytes / 33;
        for (long long f = 0; f < nframes; f++) {
            if (written + 160 > out_cap) return -1;
            BitsMSB br{data + 33 * f};
            if (br.get(4) != 0xD) return -1;  // GSM magic nibble
            unpack_params(br, LARc, Nc, bc, Mc, xmaxc, xMc);
            decode_frame(&st, LARc, Nc, bc, Mc, xmaxc, xMc, out + written);
            written += 160;
        }
    }
    return written;
}

}  // extern "C"
