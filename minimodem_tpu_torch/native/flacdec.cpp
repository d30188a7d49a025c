// FLAC decoder (native read path for the sigio file backend).
//
// Replaces the FLAC read capability the reference gets from libsndfile
// (reference: src/simpleaudio-sndfile.c:111-157 maps the .flac extension
// to SF_FORMAT_FLAC).  Implemented from the FLAC format specification:
// STREAMINFO, frame headers (UTF-8 coded numbers, CRC-8 skipped), all
// subframe types (CONSTANT, VERBATIM, FIXED 0-4, LPC 1-32), Rice /
// Rice2 residual partitions with escape codes, wasted bits, and the
// independent / left-side / right-side / mid-side channel assignments.
// Output is int32 interleaved samples at the stream's bit depth.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t bytepos = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool error = false;

    void refill() {
        while (nbits <= 56 && bytepos < size) {
            acc = (acc << 8) | data[bytepos++];
            nbits += 8;
        }
    }
    uint32_t bits(int n) {  // n in [0, 32]
        if (n == 0) return 0;
        refill();
        if (nbits < n) { error = true; return 0; }
        uint32_t v = (uint32_t)((acc >> (nbits - n)) & ((n == 64) ? ~0ull : ((1ull << n) - 1)));
        nbits -= n;
        return v;
    }
    uint64_t bits64(int n) {
        if (n <= 32) return bits(n);
        uint64_t hi = bits(n - 32);
        uint64_t lo = bits(32);
        return (hi << 32) | lo;
    }
    int32_t sbits(int n) {  // signed two's complement
        uint32_t v = bits(n);
        if (n == 0 || n == 32) return (int32_t)v;
        if (v & (1u << (n - 1))) return (int32_t)(v | (~0u << n));
        return (int32_t)v;
    }
    uint32_t unary() {
        uint32_t q = 0;
        for (;;) {
            refill();
            if (nbits == 0) { error = true; return q; }
            // scan available bits for the first 1
            while (nbits > 0) {
                uint32_t b = (uint32_t)((acc >> (nbits - 1)) & 1);
                nbits--;
                if (b) return q;
                q++;
            }
        }
    }
    void align() { nbits -= nbits & 7; }
    bool at_end() {
        refill();
        return nbits == 0 && bytepos >= size;
    }
};

struct StreamInfo {
    int rate = 0, channels = 0, bits = 0;
    long long total = 0;
    size_t audio_start = 0;
};

bool parse_streaminfo(const uint8_t* d, size_t n, StreamInfo* si) {
    if (n < 4 || memcmp(d, "fLaC", 4) != 0) return false;
    size_t p = 4;
    bool have_si = false;
    for (;;) {
        if (p + 4 > n) return false;
        uint8_t hdr = d[p];
        bool last = hdr & 0x80;
        int type = hdr & 0x7F;
        uint32_t len = (d[p + 1] << 16) | (d[p + 2] << 8) | d[p + 3];
        p += 4;
        if (p + len > n) return false;
        if (type == 0 && len >= 34) {  // STREAMINFO
            const uint8_t* s = d + p;
            si->rate = (s[10] << 12) | (s[11] << 4) | (s[12] >> 4);
            si->channels = ((s[12] >> 1) & 0x7) + 1;
            si->bits = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
            si->total = ((long long)(s[13] & 0x0F) << 32)
                | ((long long)s[14] << 24) | (s[15] << 16)
                | (s[16] << 8) | s[17];
            have_si = true;
        }
        p += len;
        if (last) break;
    }
    si->audio_start = p;
    return have_si;
}

// decode one residual-coded section into res[], after `pred` warmup samps
bool read_residual(BitReader& br, int blocksize, int pred_order,
                   int32_t* res) {
    int method = br.bits(2);
    if (method > 1) return false;
    int pbits = method == 0 ? 4 : 5;
    int escape = method == 0 ? 0x0F : 0x1F;
    int porder = br.bits(4);
    int nparts = 1 << porder;
    int psize = blocksize >> porder;
    int idx = pred_order;
    for (int part = 0; part < nparts; part++) {
        int count = psize - (part == 0 ? pred_order : 0);
        if (count < 0) return false;
        int param = br.bits(pbits);
        if (param == escape) {
            int rawbits = br.bits(5);
            for (int i = 0; i < count; i++)
                res[idx++] = rawbits ? br.sbits(rawbits) : 0;
        } else {
            for (int i = 0; i < count; i++) {
                uint32_t q = br.unary();
                uint32_t r = param ? br.bits(param) : 0;
                uint32_t u = (q << param) | r;
                res[idx++] = (int32_t)(u >> 1) ^ -(int32_t)(u & 1);
            }
        }
        if (br.error) return false;
    }
    return idx == blocksize;
}

bool decode_subframe(BitReader& br, int blocksize, int bps, int32_t* out) {
    if (br.bits(1) != 0) return false;      // zero padding bit
    int type = br.bits(6);
    int wasted = 0;
    if (br.bits(1)) wasted = 1 + (int)br.unary();
    bps -= wasted;
    if (bps <= 0 || bps > 32) return false;

    if (type == 0) {                         // CONSTANT
        int32_t v = br.sbits(bps);
        for (int i = 0; i < blocksize; i++) out[i] = v;
    } else if (type == 1) {                  // VERBATIM
        for (int i = 0; i < blocksize; i++) out[i] = br.sbits(bps);
    } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
        int order = type & 0x07;
        if (order > blocksize) return false;  // crafted input: warmup OOB
        for (int i = 0; i < order; i++) out[i] = br.sbits(bps);
        if (!read_residual(br, blocksize, order, out)) return false;
        // fixed predictors (FLAC spec section on FIXED subframes)
        switch (order) {
        case 0: break;
        case 1:
            for (int i = 1; i < blocksize; i++) out[i] += out[i - 1];
            break;
        case 2:
            for (int i = 2; i < blocksize; i++)
                out[i] += 2 * out[i - 1] - out[i - 2];
            break;
        case 3:
            for (int i = 3; i < blocksize; i++)
                out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
            break;
        case 4:
            for (int i = 4; i < blocksize; i++)
                out[i] += 4 * out[i - 1] - 6 * out[i - 2]
                        + 4 * out[i - 3] - out[i - 4];
            break;
        }
    } else if (type & 0x20) {                // LPC
        int order = (type & 0x1F) + 1;
        if (order > blocksize) return false;  // crafted input: warmup OOB
        for (int i = 0; i < order; i++) out[i] = br.sbits(bps);
        int precision = br.bits(4) + 1;
        if (precision > 15 + 1) return false;
        int shift = br.sbits(5);
        if (shift < 0) return false;
        int32_t coef[32];
        for (int i = 0; i < order; i++) coef[i] = br.sbits(precision);
        if (!read_residual(br, blocksize, order, out)) return false;
        for (int i = order; i < blocksize; i++) {
            int64_t sum = 0;
            for (int j = 0; j < order; j++)
                sum += (int64_t)coef[j] * out[i - 1 - j];
            out[i] += (int32_t)(sum >> shift);
        }
    } else {
        return false;
    }
    if (wasted)
        for (int i = 0; i < blocksize; i++)
            out[i] = (int32_t)((uint32_t)out[i] << wasted);
    return !br.error;
}

// returns frames decoded in this frame, or -1
int decode_frame(BitReader& br, const StreamInfo& si, int32_t* out,
                 long long room) {
    // frame header: 14-bit sync
    if (br.bits(14) != 0x3FFE) return -1;
    br.bits(1);                               // reserved
    br.bits(1);                               // blocking strategy
    int bs_code = br.bits(4);
    int sr_code = br.bits(4);
    int ch_code = br.bits(4);
    int ss_code = br.bits(3);
    br.bits(1);                               // reserved
    // extended-UTF-8 coded frame/sample number (up to 7 bytes): skip
    uint32_t c0 = br.bits(8);
    int lead = 0;
    for (uint32_t m = 0x80; (c0 & m) && m; m >>= 1) lead++;
    for (int i = 0; i < lead - 1; i++) br.bits(8);

    int blocksize;
    switch (bs_code) {
    case 1: blocksize = 192; break;
    case 2: case 3: case 4: case 5:
        blocksize = 576 << (bs_code - 2); break;
    case 6: blocksize = (int)br.bits(8) + 1; break;
    case 7: blocksize = (int)br.bits(16) + 1; break;
    default:
        if (bs_code >= 8) blocksize = 256 << (bs_code - 8);
        else return -1;
    }
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    br.bits(8);                               // CRC-8 (not verified)

    int bps = si.bits;
    switch (ss_code) {
    case 0: break;
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return -1;
    }

    int nch = si.channels;
    static thread_local std::vector<int32_t> cbuf;
    if (ch_code <= 7) {
        if (ch_code + 1 != nch) return -1;
    } else if (nch != 2) {
        return -1;
    }
    cbuf.resize((size_t)nch * blocksize);

    if (ch_code <= 7) {
        for (int c = 0; c < nch; c++)
            if (!decode_subframe(br, blocksize, bps, &cbuf[(size_t)c * blocksize]))
                return -1;
    } else {
        int bps0 = bps + (ch_code == 9 ? 1 : 0);       // right/side: side first
        int bps1 = bps + (ch_code == 8 || ch_code == 10 ? 1 : 0);
        if (!decode_subframe(br, blocksize, bps0, &cbuf[0])) return -1;
        if (!decode_subframe(br, blocksize, bps1, &cbuf[blocksize])) return -1;
        int32_t* a = &cbuf[0];
        int32_t* b = &cbuf[blocksize];
        if (ch_code == 8) {                  // left/side -> L, R=L-S
            for (int i = 0; i < blocksize; i++) b[i] = a[i] - b[i];
        } else if (ch_code == 9) {           // side/right -> L=S+R
            for (int i = 0; i < blocksize; i++) a[i] = a[i] + b[i];
        } else if (ch_code == 10) {          // mid/side
            for (int i = 0; i < blocksize; i++) {
                int32_t mid = a[i], side = b[i];
                mid = (mid << 1) | (side & 1);
                a[i] = (mid + side) >> 1;
                b[i] = (mid - side) >> 1;
            }
        }
    }
    br.align();
    br.bits(16);                              // frame CRC-16 (not verified)
    if (br.error) return -1;

    long long n = blocksize;
    if (n > room) n = room;
    for (long long i = 0; i < n; i++)
        for (int c = 0; c < nch; c++)
            out[i * nch + c] = cbuf[(size_t)c * blocksize + i];
    return (int)n;
}

std::vector<uint8_t> read_file(const char* path) {
    std::vector<uint8_t> buf;
    FILE* f = fopen(path, "rb");
    if (!f) return buf;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (sz > 0) {
        buf.resize((size_t)sz);
        if (fread(buf.data(), 1, (size_t)sz, f) != (size_t)sz) buf.clear();
    }
    fclose(f);
    return buf;
}

}  // namespace

extern "C" {

int mm_flac_info(const char* path, int* rate, int* channels, int* bits,
                 long long* nframes) {
    std::vector<uint8_t> buf = read_file(path);
    StreamInfo si;
    if (buf.empty() || !parse_streaminfo(buf.data(), buf.size(), &si))
        return -1;
    *rate = si.rate;
    *channels = si.channels;
    *bits = si.bits;
    *nframes = si.total;
    return 0;
}

long long mm_flac_read(const char* path, int32_t* out, long long max_frames) {
    std::vector<uint8_t> buf = read_file(path);
    StreamInfo si;
    if (buf.empty() || !parse_streaminfo(buf.data(), buf.size(), &si))
        return -1;
    BitReader br{buf.data() + si.audio_start, buf.size() - si.audio_start};
    long long done = 0;
    while (done < max_frames && !br.at_end()) {
        int n = decode_frame(br, si, out + done * si.channels,
                             max_frames - done);
        if (n < 0) return done > 0 ? done : -1;
        done += n;
        if (n == 0) break;
    }
    return done;
}

}  // extern "C"
