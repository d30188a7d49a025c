// wavio.cpp — native WAV/RAW codec for the sigio layer.
//
// C++ counterpart of sigio/wavfile.py (which mirrors the role of the
// reference's libsndfile backend, reference: src/simpleaudio-sndfile.c).
// Deterministic output: fixed-size headers, no metadata chunks.
//
// Exposed as a C ABI for ctypes.  Build: see native/Makefile.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

#pragma pack(push, 1)
struct WavHeaderPCM {
    char riff[4];
    uint32_t riff_size;
    char wave[4];
    char fmt_[4];
    uint32_t fmt_size;
    uint16_t format_tag;
    uint16_t channels;
    uint32_t sample_rate;
    uint32_t byte_rate;
    uint16_t block_align;
    uint16_t bits;
};
struct ChunkHdr {
    char id[4];
    uint32_t size;
};
#pragma pack(pop)

constexpr uint16_t WAVE_PCM = 1;
constexpr uint16_t WAVE_IEEE_FLOAT = 3;

}  // namespace

extern "C" {

// ---- write ----------------------------------------------------------------
// fmt: 0 = S16, 1 = FLOAT32.  Returns frames written or -1.
long long mm_wav_write(const char* path, int rate, int channels, int fmt,
                       const void* data, long long nframes) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    const uint16_t tag = fmt ? WAVE_IEEE_FLOAT : WAVE_PCM;
    const uint16_t bits = fmt ? 32 : 16;
    const uint32_t block = channels * bits / 8;
    const uint32_t data_bytes = (uint32_t)(nframes * block);

    WavHeaderPCM hdr{};
    std::memcpy(hdr.riff, "RIFF", 4);
    std::memcpy(hdr.wave, "WAVE", 4);
    std::memcpy(hdr.fmt_, "fmt ", 4);
    hdr.fmt_size = 16;
    hdr.format_tag = tag;
    hdr.channels = (uint16_t)channels;
    hdr.sample_rate = (uint32_t)rate;
    hdr.byte_rate = rate * block;
    hdr.block_align = (uint16_t)block;
    hdr.bits = bits;

    // chunk layout matches sigio/wavfile.py: fmt [+ fact if float] + data
    uint32_t chunks_bytes = sizeof(ChunkHdr) + data_bytes;
    if (tag == WAVE_IEEE_FLOAT) chunks_bytes += sizeof(ChunkHdr) + 4;
    // riff_size counts everything after the 8-byte RIFF header; the
    // struct's first 8 bytes are that header
    hdr.riff_size = (sizeof(WavHeaderPCM) - 8) + chunks_bytes;

    if (std::fwrite(&hdr, sizeof(hdr), 1, f) != 1) { std::fclose(f); return -1; }
    if (tag == WAVE_IEEE_FLOAT) {
        ChunkHdr fact{{'f', 'a', 'c', 't'}, 4};
        uint32_t nf = (uint32_t)nframes;
        std::fwrite(&fact, sizeof(fact), 1, f);
        std::fwrite(&nf, 4, 1, f);
    }
    ChunkHdr dc{{'d', 'a', 't', 'a'}, data_bytes};
    std::fwrite(&dc, sizeof(dc), 1, f);
    long long wrote =
        (long long)std::fwrite(data, block, (size_t)nframes, f);
    std::fclose(f);
    return wrote;
}

// ---- read -----------------------------------------------------------------
// Parses the header.  Returns 0 ok, -1 error.  On success fills
// rate/channels/fmt (0 S16, 1 FLOAT32, 2 other-PCM-bits)/bits/nframes and
// data_offset (byte offset of sample data).
int mm_wav_read_info(const char* path, int* rate, int* channels, int* fmt,
                     int* bits_out, long long* nframes,
                     long long* data_offset) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char riff[4], wave[4];
    uint32_t riff_size;
    if (std::fread(riff, 4, 1, f) != 1 || std::memcmp(riff, "RIFF", 4) ||
        std::fread(&riff_size, 4, 1, f) != 1 ||
        std::fread(wave, 4, 1, f) != 1 || std::memcmp(wave, "WAVE", 4)) {
        std::fclose(f);
        return -1;
    }
    uint16_t tag = 0, nch = 0, bits = 0;
    uint32_t sr = 0;
    long long data_off = -1, data_sz = 0;
    for (;;) {
        ChunkHdr ch;
        if (std::fread(&ch, sizeof(ch), 1, f) != 1) break;
        if (!std::memcmp(ch.id, "fmt ", 4)) {
            if (ch.size < 16) break;          // truncated fmt chunk
            std::vector<uint8_t> body(ch.size);
            if (std::fread(body.data(), 1, ch.size, f) != ch.size) break;
            std::memcpy(&tag, body.data() + 0, 2);
            std::memcpy(&nch, body.data() + 2, 2);
            std::memcpy(&sr, body.data() + 4, 4);
            std::memcpy(&bits, body.data() + 14, 2);
            if (tag == 0xFFFE && ch.size >= 40)
                std::memcpy(&tag, body.data() + 24, 2);
            if (ch.size & 1) std::fseek(f, 1, SEEK_CUR);
        } else if (!std::memcmp(ch.id, "data", 4)) {
            data_off = std::ftell(f);
            data_sz = ch.size;
            break;
        } else {
            std::fseek(f, ch.size + (ch.size & 1), SEEK_CUR);
        }
    }
    std::fclose(f);
    if (data_off < 0 || nch == 0 || bits == 0) return -1;
    *rate = (int)sr;
    *channels = (int)nch;
    *bits_out = (int)bits;
    if (tag == WAVE_IEEE_FLOAT && bits == 32)
        *fmt = 1;
    else if (tag == WAVE_PCM && bits == 16)
        *fmt = 0;
    else if (tag == WAVE_PCM)
        *fmt = 2;
    else
        return -1;
    long long bytes_per_frame = (long long)nch * bits / 8;
    if (bytes_per_frame <= 0) return -1;      // e.g. PCM with bits < 8
    *nframes = data_sz / bytes_per_frame;
    *data_offset = data_off;
    return 0;
}

// Read raw sample bytes from data_offset.  Returns bytes read or -1.
long long mm_wav_read_data(const char* path, long long data_offset,
                           void* out, long long nbytes) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, (long)data_offset, SEEK_SET) != 0) {
        std::fclose(f);
        return -1;
    }
    long long n = (long long)std::fread(out, 1, (size_t)nbytes, f);
    std::fclose(f);
    return n;
}

}  // extern "C"
