// zstd frame decoder (RFC 8878) and CRC-32C, written out by hand.
//
// The orbax snapshots of the JAX package hold every zarr chunk as one zstd
// frame and every OCDBT manifest and b-tree node as a zstd frame sealed with
// a CRC-32C; this file reads both without libzstd (no zstd.h is included and
// no zstd library is linked).  It decodes raw, RLE and compressed blocks:
// literals raw, RLE, Huffman-coded with a tree (weights direct or
// FSE-compressed) or treeless, in one or four streams; sequences with
// predefined, RLE, FSE-compressed or repeated tables and the three repeat
// offsets; single-segment frames and frames with a window descriptor, with
// or without a content size or a content checksum (XXH64, verified);
// concatenated frames and skippable frames.  No dictionaries.
//
// The output goes into a caller-owned buffer of the size the caller knows
// (a zarr chunk's), so a chunk decodes straight into a tensor's memory.  Any
// malformed input returns -1 with the byte offset and a message; nothing is
// guessed.  ctypes releases the GIL around each call, so callers decode
// chunks in parallel on a thread pool.
//
// Exposed via ctypes (vitcap_tpu_torch/utils/orbax_state.py); built with
// g++ -O3 -shared by vitcap_tpu_torch/native/__init__.py at first use.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the decoder reads little-endian words directly");

namespace {

struct Fail {
    size_t off;
    std::string what;
};

[[noreturn]] void fail(size_t off, const std::string& what) {
    throw Fail{off, what};
}

// counters of what the input held, for tests that pin a corpus's coverage
enum Counter {
    C_FRAMES, C_SKIPPABLE, C_CHECKSUMS, C_RAW_BLOCKS, C_RLE_BLOCKS,
    C_COMPRESSED_BLOCKS, C_LIT_RAW, C_LIT_RLE, C_LIT_HUFFMAN, C_LIT_TREELESS,
    C_LIT_4STREAMS, C_HUF_FSE_WEIGHTS, C_HUF_DIRECT_WEIGHTS,
    C_SEQ_PREDEFINED, C_SEQ_RLE, C_SEQ_FSE, C_SEQ_REPEAT, C_SEQUENCES,
    C_COUNT
};

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

inline uint64_t load_le(const uint8_t* p, size_t n) {
    uint64_t v = 0;
    for (size_t i = 0; i < n; i++) v |= uint64_t(p[i]) << (8 * i);
    return v;
}

constexpr size_t BLOCK_MAX = 128 * 1024;
constexpr int HUF_MAX_BITS = 11;

// ---------------------------------------------------------------------------
// bit readers
// ---------------------------------------------------------------------------

// Forward, least significant bit first: the FSE table headers.
struct FwdBits {
    const uint8_t* p;
    size_t size, base;        // base: the section's offset in the input
    size_t bit = 0;
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++, bit++) {
            if ((bit >> 3) >= size)
                fail(base + size, "FSE table description runs past its "
                                  "section");
            v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1u) << i;
        }
        return v;
    }
    size_t bytes() const { return (bit + 7) >> 3; }
};

// Backward, from the end mark of the last byte towards the first byte: the
// Huffman streams, the Huffman weights and the sequences.  `pos` is the
// number of bits left; reads past the start see zeros and drive it below 0,
// which every caller checks.
struct BackBits {
    const uint8_t* p;
    size_t size, base;
    int64_t pos;
    void init(const uint8_t* src, size_t n, size_t base_) {
        p = src; size = n; base = base_;
        if (n == 0) fail(base, "empty bitstream");
        uint8_t last = src[n - 1];
        if (last == 0) fail(base + n - 1, "bitstream ends in a zero byte "
                                          "(no end mark)");
        pos = int64_t(n - 1) * 8 + highbit(last);
    }
    // the n bits (n <= 56) just below pos, most significant first
    inline uint64_t peek(int n) const {
        int64_t lo = pos - n;
        if (lo >= 0) {
            size_t byte = size_t(lo) >> 3;
            uint64_t w;
            if (byte + 8 <= size) std::memcpy(&w, p + byte, 8);
            else w = load_le(p + byte, size - byte);
            return (w >> (lo & 7)) & ((uint64_t(1) << n) - 1);
        }
        if (pos <= 0) return 0;
        uint64_t w = load_le(p, std::min<size_t>(size, 8));
        return (w & ((uint64_t(1) << pos) - 1)) << (-lo);
    }
    inline uint64_t read(int n) {
        if (n == 0) return 0;
        uint64_t v = peek(n);
        pos -= n;
        return v;
    }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct Fse {
    int al = -1;              // accuracy log; -1: no table yet
    uint8_t sym[512];
    uint8_t nb[512];
    uint16_t base[512];
};

void fse_build(Fse& t, const int16_t* norm, int nsym, int al, size_t off) {
    const uint32_t size = 1u << al;
    uint16_t next[256];
    uint32_t high = size;
    for (int s = 0; s < nsym; s++)
        if (norm[s] == -1) {
            t.sym[--high] = uint8_t(s);
            next[s] = 1;
        }
    const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    uint32_t pos = 0;
    for (int s = 0; s < nsym; s++) {
        if (norm[s] <= 0) continue;
        next[s] = uint16_t(norm[s]);
        for (int i = 0; i < norm[s]; i++) {
            t.sym[pos] = uint8_t(s);
            do { pos = (pos + step) & mask; } while (pos >= high);
        }
    }
    if (pos != 0) fail(off, "FSE distribution does not fill its table");
    for (uint32_t i = 0; i < size; i++) {
        uint16_t d = next[t.sym[i]]++;
        int nb = al - highbit(d);
        t.nb[i] = uint8_t(nb);
        t.base[i] = uint16_t((uint32_t(d) << nb) - size);
    }
    t.al = al;
}

// An FSE table description (RFC 8878 4.1.1); returns the bytes it took.
size_t fse_read(Fse& t, const uint8_t* src, size_t n, size_t base,
                int max_sym, int max_al) {
    FwdBits in{src, n, base};
    int al = 5 + int(in.read(4));
    if (al > max_al)
        fail(base, "FSE accuracy log " + std::to_string(al) + " above " +
                       std::to_string(max_al));
    int16_t norm[256];
    int32_t remaining = 1 << al;
    int s = 0;
    while (remaining > 0 && s <= max_sym) {
        int bits = highbit(uint32_t(remaining + 1)) + 1;
        uint32_t val = in.read(bits);
        uint32_t low = (1u << (bits - 1)) - 1;
        uint32_t thr = (1u << bits) - 1 - uint32_t(remaining + 1);
        if ((val & low) < thr) {
            in.bit -= 1;
            val &= low;
        } else if (val > low) {
            val -= thr;
        }
        int proba = int(val) - 1;
        remaining -= proba < 0 ? -proba : proba;
        norm[s++] = int16_t(proba);
        if (proba == 0) {
            uint32_t rep = in.read(2);
            for (;;) {
                for (uint32_t i = 0; i < rep && s <= max_sym; i++)
                    norm[s++] = 0;
                if (rep != 3) break;
                rep = in.read(2);
            }
        }
    }
    if (remaining != 0)
        fail(base, "FSE probabilities do not sum to the table size");
    if (s > max_sym + 1) fail(base, "FSE table has too many symbols");
    fse_build(t, norm, s, al, base);
    return in.bytes();
}

void fse_rle(Fse& t, uint8_t symbol) {
    t.al = 0;
    t.sym[0] = symbol;
    t.nb[0] = 0;
    t.base[0] = 0;
}

// ---------------------------------------------------------------------------
// Huffman
// ---------------------------------------------------------------------------

struct Huf {
    int max_bits = 0;          // 0: no table yet
    uint16_t dt[1 << HUF_MAX_BITS];   // symbol | bits << 8
};

// A Huffman tree description (RFC 8878 4.2.1); returns the bytes it took.
size_t huf_read(Huf& h, const uint8_t* src, size_t n, size_t base,
                uint64_t* counts) {
    if (n < 1) fail(base, "missing Huffman tree description");
    uint8_t w[256];
    int nw = 0;
    size_t used;
    uint8_t hb = src[0];
    if (hb >= 128) {
        nw = hb - 127;
        size_t bytes = (size_t(nw) + 1) / 2;
        if (1 + bytes > n) fail(base, "Huffman weights past the block");
        for (int i = 0; i < nw; i++) {
            uint8_t b = src[1 + i / 2];
            w[i] = (i & 1) ? (b & 15) : (b >> 4);
        }
        used = 1 + bytes;
        counts[C_HUF_DIRECT_WEIGHTS]++;
    } else {
        size_t csize = hb;
        if (csize == 0 || 1 + csize > n)
            fail(base, "Huffman weights' size " + std::to_string(csize) +
                           " does not fit the block");
        Fse t;
        size_t hdr = fse_read(t, src + 1, csize, base + 1, 255, 6);
        if (hdr >= csize) fail(base + 1, "no Huffman weight stream");
        BackBits bb;
        bb.init(src + 1 + hdr, csize - hdr, base + 1 + hdr);
        uint32_t s1 = uint32_t(bb.read(t.al)), s2 = uint32_t(bb.read(t.al));
        for (;;) {
            if (nw > 253) fail(base, "too many Huffman weights");
            w[nw++] = t.sym[s1];
            s1 = t.base[s1] + uint32_t(bb.read(t.nb[s1]));
            if (bb.pos < 0) { w[nw++] = t.sym[s2]; break; }
            w[nw++] = t.sym[s2];
            s2 = t.base[s2] + uint32_t(bb.read(t.nb[s2]));
            if (bb.pos < 0) { w[nw++] = t.sym[s1]; break; }
        }
        used = 1 + csize;
        counts[C_HUF_FSE_WEIGHTS]++;
    }
    uint32_t sum = 0;
    for (int i = 0; i < nw; i++) {
        if (w[i] > HUF_MAX_BITS) fail(base, "Huffman weight above 11");
        if (w[i]) sum += 1u << (w[i] - 1);
    }
    if (sum == 0) fail(base, "Huffman weights all zero");
    int max_bits = highbit(sum) + 1;
    if (max_bits > HUF_MAX_BITS) fail(base, "Huffman code longer than 11");
    uint32_t left = (1u << max_bits) - sum;
    if (left & (left - 1))
        fail(base, "Huffman weights leave no power of two for the last");
    if (nw >= 256) fail(base, "too many Huffman symbols");
    w[nw++] = uint8_t(highbit(left) + 1);
    uint32_t pos = 0;
    for (int wt = 1; wt <= max_bits; wt++)
        for (int s = 0; s < nw; s++)
            if (w[s] == wt) {
                uint16_t e = uint16_t(s | ((max_bits + 1 - wt) << 8));
                uint32_t len = 1u << (wt - 1);
                std::fill(h.dt + pos, h.dt + pos + len, e);
                pos += len;
            }
    h.max_bits = max_bits;
    return used;
}

// k (1 or 4) Huffman streams into out[i][0..count[i]).  While every stream
// has 8 bytes left the streams decode interleaved from a 64-bit container
// each (four independent dependency chains); the last bytes of each go
// through BackBits, which sees zeros past the start.
void huf_streams(const Huf& h, int k, const uint8_t* const* src,
                 const size_t* n, const size_t* base, uint8_t* const* out,
                 const size_t* count) {
    const int mb = h.max_bits;
    const uint16_t* dt = h.dt;
    BackBits bb[4];
    size_t done[4] = {0, 0, 0, 0};
    for (int i = 0; i < k; i++) bb[i].init(src[i], n[i], base[i]);
    bool fast = true;
    for (int i = 0; i < k; i++) fast = fast && n[i] >= 8;
    if (fast) {
        const uint8_t* ptr[4];
        uint64_t c[4];
        unsigned used[4];
        for (int i = 0; i < k; i++) {
            ptr[i] = src[i] + n[i] - 8;
            std::memcpy(&c[i], ptr[i], 8);
            used[i] = unsigned(64 - (bb[i].pos - int64_t(n[i] - 8) * 8));
        }
        // 4 symbols of at most 11 bits after a reload leaves <= 7 used
        for (;;) {
            bool go = true;
            for (int i = 0; i < k; i++)
                go = go && ptr[i] >= src[i] + 8 && count[i] - done[i] >= 4;
            if (!go) break;
            for (int r = 0; r < 4; r++)
                for (int i = 0; i < k; i++) {
                    uint16_t e = dt[(c[i] << used[i]) >> (64 - mb)];
                    out[i][done[i] + r] = uint8_t(e);
                    used[i] += e >> 8;
                }
            for (int i = 0; i < k; i++) {
                done[i] += 4;
                ptr[i] -= used[i] >> 3;
                used[i] &= 7;
                std::memcpy(&c[i], ptr[i], 8);
            }
        }
        for (int i = 0; i < k; i++)
            bb[i].pos = int64_t(ptr[i] - src[i]) * 8 + 64 - used[i];
    }
    for (int i = 0; i < k; i++) {
        BackBits& b = bb[i];
        for (size_t j = done[i]; j < count[i]; j++) {
            uint16_t e = dt[b.peek(mb)];
            out[i][j] = uint8_t(e);
            b.pos -= e >> 8;
        }
        if (b.pos != 0)
            fail(base[i], b.pos > 0 ? "Huffman stream has bits left over"
                                    : "Huffman stream read past its start");
    }
}

// ---------------------------------------------------------------------------
// sequences
// ---------------------------------------------------------------------------

const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,    9,    10,   11,
    12, 13, 14, 15, 16, 18, 20, 22, 24,   28,   32,   40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct Defaults {
    Fse ll, ml, of;
    Defaults() {
        fse_build(ll, LL_DEFAULT, 36, 6, 0);
        fse_build(ml, ML_DEFAULT, 53, 6, 0);
        fse_build(of, OF_DEFAULT, 29, 5, 0);
    }
};
const Defaults& defaults() {
    static const Defaults d;
    return d;
}

// What a frame carries from block to block.
struct FrameState {
    Huf huf;
    Fse ll, ml, of;
    uint32_t rep[3] = {1, 4, 8};
    uint8_t lit[BLOCK_MAX + 64];
};

// One of the three tables of a sequences section; returns the bytes it took.
size_t seq_table(Fse& t, int mode, const Fse& def, const uint8_t* src,
                 size_t n, size_t base, int max_sym, int max_al,
                 uint64_t* counts, const char* name) {
    switch (mode) {
    case 0:
        t = def;
        counts[C_SEQ_PREDEFINED]++;
        return 0;
    case 1:
        if (n < 1) fail(base, std::string(name) + " RLE symbol missing");
        if (src[0] > max_sym)
            fail(base, std::string(name) + " RLE symbol out of range");
        fse_rle(t, src[0]);
        counts[C_SEQ_RLE]++;
        return 1;
    case 2:
        counts[C_SEQ_FSE]++;
        return fse_read(t, src, n, base, max_sym, max_al);
    default:
        if (t.al < 0)
            fail(base, std::string(name) + " repeat mode without a table");
        counts[C_SEQ_REPEAT]++;
        return 0;
    }
}

// ---------------------------------------------------------------------------
// blocks and frames
// ---------------------------------------------------------------------------

struct Out {
    uint8_t* dst;
    size_t cap, pos, frame_start;
    void need(size_t n, size_t off) {
        if (n > cap - pos)
            fail(off, "output larger than the " + std::to_string(cap) +
                          "-byte buffer");
    }
};

// The literals section: returns the bytes it took; `lit`/`nlit` the
// literals (in the input for raw ones, else in fs.lit).
size_t literals(FrameState& fs, const uint8_t* src, size_t n, size_t base,
                const uint8_t*& lit, size_t& nlit, uint64_t* counts) {
    if (n < 1) fail(base, "empty compressed block");
    int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
    if (type <= 1) {
        size_t hdr, regen;
        if (fmt == 0 || fmt == 2) {
            hdr = 1;
            regen = src[0] >> 3;
        } else if (fmt == 1) {
            hdr = 2;
            if (n < 2) fail(base, "literals header truncated");
            regen = (src[0] >> 4) + (size_t(src[1]) << 4);
        } else {
            hdr = 3;
            if (n < 3) fail(base, "literals header truncated");
            regen = (src[0] >> 4) + (size_t(src[1]) << 4) +
                    (size_t(src[2]) << 12);
        }
        if (regen > BLOCK_MAX) fail(base, "literals above 128 KiB");
        nlit = regen;
        if (type == 0) {
            if (hdr + regen > n) fail(base, "raw literals past the block");
            lit = src + hdr;
            counts[C_LIT_RAW]++;
            return hdr + regen;
        }
        if (hdr + 1 > n) fail(base, "RLE literal byte missing");
        std::memset(fs.lit, src[hdr], regen);
        lit = fs.lit;
        counts[C_LIT_RLE]++;
        return hdr + 1;
    }
    size_t hdr = fmt <= 1 ? 3 : (fmt == 2 ? 4 : 5);
    int bits = fmt <= 1 ? 10 : (fmt == 2 ? 14 : 18);
    if (n < hdr) fail(base, "literals header truncated");
    uint64_t v = load_le(src, hdr);
    size_t regen = (v >> 4) & ((1u << bits) - 1);
    size_t csize = (v >> (4 + bits)) & ((1u << bits) - 1);
    bool four = fmt != 0;
    if (regen > BLOCK_MAX) fail(base, "literals above 128 KiB");
    if (hdr + csize > n) fail(base, "compressed literals past the block");
    const uint8_t* p = src + hdr;
    size_t pb = base + hdr, left = csize;
    if (type == 2) {
        size_t t = huf_read(fs.huf, p, left, pb, counts);
        p += t; pb += t; left -= t;
        counts[C_LIT_HUFFMAN]++;
    } else {
        if (fs.huf.max_bits == 0)
            fail(base, "treeless literals without an earlier Huffman tree");
        counts[C_LIT_TREELESS]++;
    }
    if (!four) {
        uint8_t* o = fs.lit;
        huf_streams(fs.huf, 1, &p, &left, &pb, &o, &regen);
    } else {
        counts[C_LIT_4STREAMS]++;
        if (left < 6) fail(pb, "jump table truncated");
        size_t sz[4] = {size_t(load_le(p, 2)), size_t(load_le(p + 2, 2)),
                        size_t(load_le(p + 4, 2)), 0};
        if (6 + sz[0] + sz[1] + sz[2] > left)
            fail(pb, "jump table past the block");
        sz[3] = left - 6 - sz[0] - sz[1] - sz[2];
        size_t seg = (regen + 3) / 4;
        if (3 * seg > regen) fail(base, "too few literals for 4 streams");
        const uint8_t* q[4];
        size_t qb[4];
        uint8_t* o[4];
        size_t cnt[4] = {seg, seg, seg, regen - 3 * seg};
        size_t at = 6;
        for (int i = 0; i < 4; i++) {
            q[i] = p + at;
            qb[i] = pb + at;
            o[i] = fs.lit + i * seg;
            at += sz[i];
        }
        huf_streams(fs.huf, 4, q, sz, qb, o, cnt);
    }
    lit = fs.lit;
    nlit = regen;
    return hdr + csize;
}

inline void copy_match(uint8_t* d, size_t off, size_t len) {
    const uint8_t* s = d - off;
    if (off >= len) {
        std::memcpy(d, s, len);
    } else if (off >= 8) {
        while (len >= 8) { std::memcpy(d, s, 8); d += 8; s += 8; len -= 8; }
        while (len--) *d++ = *s++;
    } else {
        while (len--) *d++ = *s++;
    }
}

void compressed_block(FrameState& fs, const uint8_t* src, size_t n,
                      size_t base, Out& out, uint64_t* counts) {
    const uint8_t* lit;
    size_t nlit;
    size_t used = literals(fs, src, n, base, lit, nlit, counts);
    const uint8_t* p = src + used;
    size_t pb = base + used, left = n - used;
    if (left < 1) fail(pb, "sequences section missing");
    size_t nseq, h;
    if (p[0] < 128) { nseq = p[0]; h = 1; }
    else if (p[0] < 255) {
        if (left < 2) fail(pb, "sequences header truncated");
        nseq = ((size_t(p[0]) - 128) << 8) + p[1]; h = 2;
    } else {
        if (left < 3) fail(pb, "sequences header truncated");
        nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00; h = 3;
    }
    p += h; pb += h; left -= h;
    if (nseq == 0) {
        if (left != 0) fail(pb, "bytes after a block without sequences");
        out.need(nlit, pb);
        std::memcpy(out.dst + out.pos, lit, nlit);
        out.pos += nlit;
        return;
    }
    if (left < 1) fail(pb, "symbol compression modes missing");
    uint8_t modes = p[0];
    if (modes & 3) fail(pb, "reserved bits of the compression modes set");
    p++; pb++; left--;
    const Defaults& d = defaults();
    size_t t = seq_table(fs.ll, modes >> 6, d.ll, p, left, pb, 35, 9,
                         counts, "literal lengths");
    p += t; pb += t; left -= t;
    t = seq_table(fs.of, (modes >> 4) & 3, d.of, p, left, pb, 31, 8, counts,
                  "offsets");
    p += t; pb += t; left -= t;
    t = seq_table(fs.ml, (modes >> 2) & 3, d.ml, p, left, pb, 52, 9, counts,
                  "match lengths");
    p += t; pb += t; left -= t;
    counts[C_SEQUENCES] += nseq;

    BackBits bb;
    bb.init(p, left, pb);
    uint32_t sl = uint32_t(bb.read(fs.ll.al));
    uint32_t so = uint32_t(bb.read(fs.of.al));
    uint32_t sm = uint32_t(bb.read(fs.ml.al));
    const uint8_t* lend = lit + nlit;
    for (size_t i = 0; i < nseq; i++) {
        uint8_t llc = fs.ll.sym[sl], ofc = fs.of.sym[so], mlc = fs.ml.sym[sm];
        if (ofc > 31) fail(pb, "offset code above 31");
        if (llc > 35 || mlc > 52) fail(pb, "length code out of range");
        uint64_t ofv = (uint64_t(1) << ofc) + bb.read(ofc);
        size_t ml = ML_BASE[mlc] + size_t(bb.read(ML_BITS[mlc]));
        size_t ll = LL_BASE[llc] + size_t(bb.read(LL_BITS[llc]));
        if (bb.pos < 0) fail(pb, "sequences bitstream read past its start");
        size_t offset;
        uint32_t* rep = fs.rep;
        if (ofv > 3) {
            offset = size_t(ofv - 3);
            rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = uint32_t(offset);
        } else {
            int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
            if (idx == 0) {
                offset = rep[0];
            } else {
                offset = idx == 3 ? size_t(rep[0]) - 1 : rep[idx];
                if (idx != 1) rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = uint32_t(offset);
            }
        }
        if (ll > size_t(lend - lit))
            fail(pb, "sequence takes more literals than the block has");
        out.need(ll + ml, pb);
        uint8_t* o = out.dst + out.pos;
        std::memcpy(o, lit, ll);
        lit += ll;
        o += ll;
        if (offset == 0 || offset > size_t(o - (out.dst + out.frame_start)))
            fail(pb, "match offset " + std::to_string(offset) +
                         " before the frame's start");
        copy_match(o, offset, ml);
        out.pos += ll + ml;
        if (i + 1 < nseq) {
            sl = fs.ll.base[sl] + uint32_t(bb.read(fs.ll.nb[sl]));
            sm = fs.ml.base[sm] + uint32_t(bb.read(fs.ml.nb[sm]));
            so = fs.of.base[so] + uint32_t(bb.read(fs.of.nb[so]));
        }
    }
    if (bb.pos != 0)
        fail(pb, bb.pos > 0 ? "sequences bitstream has bits left over"
                            : "sequences bitstream read past its start");
    size_t rest = size_t(lend - lit);
    out.need(rest, pb);
    std::memcpy(out.dst + out.pos, lit, rest);
    out.pos += rest;
}

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* p, size_t len) {
    const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
    auto round = [&](uint64_t acc, uint64_t in) {
        acc += in * P2;
        acc = rotl(acc, 31);
        return acc * P1;
    };
    auto merge = [&](uint64_t acc, uint64_t v) {
        acc ^= round(0, v);
        return acc * P1 + P4;
    };
    const uint8_t* end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = uint64_t(0) - P1;
        while (end - p >= 32) {
            uint64_t w[4];
            std::memcpy(w, p, 32);
            v1 = round(v1, w[0]); v2 = round(v2, w[1]);
            v3 = round(v3, w[2]); v4 = round(v4, w[3]);
            p += 32;
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = merge(h, v1); h = merge(h, v2); h = merge(h, v3); h = merge(h, v4);
    } else {
        h = P5;
    }
    h += len;
    while (end - p >= 8) {
        uint64_t k;
        std::memcpy(&k, p, 8);
        h ^= round(0, k);
        h = rotl(h, 27) * P1 + P4;
        p += 8;
    }
    if (end - p >= 4) {
        uint32_t k;
        std::memcpy(&k, p, 4);
        h ^= uint64_t(k) * P1;
        h = rotl(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= uint64_t(*p++) * P5;
        h = rotl(h, 11) * P1;
    }
    h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
    return h;
}

// One frame (or a skippable frame) at src[0..n); returns the bytes it took.
size_t frame(const uint8_t* src, size_t n, size_t base, Out& out,
             uint64_t* counts) {
    if (n < 4) fail(base, "truncated frame magic");
    uint32_t magic = uint32_t(load_le(src, 4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (n < 8) fail(base, "truncated skippable frame");
        uint64_t sz = load_le(src + 4, 4);
        if (8 + sz > n) fail(base, "skippable frame past the input");
        counts[C_SKIPPABLE]++;
        return size_t(8 + sz);
    }
    if (magic != 0xFD2FB528u)
        fail(base, "not a zstd frame (magic " + std::to_string(magic) + ")");
    if (n < 5) fail(base + 4, "truncated frame header");
    uint8_t fhd = src[4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
        dict_flag = fhd & 3;
    if (fhd & 8) fail(base + 4, "reserved bit of the frame header set");
    size_t pos = 5;
    if (!single) {
        if (pos >= n) fail(base + pos, "truncated window descriptor");
        pos++;               // the window only bounds a streaming decoder
    }
    static const int DID[4] = {0, 1, 2, 4}, FCS[4] = {0, 2, 4, 8};
    size_t did = DID[dict_flag];
    size_t fcs = (fcs_flag == 0 && single) ? 1 : FCS[fcs_flag];
    if (pos + did + fcs > n) fail(base + pos, "truncated frame header");
    if (did && load_le(src + pos, did) != 0)
        fail(base + pos, "frame needs a dictionary");
    pos += did;
    uint64_t content = UINT64_MAX;
    if (fcs) {
        content = load_le(src + pos, fcs);
        if (fcs == 2) content += 256;
    }
    pos += fcs;
    counts[C_FRAMES]++;
    out.frame_start = out.pos;
    if (content != UINT64_MAX) out.need(size_t(content), base + 5);
    FrameState* fs = new FrameState();   // 128 KiB of literals: not on stack
    try {
        for (;;) {
            if (pos + 3 > n) fail(base + pos, "truncated block header");
            uint32_t bh = uint32_t(load_le(src + pos, 3));
            size_t hb = base + pos;
            pos += 3;
            bool last = bh & 1;
            int type = (bh >> 1) & 3;
            size_t size = bh >> 3;
            if (type == 0) {
                if (pos + size > n) fail(hb, "raw block past the input");
                out.need(size, hb);
                std::memcpy(out.dst + out.pos, src + pos, size);
                out.pos += size;
                pos += size;
                counts[C_RAW_BLOCKS]++;
            } else if (type == 1) {
                if (pos + 1 > n) fail(hb, "RLE block past the input");
                out.need(size, hb);
                std::memset(out.dst + out.pos, src[pos], size);
                out.pos += size;
                pos += 1;
                counts[C_RLE_BLOCKS]++;
            } else if (type == 2) {
                if (size > BLOCK_MAX) fail(hb, "compressed block above 128 KiB");
                if (pos + size > n) fail(hb, "compressed block past the input");
                compressed_block(*fs, src + pos, size, base + pos, out, counts);
                pos += size;
                counts[C_COMPRESSED_BLOCKS]++;
            } else {
                fail(hb, "reserved block type");
            }
            if (last) break;
        }
    } catch (...) {
        delete fs;
        throw;
    }
    delete fs;
    size_t got = out.pos - out.frame_start;
    if (content != UINT64_MAX && got != content)
        fail(base, "frame decoded to " + std::to_string(got) +
                       " bytes, its header says " + std::to_string(content));
    if (checksum) {
        if (pos + 4 > n) fail(base + pos, "truncated content checksum");
        uint32_t want = uint32_t(load_le(src + pos, 4));
        uint32_t have = uint32_t(xxh64(out.dst + out.frame_start, got));
        if (want != have) fail(base + pos, "content checksum mismatch");
        pos += 4;
        counts[C_CHECKSUMS]++;
    }
    return pos;
}

uint32_t CRC_TABLE[8][256];
struct CrcInit {
    CrcInit() {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t c = i;
            for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
            CRC_TABLE[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; i++)
            for (int t = 1; t < 8; t++)
                CRC_TABLE[t][i] = (CRC_TABLE[t - 1][i] >> 8) ^
                                  CRC_TABLE[0][CRC_TABLE[t - 1][i] & 0xFF];
    }
} crc_init;

void set_msg(char* msg, size_t cap, const std::string& s) {
    if (msg && cap) std::snprintf(msg, cap, "%s", s.c_str());
}

}  // namespace

extern "C" {

// Decode every frame of src[0..n) into dst[0..cap).  Returns 0 and the bytes
// written in *written, or -1 with the offending byte offset in *err_off and a
// message in msg.  counts (may be null) gains C_COUNT counters.
int vc_zstd_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap,
                   size_t* written, size_t* err_off, uint64_t* counts,
                   char* msg, size_t msg_cap) {
    uint64_t local[C_COUNT] = {0};
    Out out{dst, cap, 0, 0};
    try {
        if (n == 0) fail(0, "empty input");
        size_t pos = 0;
        while (pos < n) pos += frame(src + pos, n - pos, pos, out, local);
    } catch (const Fail& f) {
        *err_off = f.off;
        set_msg(msg, msg_cap, f.what);
        return -1;
    } catch (const std::bad_alloc&) {
        *err_off = 0;
        set_msg(msg, msg_cap, "out of memory");
        return -1;
    }
    *written = out.pos;
    if (counts)
        for (int i = 0; i < C_COUNT; i++) counts[i] += local[i];
    return 0;
}

int vc_zstd_counter_count() { return C_COUNT; }

// CRC-32C (Castagnoli) of p[0..n), continuing from crc (0 to start).
uint32_t vc_crc32c(const uint8_t* p, size_t n, uint32_t crc) {
    crc = ~crc;
    while (n >= 8) {
        uint64_t w;
        std::memcpy(&w, p, 8);
        w ^= crc;
        crc = CRC_TABLE[7][w & 0xFF] ^ CRC_TABLE[6][(w >> 8) & 0xFF] ^
              CRC_TABLE[5][(w >> 16) & 0xFF] ^ CRC_TABLE[4][(w >> 24) & 0xFF] ^
              CRC_TABLE[3][(w >> 32) & 0xFF] ^ CRC_TABLE[2][(w >> 40) & 0xFF] ^
              CRC_TABLE[1][(w >> 48) & 0xFF] ^ CRC_TABLE[0][w >> 56];
        p += 8;
        n -= 8;
    }
    while (n--) crc = (crc >> 8) ^ CRC_TABLE[0][(crc ^ *p++) & 0xFF];
    return ~crc;
}

}  // extern "C"
