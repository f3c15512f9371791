// pinot_tpu_torch native host runtime: a copy of the JAX package's
// native library (same C ABI, same byte layouts), built at first use with
// g++ by ``pinot_tpu_torch/native/__init__.py``.
//
// Reference parity: the "native" surface of the reference (SURVEY.md
// section 2.9) — off-heap buffers (pinot-segment-spi/.../memory/
// PinotDataBuffer.java:60, LArray JNI mmap / Unsafe), JNI-backed
// compression jars (zstd-jni, lz4-java wired in pinot-segment-local/
// .../io/compression/), and pure-Java bit-unpacking
// (FixedBitSVForwardIndexReaderV2). Here those become one C++ shared
// library bound via ctypes:
//   - fixed-bit pack/unpack for dictionary-id forward indexes
//     (ceil(log2(card)) bits per value, byte stream), feeding int32
//     device uploads;
//   - chunked ZLIB/ZSTD codecs for raw column files (LZ4 and SNAPPY
//     block formats are implemented below without a library);
//   - mmap open/close helpers.
// Built with -DPINOT_NO_ZSTD where zstd's header or library is missing:
// the zstd entry points are then absent and the Python side refuses the
// ZSTD codec instead of writing another stream under its name.
// All functions are plain C ABI.

#include <cstdint>
#include <cstring>
#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>

#include <zlib.h>
#ifndef PINOT_NO_ZSTD
#include <zstd.h>
#endif

extern "C" {

// --------------------------------------------------------------------------
// fixed-bit packing (FixedBitSVForwardIndexReaderV2 analog)
// --------------------------------------------------------------------------

// pack n int32 values of `bits` bits each into dst (little-endian bit
// order within the stream); returns bytes written. The reference sets
// the stream bit by bit; this shifts each value's low `bits` bits into
// a 64-bit accumulator and stores whole bytes, the same bytes in a
// fraction of the time (at most 7 + 32 bits are ever pending).
int64_t fixedbit_pack(const int32_t* src, int64_t n, int bits,
                      uint8_t* dst) {
    const int64_t total_bytes = (n * (int64_t)bits + 7) / 8;
    const uint64_t mask = (bits >= 32) ? 0xffffffffull
                                       : ((1ull << bits) - 1ull);
    uint64_t acc = 0;
    int pending = 0;
    int64_t o = 0;
    for (int64_t i = 0; i < n; ++i) {
        acc |= ((uint64_t)(uint32_t)src[i] & mask) << pending;
        pending += bits;
        while (pending >= 8) {
            dst[o++] = (uint8_t)acc;
            acc >>= 8;
            pending -= 8;
        }
    }
    if (pending > 0) dst[o++] = (uint8_t)acc;
    return total_bytes;
}

// unpack n values of `bits` bits from src into int32 dst
void fixedbit_unpack(const uint8_t* src, int64_t n, int bits,
                     int32_t* dst) {
    const uint32_t mask = (bits >= 32) ? 0xffffffffu
                                       : ((1u << bits) - 1u);
    for (int64_t i = 0; i < n; ++i) {
        int64_t bitpos = i * (int64_t)bits;
        int64_t byte = bitpos >> 3;
        int shift = (int)(bitpos & 7);
        // read up to 8 bytes covering the value
        uint64_t window = 0;
        memcpy(&window, src + byte, 8);  // caller pads the buffer tail
        dst[i] = (int32_t)((window >> shift) & mask);
    }
}

// --------------------------------------------------------------------------
// chunk codecs (io/compression analog; ZLIB ~ GZIP, ZSTD ~ ZSTANDARD)
// --------------------------------------------------------------------------

int64_t zlib_compress_chunk(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, int level) {
    uLongf out = (uLongf)cap;
    int rc = compress2(dst, &out, src, (uLong)n, level);
    return rc == Z_OK ? (int64_t)out : -1;
}

int64_t zlib_decompress_chunk(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap) {
    uLongf out = (uLongf)cap;
    int rc = uncompress(dst, &out, src, (uLong)n);
    return rc == Z_OK ? (int64_t)out : -1;
}

#ifndef PINOT_NO_ZSTD
int64_t zstd_compress_chunk(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, int level) {
    size_t out = ZSTD_compress(dst, (size_t)cap, src, (size_t)n, level);
    return ZSTD_isError(out) ? -1 : (int64_t)out;
}

int64_t zstd_decompress_chunk(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap) {
    size_t out = ZSTD_decompress(dst, (size_t)cap, src, (size_t)n);
    return ZSTD_isError(out) ? -1 : (int64_t)out;
}

#endif  // PINOT_NO_ZSTD

int64_t compress_bound(int64_t n) {
    uLong zb = compressBound((uLong)n);
#ifndef PINOT_NO_ZSTD
    size_t sb = ZSTD_compressBound((size_t)n);
#else
    size_t sb = 0;
#endif
    int64_t lb = n + n / 255 + 16;  // LZ4 worst case (incompressible)
    int64_t nb = 32 + n + n / 6;    // snappy documented worst case
    int64_t m = (int64_t)(zb > sb ? zb : sb);
    if (lb > m) m = lb;
    return nb > m ? nb : m;
}

// --------------------------------------------------------------------------
// LZ4 block format (lz4-java analog; spec: 4-bit literal/match token,
// 2-byte little-endian offsets, minmatch 4). Self-contained greedy
// hash-table compressor + branchy-but-safe decompressor — no external
// lz4 dependency exists in this image, and the block format is simple
// enough that a correct from-scratch implementation beats gating the
// codec away.
// --------------------------------------------------------------------------

static inline uint32_t lz4_hash(uint32_t seq) {
    return (seq * 2654435761u) >> 18;  // 14-bit table
}

int64_t lz4_compress_chunk(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap, int /*level*/) {
    const int64_t MINMATCH = 4, MFLIMIT = 12, LASTLITERALS = 5;
    int32_t table[1 << 14];
    for (int i = 0; i < (1 << 14); ++i) table[i] = -1;
    int64_t ip = 0, op = 0, anchor = 0;
    if (n >= MFLIMIT) {
        const int64_t mflimit = n - MFLIMIT;
        while (ip <= mflimit) {
            uint32_t seq;
            memcpy(&seq, src + ip, 4);
            uint32_t h = lz4_hash(seq);
            int64_t ref = table[h];
            table[h] = (int32_t)ip;
            uint32_t refseq;
            if (ref < 0 || ip - ref > 65535 ||
                (memcpy(&refseq, src + ref, 4), refseq != seq)) {
                ++ip;
                continue;
            }
            // extend the match forward (stay clear of the last literals)
            int64_t mlen = MINMATCH;
            const int64_t limit = n - LASTLITERALS;
            while (ip + mlen < limit && src[ip + mlen] == src[ref + mlen])
                ++mlen;
            int64_t litlen = ip - anchor;
            // token + extended literal lengths + literals + offset +
            // extended match lengths must fit
            if (op + 1 + litlen + (litlen / 255 + 1) + 2 +
                (mlen / 255 + 1) + LASTLITERALS > cap)
                return -1;
            uint8_t* token = dst + op++;
            if (litlen >= 15) {
                *token = (uint8_t)(15 << 4);
                int64_t rem = litlen - 15;
                for (; rem >= 255; rem -= 255) dst[op++] = 255;
                dst[op++] = (uint8_t)rem;
            } else {
                *token = (uint8_t)(litlen << 4);
            }
            memcpy(dst + op, src + anchor, (size_t)litlen);
            op += litlen;
            uint16_t off = (uint16_t)(ip - ref);
            dst[op++] = (uint8_t)(off & 0xff);
            dst[op++] = (uint8_t)(off >> 8);
            int64_t mcode = mlen - MINMATCH;
            if (mcode >= 15) {
                *token |= 15;
                mcode -= 15;
                for (; mcode >= 255; mcode -= 255) dst[op++] = 255;
                dst[op++] = (uint8_t)mcode;
            } else {
                *token |= (uint8_t)mcode;
            }
            ip += mlen;
            anchor = ip;
        }
    }
    // final literal run
    int64_t litlen = n - anchor;
    if (op + 1 + litlen + litlen / 255 + 1 > cap) return -1;
    uint8_t* token = dst + op++;
    if (litlen >= 15) {
        *token = (uint8_t)(15 << 4);
        int64_t rem = litlen - 15;
        for (; rem >= 255; rem -= 255) dst[op++] = 255;
        dst[op++] = (uint8_t)rem;
    } else {
        *token = (uint8_t)(litlen << 4);
    }
    memcpy(dst + op, src + anchor, (size_t)litlen);
    op += litlen;
    return op;
}

int64_t lz4_decompress_chunk(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t cap) {
    int64_t ip = 0, op = 0;
    while (ip < n) {
        uint8_t token = src[ip++];
        int64_t litlen = token >> 4;
        if (litlen == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                litlen += b;
            } while (b == 255);
        }
        if (ip + litlen > n || op + litlen > cap) return -1;
        memcpy(dst + op, src + ip, (size_t)litlen);
        ip += litlen;
        op += litlen;
        if (ip >= n) break;  // last sequence carries no match
        if (ip + 2 > n) return -1;
        int64_t off = src[ip] | ((int64_t)src[ip + 1] << 8);
        ip += 2;
        if (off == 0 || off > op) return -1;
        int64_t mlen = (token & 15);
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if (op + mlen > cap) return -1;
        // overlapping copies are the point (RLE via offset < mlen):
        // byte-by-byte preserves the semantics
        for (int64_t k = 0; k < mlen; ++k, ++op) dst[op] = dst[op - off];
    }
    return op;
}

// --------------------------------------------------------------------------
// Snappy block format (snappy-java analog; spec: varint uncompressed
// length header, then tagged elements — tag low 2 bits: 00 literal,
// 01 copy with 1-byte offset tail, 10 copy with 2-byte offset,
// 11 copy with 4-byte offset). Same stance as LZ4 above: the format is
// public and simple; a from-scratch implementation beats gating the
// codec away. The compressor emits literals + 2-byte-offset copies
// (greedy hash table, minmatch 4); the decompressor accepts every tag
// form a conforming encoder may produce.
// --------------------------------------------------------------------------

static inline uint32_t snappy_hash(uint32_t seq) {
    return (seq * 0x1e35a7bdu) >> 18;  // 14-bit table
}

static int64_t snappy_emit_literal(uint8_t* dst, int64_t op, int64_t cap,
                                   const uint8_t* src, int64_t len) {
    if (len == 0) return op;
    if (len <= 60) {
        if (op + 1 + len > cap) return -1;
        dst[op++] = (uint8_t)((len - 1) << 2);
    } else if (len - 1 < (1 << 8)) {
        if (op + 2 + len > cap) return -1;
        dst[op++] = (uint8_t)(60 << 2);
        dst[op++] = (uint8_t)(len - 1);
    } else if (len - 1 < (1 << 16)) {
        if (op + 3 + len > cap) return -1;
        dst[op++] = (uint8_t)(61 << 2);
        dst[op++] = (uint8_t)((len - 1) & 0xff);
        dst[op++] = (uint8_t)((len - 1) >> 8);
    } else if (len - 1 < (1 << 24)) {
        if (op + 4 + len > cap) return -1;
        dst[op++] = (uint8_t)(62 << 2);
        uint32_t v = (uint32_t)(len - 1);
        memcpy(dst + op, &v, 3);  // little-endian, 3 bytes
        op += 3;
    } else {
        if (op + 5 + len > cap) return -1;
        dst[op++] = (uint8_t)(63 << 2);
        uint32_t v = (uint32_t)(len - 1);
        memcpy(dst + op, &v, 4);
        op += 4;
    }
    memcpy(dst + op, src, (size_t)len);
    return op + len;
}

static int64_t snappy_emit_copy2(uint8_t* dst, int64_t op, int64_t cap,
                                 int64_t offset, int64_t len) {
    // len 4..64 per element; longer matches arrive pre-split
    if (op + 3 > cap) return -1;
    dst[op++] = (uint8_t)(((len - 1) << 2) | 2);
    dst[op++] = (uint8_t)(offset & 0xff);
    dst[op++] = (uint8_t)(offset >> 8);
    return op;
}

int64_t snappy_compress_chunk(const uint8_t* src, int64_t n, uint8_t* dst,
                              int64_t cap, int /*level*/) {
    int64_t op = 0;
    // varint uncompressed length
    uint64_t v = (uint64_t)n;
    while (v >= 0x80) {
        if (op >= cap) return -1;
        dst[op++] = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    if (op >= cap) return -1;
    dst[op++] = (uint8_t)v;

    int32_t table[1 << 14];
    for (int i = 0; i < (1 << 14); ++i) table[i] = -1;
    int64_t ip = 0, anchor = 0;
    if (n >= 8) {
        const int64_t limit = n - 4;
        while (ip <= limit) {
            uint32_t seq;
            memcpy(&seq, src + ip, 4);
            uint32_t h = snappy_hash(seq);
            int64_t ref = table[h];
            table[h] = (int32_t)ip;
            uint32_t refseq;
            if (ref < 0 || ip - ref > 65535 ||
                (memcpy(&refseq, src + ref, 4), refseq != seq)) {
                ++ip;
                continue;
            }
            int64_t mlen = 4;
            while (ip + mlen < n && src[ip + mlen] == src[ref + mlen])
                ++mlen;
            op = snappy_emit_literal(dst, op, cap, src + anchor,
                                     ip - anchor);
            if (op < 0) return -1;
            int64_t off = ip - ref, rem = mlen;
            while (rem > 64) {
                // 60 per element keeps the tail >= 5, always legal
                op = snappy_emit_copy2(dst, op, cap, off, 60);
                if (op < 0) return -1;
                rem -= 60;
            }
            op = snappy_emit_copy2(dst, op, cap, off, rem);
            if (op < 0) return -1;
            ip += mlen;
            anchor = ip;
        }
    }
    op = snappy_emit_literal(dst, op, cap, src + anchor, n - anchor);
    return op;
}

int64_t snappy_decompress_chunk(const uint8_t* src, int64_t n,
                                uint8_t* dst, int64_t cap) {
    int64_t ip = 0;
    uint64_t expect = 0;
    int shift = 0;
    while (true) {
        if (ip >= n || shift > 63) return -1;
        uint8_t b = src[ip++];
        expect |= (uint64_t)(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if ((int64_t)expect > cap) return -1;
    int64_t op = 0;
    while (ip < n) {
        uint8_t tag = src[ip++];
        int t = tag & 3;
        if (t == 0) {  // literal
            int64_t len = (tag >> 2) + 1;
            if (len > 60) {
                int extra = (int)len - 60;  // 1..4 tail bytes
                if (ip + extra > n) return -1;
                uint32_t raw = 0;
                memcpy(&raw, src + ip, (size_t)extra);
                ip += extra;
                len = (int64_t)raw + 1;
            }
            if (ip + len > n || op + len > cap) return -1;
            memcpy(dst + op, src + ip, (size_t)len);
            ip += len;
            op += len;
            continue;
        }
        int64_t len, off;
        if (t == 1) {            // copy, 1-byte offset tail
            if (ip >= n) return -1;
            len = ((tag >> 2) & 0x7) + 4;
            off = ((int64_t)(tag >> 5) << 8) | src[ip++];
        } else if (t == 2) {     // copy, 2-byte offset
            if (ip + 2 > n) return -1;
            len = (tag >> 2) + 1;
            off = src[ip] | ((int64_t)src[ip + 1] << 8);
            ip += 2;
        } else {                 // copy, 4-byte offset
            if (ip + 4 > n) return -1;
            uint32_t o;
            memcpy(&o, src + ip, 4);
            ip += 4;
            len = (tag >> 2) + 1;
            off = (int64_t)o;
        }
        if (off == 0 || off > op || op + len > cap) return -1;
        for (int64_t k = 0; k < len; ++k, ++op) dst[op] = dst[op - off];
    }
    return op == (int64_t)expect ? op : -1;
}

// --------------------------------------------------------------------------
// mmap helpers (PinotDataBuffer mmap mode)
// --------------------------------------------------------------------------

void* mmap_open(const char* path, int64_t* size_out) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    close(fd);
    if (p == MAP_FAILED) return nullptr;
    *size_out = (int64_t)st.st_size;
    return p;
}

int mmap_close(void* p, int64_t size) {
    return munmap(p, (size_t)size);
}

}  // extern "C"
