// snappy_tpu native host runtime: raw Snappy codec + CRC32C.
// The PyTorch port keeps this verbatim copy of snappy_tpu/native/core.cpp so
// that it imports nothing of snappy_tpu; keep the two files identical below.
//
// This is the host-side fast path of the framework (streaming IO, CLI,
// small inputs where device launch overhead dominates) and the test
// oracle. Output is bit-identical to the reference implementations
// (rust-snappy / C++ snappy); error codes mirror snappy_tpu.error.
//
// Format contract citations refer to the reference at
// BurntSushi/rust-snappy: the greedy matcher and emission rules
// (src/compress.rs), the tag-dispatch decode loop (src/decompress.rs),
// and CRC32C masking (src/crc32.rs:35-38).

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <cpuid.h>
#endif

extern "C" {

typedef struct {
  int32_t code;
  uint64_t a, b, c;
} stpu_error;

enum {
  STPU_OK = 0,
  STPU_E_HEADER = 1,
  STPU_E_TOO_BIG = 2,
  STPU_E_HEADER_MISMATCH = 3,
  STPU_E_LITERAL = 4,
  STPU_E_COPY_READ = 5,
  STPU_E_COPY_WRITE = 6,
  STPU_E_OFFSET = 7,
  STPU_E_EMPTY = 8,
  STPU_E_BUFFER_TOO_SMALL = 9,
  STPU_E_STREAM_HEADER = 10,
  STPU_E_STREAM_HEADER_MISMATCH = 11,
  STPU_E_UNSUPPORTED_CHUNK_TYPE = 12,
  STPU_E_UNSUPPORTED_CHUNK_LENGTH = 13,
  STPU_E_CHECKSUM = 14,
  STPU_E_EOF = 15,
};

}  // extern "C"

namespace {

constexpr uint64_t kMaxInputSize = 0xFFFFFFFFull;
constexpr size_t kMaxBlockSize = 1 << 16;
constexpr size_t kMaxTableSize = 1 << 14;
constexpr size_t kInputMargin = 16 - 1;
constexpr size_t kMinNonLiteralBlockSize = 1 + 1 + kInputMargin;
constexpr uint32_t kHashMul = 0x1E35A7BD;
constexpr uint32_t kCastagnoli = 0x82F63B78u;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian host assumed (x86/arm64)
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline void store16(uint8_t* p, uint16_t v) { std::memcpy(p, &v, 2); }

// ---------------------------------------------------------------------------
// CRC32C
// ---------------------------------------------------------------------------

struct CrcTables {
  uint32_t t[16][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t crc = i;
      for (int k = 0; k < 8; k++)
        crc = (crc & 1) ? (crc >> 1) ^ kCastagnoli : crc >> 1;
      t[0][i] = crc;
    }
    for (int j = 1; j < 16; j++)
      for (int i = 0; i < 256; i++)
        t[j][i] = (t[j - 1][i] >> 8) ^ t[0][t[j - 1][i] & 0xFF];
  }
};

const CrcTables& crc_tables() {
  static CrcTables tables;
  return tables;
}

uint32_t crc32c_sw(const uint8_t* p, size_t n) {
  const CrcTables& tb = crc_tables();
  uint32_t crc = ~0u;
  while (n >= 16) {
    crc ^= load32(p);
    crc = tb.t[0][p[15]] ^ tb.t[1][p[14]] ^ tb.t[2][p[13]] ^ tb.t[3][p[12]] ^
          tb.t[4][p[11]] ^ tb.t[5][p[10]] ^ tb.t[6][p[9]] ^ tb.t[7][p[8]] ^
          tb.t[8][p[7]] ^ tb.t[9][p[6]] ^ tb.t[10][p[5]] ^ tb.t[11][p[4]] ^
          tb.t[12][(crc >> 24) & 0xFF] ^ tb.t[13][(crc >> 16) & 0xFF] ^
          tb.t[14][(crc >> 8) & 0xFF] ^ tb.t[15][crc & 0xFF];
    p += 16;
    n -= 16;
  }
  while (n--) crc = tb.t[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(const uint8_t* p, size_t n) {
  uint64_t crc = ~0u;
  while (n >= 8) {
    crc = __builtin_ia32_crc32di(crc, load64(p));
    p += 8;
    n -= 8;
  }
  uint32_t c = static_cast<uint32_t>(crc);
  while (n--) c = __builtin_ia32_crc32qi(c, *p++);
  return ~c;
}

bool has_sse42() {
  unsigned eax, ebx, ecx, edx;
  if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
  return (ecx & (1u << 20)) != 0;
}
#endif

uint32_t crc32c_dispatch(const uint8_t* p, size_t n) {
#if defined(__x86_64__)
  static const bool hw = has_sse42();
  if (hw) return crc32c_hw(p, n);
#endif
  return crc32c_sw(p, n);
}

// ---------------------------------------------------------------------------
// Compression
// ---------------------------------------------------------------------------

size_t varint_write(uint8_t* dst, uint64_t n) {
  size_t i = 0;
  while (n >= 0x80) {
    dst[i++] = static_cast<uint8_t>(n) | 0x80;
    n >>= 7;
  }
  dst[i++] = static_cast<uint8_t>(n);
  return i;
}

// Decodes a varint; returns length consumed, 0 on truncation/overflow
// (matching reference src/bytes.rs:73-90).
size_t varint_read(const uint8_t* p, size_t n, uint64_t* out) {
  uint64_t v = 0;
  uint32_t shift = 0;
  for (size_t i = 0; i < n; i++) {
    uint8_t b = p[i];
    if (b < 0x80) {
      if (shift >= 64) return 0;
      *out = v | (static_cast<uint64_t>(b) << shift);
      return i + 1;
    }
    if (shift >= 64) return 0;
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    shift += 7;
  }
  return 0;
}

inline size_t emit_literal(const uint8_t* src, size_t lit_start, size_t lit_end,
                           size_t src_len, uint8_t* dst, size_t d) {
  size_t len = lit_end - lit_start;
  size_t n = len - 1;
  if (n <= 59) {
    dst[d++] = static_cast<uint8_t>(n << 2);
    if (len <= 16 && lit_start + 16 <= src_len) {
      std::memcpy(dst + d, src + lit_start, 16);
      return d + len;
    }
  } else if (n < 256) {
    dst[d++] = 60 << 2;
    dst[d++] = static_cast<uint8_t>(n);
  } else {
    dst[d++] = 61 << 2;
    dst[d++] = static_cast<uint8_t>(n);
    dst[d++] = static_cast<uint8_t>(n >> 8);
  }
  std::memcpy(dst + d, src + lit_start, len);
  return d + len;
}

inline size_t emit_copy2(uint8_t* dst, size_t d, size_t offset, size_t len) {
  dst[d] = static_cast<uint8_t>(((len - 1) << 2) | 2);
  store16(dst + d + 1, static_cast<uint16_t>(offset));
  return d + 3;
}

inline size_t emit_copy(uint8_t* dst, size_t d, size_t offset, size_t len) {
  // Splitting rules per reference src/compress.rs:323-357.
  while (len >= 68) {
    d = emit_copy2(dst, d, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    d = emit_copy2(dst, d, offset, 60);
    len -= 60;
  }
  if (len <= 11 && offset <= 2047) {
    dst[d] = static_cast<uint8_t>(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
    dst[d + 1] = static_cast<uint8_t>(offset);
    return d + 2;
  }
  return emit_copy2(dst, d, offset, len);
}

// Compress one block (<= 64 KiB) starting at dst[d]; returns new d.
// Exact automaton of reference src/compress.rs:195-317.
size_t compress_block(const uint8_t* src, size_t n, uint8_t* dst, size_t d,
                      uint16_t* table) {
  if (n < kMinNonLiteralBlockSize) {
    size_t next_emit = 0;
    return emit_literal(src, next_emit, n, n, dst, d);
  }

  uint32_t shift = 32 - 8;
  size_t table_size = 256;
  while (table_size < kMaxTableSize && table_size < n) {
    shift--;
    table_size *= 2;
  }
  std::memset(table, 0, table_size * sizeof(uint16_t));

  auto hash = [shift](uint32_t x) -> uint32_t { return (x * kHashMul) >> shift; };

  size_t s = 1;
  size_t s_limit = n - kInputMargin;
  size_t next_emit = 0;
  uint32_t next_hash = hash(load32(src + s));

  for (;;) {
    // Candidate scan with accelerating skip.
    size_t skip = 32;
    size_t candidate;
    size_t s_next = s;
    for (;;) {
      s = s_next;
      size_t gap = skip >> 5;
      s_next = s + gap;
      skip += gap;
      if (s_next > s_limit) goto finish;
      candidate = table[next_hash];
      table[next_hash] = static_cast<uint16_t>(s);
      next_hash = hash(load32(src + s_next));
      if (load32(src + s) == load32(src + candidate)) break;
    }

    d = emit_literal(src, next_emit, s, n, dst, d);

    for (;;) {
      size_t base = s;
      s += 4;
      // Extend match past the common prefix of src[s..] and src[cand..].
      {
        size_t cand = candidate + 4;
        while (s + 8 <= n) {
          uint64_t x = load64(src + s);
          uint64_t y = load64(src + cand);
          if (x == y) {
            s += 8;
            cand += 8;
          } else {
            s += __builtin_ctzll(x ^ y) / 8;
            goto extended;
          }
        }
        while (s < n && src[s] == src[cand]) {
          s++;
          cand++;
        }
      }
    extended:
      d = emit_copy(dst, d, base - candidate, s - base);
      next_emit = s;
      if (s >= s_limit) goto finish;

      uint64_t x = load64(src + s - 1);
      table[hash(static_cast<uint32_t>(x))] = static_cast<uint16_t>(s - 1);
      uint32_t cur = static_cast<uint32_t>(x >> 8);
      uint32_t cur_hash = hash(cur);
      candidate = table[cur_hash];
      table[cur_hash] = static_cast<uint16_t>(s);
      if (cur != load32(src + candidate)) {
        next_hash = hash(static_cast<uint32_t>(x >> 16));
        s++;
        break;
      }
    }
  }

finish:
  if (next_emit < n) d = emit_literal(src, next_emit, n, n, dst, d);
  return d;
}

// Tag-dispatch table: one load decodes a tag byte into {base length,
// trailing byte count, literal flag, copy-1 offset-high bits}. The reference
// generates the equivalent table at build time (build.rs:40-67) and
// dispatches on it in src/decompress.rs:130-148.
//
// Layout (uint32): bits 0..7 = base length (copy length, or short-literal
// length); bits 8..10 = bytes following the tag (copy offset bytes, or
// big-literal length bytes); bit 11 = literal; bits 16.. = offset addend
// ((tag >> 5) << 8) for 1-byte-offset copies, else 0.
constexpr uint32_t kTagLiteral = 1u << 11;

struct TagTable {
  uint32_t e[256];
  TagTable() {
    for (uint32_t t = 0; t < 256; t++) {
      const uint32_t kind = t & 3;
      const uint32_t upper = t >> 2;
      if (kind == 0) {
        e[t] = (upper < 60) ? (kTagLiteral | (upper + 1))
                            : (kTagLiteral | ((upper - 59) << 8));
      } else if (kind == 1) {
        e[t] = (4 + (upper & 7)) | (1u << 8) | (((t >> 5) << 8) << 16);
      } else if (kind == 2) {
        e[t] = (1 + upper) | (2u << 8);
      } else {
        e[t] = (1 + upper) | (4u << 8);
      }
    }
  }
};

const TagTable& tag_table() {
  static TagTable table;
  return table;
}

}  // namespace

extern "C" {

uint64_t stpu_max_compress_len(uint64_t n) {
  if (n > kMaxInputSize) return 0;
  uint64_t m = 32 + n + n / 6;
  return m > kMaxInputSize ? 0 : m;
}

uint32_t stpu_crc32c(const uint8_t* p, size_t n) { return crc32c_dispatch(p, n); }

uint32_t stpu_crc32c_masked(const uint8_t* p, size_t n) {
  uint32_t sum = crc32c_dispatch(p, n);
  return ((sum >> 15) | (sum << 17)) + 0xA282EAD8u;
}

// Batched masked CRC32C over contiguous chunks: lens[i] bytes each,
// back to back in `p`. Used by the frame writer to checksum many chunks
// in one FFI hop.
void stpu_crc32c_masked_batch(const uint8_t* p, const uint64_t* lens,
                              size_t count, uint32_t* out) {
  for (size_t i = 0; i < count; i++) {
    out[i] = stpu_crc32c_masked(p, lens[i]);
    p += lens[i];
  }
}

int64_t stpu_compress(const uint8_t* src, uint64_t n, uint8_t* dst,
                      uint64_t dst_cap, stpu_error* err) {
  err->code = STPU_OK;
  uint64_t need = stpu_max_compress_len(n);
  if (need == 0) {
    err->code = STPU_E_TOO_BIG;
    err->a = n;
    err->b = kMaxInputSize;
    return -1;
  }
  if (dst_cap < need) {
    err->code = STPU_E_BUFFER_TOO_SMALL;
    err->a = dst_cap;
    err->b = need;
    return -1;
  }
  if (n == 0) {
    dst[0] = 0;
    return 1;
  }
  size_t d = varint_write(dst, n);
  uint16_t table[kMaxTableSize];
  for (uint64_t pos = 0; pos < n; pos += kMaxBlockSize) {
    size_t len = static_cast<size_t>(n - pos < kMaxBlockSize ? n - pos : kMaxBlockSize);
    d = compress_block(src + pos, len, dst, d, table);
  }
  return static_cast<int64_t>(d);
}

int64_t stpu_scan_ops(const uint8_t* src, uint64_t n, uint8_t* maskbits) {
  // Mark op-start byte positions of a raw op stream (no varint header)
  // into a little-endian bitmap of (n+7)/8 bytes. This is the serial
  // 0.03%-of-work half of the hybrid decode: the device kernel skips
  // its pointer-doubling op-discovery phase when given this mask.
  //
  // The walk must be bit-identical to the device's *speculative* parse
  // (snappy_tpu/ops/decode.py:_parse_positions) on zero-padded rows:
  // reads past n yield 0, lengths clamp at 2^30, and malformed streams
  // do not stop the walk — the device's per-op validity checks flag
  // them identically either way.
  std::memset(maskbits, 0, (n + 7) / 8);
  auto at = [&](uint64_t p) -> uint32_t { return p < n ? src[p] : 0; };
  uint64_t s = 0;
  int64_t ops = 0;
  while (s < n) {
    maskbits[s >> 3] |= static_cast<uint8_t>(1u << (s & 7));
    ops++;
    uint32_t tag = src[s];
    uint32_t kind = tag & 3;
    if (kind == 0) {
      uint64_t len = (tag >> 2) + 1;
      uint64_t extra = 0;
      if (len >= 61) {
        uint64_t bc = len - 60;
        uint32_t v = 0;
        for (uint64_t i = 0; i < bc; i++) v |= at(s + 1 + i) << (8 * i);
        uint64_t raw = v;
        if (raw > (1ull << 30)) raw = 1ull << 30;  // device _CAP clamp
        len = raw + 1;
        extra = bc;
      }
      s += 1 + extra + len;
    } else {
      uint64_t ntb = (kind == 1) ? 1 : (kind == 2 ? 2 : 4);
      s += 1 + ntb;
    }
  }
  return ops;
}

int64_t stpu_scan_records(const uint8_t* src, uint64_t n_u, uint64_t declen_u,
                          int32_t* recs, int64_t cap, int32_t* err_out,
                          int64_t* dtotal_out) {
  // Validated op-record scan for the Pallas record-replay decode: walk
  // the raw op stream in lockstep with the device decoder's validation
  // (snappy_tpu/ops/pallas/decode.py kernel step; same checks, same
  // order, same device error codes 0..5), emitting one packed record
  // per VALID op:
  //   word0 = (1<<30)|len  for a literal (len bytes at src[word1]),
  //   word0 = len          for a copy    (len bytes from dst[-word1]).
  // Returns the op count of the valid prefix (may exceed ``cap``; only
  // the first ``cap`` records are written — the caller treats
  // ops > cap as overflow and falls back to the self-contained
  // kernel). ``*err_out`` is the device error code, ``*dtotal_out`` the
  // decoded byte count of the valid prefix — together they reproduce
  // the device decode's (err, partial output) contract exactly, so the
  // replay kernel needs no per-op validation at all.
  const int64_t n = static_cast<int64_t>(n_u);
  const int64_t declen = static_cast<int64_t>(declen_u);
  auto at = [&](int64_t p) -> uint32_t {
    return (p >= 0 && p < n) ? src[p] : 0u;
  };
  const uint32_t kDevCap = 1u << 30;  // device _CAP clamp
  int64_t s = 0, d = 0, ops = 0;
  int32_t err = 0;  // device OK
  while (s < n) {
    uint32_t tag = src[s];
    uint32_t kind = tag & 3;
    int32_t lenm1 = static_cast<int32_t>(tag >> 2);
    if (kind == 0) {
      // Literal: mirrors the kernel's do_literal (E_LITERAL = 1).
      bool long_lit = lenm1 >= 60;
      int32_t bc = lenm1 - 59;
      if (bc < 1) bc = 1;
      if (bc > 4) bc = 4;
      uint32_t raw = 0;
      for (int i = 0; i < 4; i++) raw |= at(s + 1 + i) << (8 * i);
      if (bc < 4) raw &= 0xFFFFFFFFu >> (8 * (4 - bc));
      int64_t ll = long_lit
                       ? static_cast<int64_t>(raw > kDevCap ? kDevCap : raw) + 1
                       : static_cast<int64_t>(lenm1) + 1;
      int64_t content = s + 1 + (long_lit ? bc : 0);
      if ((long_lit && s + 5 > n) || (n - content < ll) || (declen - d < ll)) {
        err = 1;
        break;
      }
      if (ops < cap) {
        recs[2 * ops] = static_cast<int32_t>((1 << 30) | ll);
        recs[2 * ops + 1] = static_cast<int32_t>(content);
      }
      ops++;
      s = content + ll;
      d += ll;
    } else {
      // Copy: mirrors do_copy (E_COPYREAD=2, E_OFFSET=3, E_COPYWRITE=4).
      int32_t ntb = (kind == 1) ? 1 : (kind == 2 ? 2 : 4);
      int64_t length = (kind == 1) ? 4 + (lenm1 & 7) : lenm1 + 1;
      uint32_t off;
      if (kind == 1) {
        off = ((tag >> 5) << 8) | at(s + 1);
      } else {
        uint32_t v = 0;
        for (int i = 0; i < 4; i++) v |= at(s + 1 + i) << (8 * i);
        if (ntb < 4) v &= 0xFFFFFFFFu >> (8 * (4 - ntb));
        off = v;
      }
      if (s + 1 + ntb > n) {
        err = 2;
      } else if (off == 0 || static_cast<uint64_t>(off) > static_cast<uint64_t>(d)) {
        err = 3;
      } else if (d + length > declen) {
        err = 4;
      }
      if (err != 0) break;
      if (ops < cap) {
        recs[2 * ops] = static_cast<int32_t>(length);
        recs[2 * ops + 1] = static_cast<int32_t>(off);
      }
      ops++;
      s += 1 + ntb;
      d += length;
    }
  }
  if (err == 0 && d != declen) err = 5;  // E_HEADER_MISMATCH
  *err_out = err;
  *dtotal_out = d;
  return ops;
}

int64_t stpu_flatten_idx(const uint8_t* src, uint64_t n_u, uint64_t declen_u,
                         int64_t s_rows, uint16_t* idx_rel, uint64_t d_pad_u,
                         int32_t* tile_meta, int32_t* err_out,
                         int64_t* dtotal_out, int layout) {
  // layout 0: idx_rel in output order (v1 kernel).
  // layout 1: the v2 kernel's transposed block layout (requires
  //   d_pad % 16384 == 0): each 16-tile group is a (128, 128) device
  //   block whose column tt*8 + s holds tile tt / output-row s's 128
  //   lane values at sublanes:
  //   phys(d) = (d>>14<<14) | ((d & 127) << 7) | (((d>>10) & 15) << 3)
  //             | ((d >> 7) & 7).
  // Host half of the Pallas flat-gather decode: walk the op stream in
  // lockstep with device validation (same checks/order/codes as
  // stpu_scan_records above), flattening every copy chain to the
  // LITERAL content bytes it ultimately reads — "decode, but with
  // indices": literals write arithmetic ramps, copies memcpy
  // already-flat indices (period doubling for overlaps), linear in
  // declen. The device never chases a chain: each output byte carries
  // one source index into the compressed stream, and decode is a
  // single windowed gather (snappy_tpu/ops/pallas/decode.py flat
  // kernel).
  //
  // Outputs: idx_rel (d_pad,) uint16 window-relative byte indices;
  // tile_meta (d_pad/1024, 2) int32 = (window base row, bucket) with
  // bucket 0 = narrow window (128 rows), 1 = mid (256), 2 = wide (512).
  // Returns 0, or 1 when some tile's source spread exceeds the wide
  // window (only possible when s_rows > 512; the caller falls back to
  // the replay kernel). Error code/dtotal mirror stpu_scan_records.
  const int64_t n = static_cast<int64_t>(n_u);
  const int64_t declen = static_cast<int64_t>(declen_u);
  const int64_t d_pad = static_cast<int64_t>(d_pad_u);
  auto at = [&](int64_t p) -> uint32_t {
    return (p >= 0 && p < n) ? src[p] : 0u;
  };
  // Clamped 4-byte LE read; one unclamped load32 in the common case.
  auto tail32 = [&](int64_t p) -> uint32_t {
    if (p >= 0 && p + 4 <= n) return load32(src + p);
    uint32_t v = 0;
    for (int i = 0; i < 4; i++) v |= at(p + i) << (8 * i);
    return v;
  };
  const uint32_t kDevCap = 1u << 30;
  // Direct flattening: idx_abs is "decode, but with indices" — the
  // same walk the byte decoder does, except each output position
  // stores the compressed-stream position of the literal byte it
  // ultimately reads. A literal writes an arithmetic ramp; a copy
  // memcpys already-flat indices (its own prefix is the period for
  // overlaps), so the whole pass is linear in declen with wide stores
  // — no segment list, no binary search.
  //
  // Scratch is thread_local and grown without zero-init (per-call
  // vector construction would memset ~256 KB per 64 KiB block), with
  // 16 entries of slack so short ops can store fixed 64-byte chunks
  // unconditionally (overshoot is overwritten by the next op or falls
  // in the slack); tiles only ever read positions the walk wrote.
  thread_local std::vector<int32_t> idx_abs_tls;
  if (static_cast<int64_t>(idx_abs_tls.size()) < d_pad + 16)
    idx_abs_tls.resize(static_cast<size_t>(d_pad) + 16);
  std::vector<int32_t>& idx_abs = idx_abs_tls;
  int64_t s = 0, d = 0;
  int32_t err = 0;
  while (s < n) {
    uint32_t tag = src[s];
    uint32_t kind = tag & 3;
    int32_t lenm1 = static_cast<int32_t>(tag >> 2);
    if (kind == 0) {
      bool long_lit = lenm1 >= 60;
      int32_t bc = lenm1 - 59;
      if (bc < 1) bc = 1;
      if (bc > 4) bc = 4;
      uint32_t raw = tail32(s + 1);
      if (bc < 4) raw &= 0xFFFFFFFFu >> (8 * (4 - bc));
      int64_t ll = long_lit
                       ? static_cast<int64_t>(raw > kDevCap ? kDevCap : raw) + 1
                       : static_cast<int64_t>(lenm1) + 1;
      int64_t content = s + 1 + (long_lit ? bc : 0);
      if ((long_lit && s + 5 > n) || (n - content < ll) || (declen - d < ll)) {
        err = 1;  // E_LITERAL
        break;
      }
      if (ll <= 16) {
        // Fixed 16-entry ramp (one vector store burst, no loop
        // branches); overshoot lands in later-op territory or slack.
        int32_t* dst = idx_abs.data() + d;
        const int32_t c32 = static_cast<int32_t>(content);
        for (int k = 0; k < 16; k++) dst[k] = c32 + k;
      } else {
        for (int64_t k = 0; k < ll; k++)
          idx_abs[static_cast<size_t>(d + k)] =
              static_cast<int32_t>(content + k);
      }
      s = content + ll;
      d += ll;
    } else {
      int32_t ntb = (kind == 1) ? 1 : (kind == 2 ? 2 : 4);
      int64_t length = (kind == 1) ? 4 + (lenm1 & 7) : lenm1 + 1;
      uint32_t off;
      if (kind == 1) {
        off = ((tag >> 5) << 8) | at(s + 1);
      } else {
        uint32_t v = tail32(s + 1);
        if (ntb < 4) v &= 0xFFFFFFFFu >> (8 * (4 - ntb));
        off = v;
      }
      if (s + 1 + ntb > n) {
        err = 2;  // E_COPYREAD
      } else if (off == 0 ||
                 static_cast<uint64_t>(off) > static_cast<uint64_t>(d)) {
        err = 3;  // E_OFFSET
      } else if (d + length > declen) {
        err = 4;  // E_COPYWRITE
      }
      if (err != 0) break;
      const int64_t offi = static_cast<int64_t>(off);
      int32_t* dst = idx_abs.data() + d;
      if (length <= 16 && offi >= 16) {
        // Fixed 64-byte copy, branch- and call-free (wire copies are
        // <= 64 long but typically ~10; overshoot is overwritten or
        // slack).
        memcpy(dst, dst - offi, 64);
      } else if (length <= offi) {
        memcpy(dst, dst - offi, static_cast<size_t>(length) * 4);
      } else {
        // Overlapping copy: the first offi indices are the period;
        // extend by doubling from the copy's own start.
        memcpy(dst, dst - offi, static_cast<size_t>(offi) * 4);
        int64_t filled = offi;
        while (filled < length) {
          int64_t take = std::min(filled, length - filled);
          memcpy(dst + filled, dst, static_cast<size_t>(take) * 4);
          filled += take;
        }
      }
      s += 1 + ntb;
      d += length;
    }
  }
  if (err == 0 && d != declen) err = 5;  // E_HEADER_MISMATCH
  *err_out = err;
  *dtotal_out = d;

  // Window-relativize per 1024-byte tile. layout 0 (v1 kernel) uses
  // buckets {128, 256, 512} clamped to s_rows; layout 1 (v2) uses
  // {64, 128, 256, 512} at fixed kernel widths — the v2 kernel zero-
  // pads its window scratch to max(s_rows, 512) rows, so the fit test
  // runs against the kernel width even past s_rows (indices never
  // point into padding: idx_abs < n <= s_rows*128).
  const int64_t d_fill = std::min<int64_t>(d, d_pad);
  const int64_t n_tiles = d_pad / 1024;
  // Both layouts share the same 3-bucket windows; layout only selects
  // the idx_rel write order. (A 4-bucket/64-row variant and 16-aligned
  // bases were measured a 2x regression on-chip — FLAT_AB2.json — and
  // reverted.)
  int64_t widths[4];
  int n_widths;
  {
    widths[0] = std::min<int64_t>(128, s_rows);
    widths[1] = std::min<int64_t>(256, s_rows);
    widths[2] = std::min<int64_t>(512, s_rows);
    n_widths = 3;
  }
  int64_t fallback = 0;
  for (int64_t t = 0; t < n_tiles; t++) {
    int64_t lo = t * 1024, hi = std::min<int64_t>(lo + 1024, d_fill);
    int32_t mn = 0, mx = 0;
    if (lo < hi) {
      mn = mx = idx_abs[static_cast<size_t>(lo)];
      for (int64_t p = lo + 1; p < hi; p++) {
        int32_t v = idx_abs[static_cast<size_t>(p)];
        mn = std::min(mn, v);
        mx = std::max(mx, v);
      }
    }
    int64_t min_row = mn / 128;
    int32_t bucket = -1;
    int64_t base = 0;
    // Mosaic requires dynamic row offsets provably 8-aligned, so window
    // bases round down to a multiple of 8 rows (the fit checks run on
    // the aligned base).
    for (int wi = 0; wi < n_widths; wi++) {
      const int64_t w = widths[wi];
      const int64_t wcap = std::min<int64_t>(w, s_rows);
      base = std::max<int64_t>(0, std::min<int64_t>(min_row, s_rows - wcap)) &
             ~int64_t{7};
      if (mx - base * 128 < w * 128) {
        bucket = wi;
        break;
      }
    }
    if (bucket < 0) {
      // Spread exceeds the widest window: flag fallback (only possible
      // for bodies over 64 KiB; the caller reroutes the whole row).
      bucket = n_widths - 1;
      fallback = 1;
    }
    tile_meta[2 * t] = static_cast<int32_t>(base);
    tile_meta[2 * t + 1] = bucket;
    const int64_t rel0 = base * 128;
    if (layout == 0) {
      for (int64_t p = lo; p < hi; p++)
        idx_rel[static_cast<size_t>(p)] =
            static_cast<uint16_t>(idx_abs[static_cast<size_t>(p)] - rel0);
      for (int64_t p = hi; p < lo + 1024; p++)
        idx_rel[static_cast<size_t>(p)] = 0;
    } else {
      // v2 transposed block layout; the tile's 1024 values land at
      // stride 128 within its group's (128, 128) block:
      //   phys(e) = gbase + (e % 128)*128 + cbase + e/128.
      // Written as an 8x128 -> 128x8 transpose: per lane l, the 8
      // destination u16s are contiguous (one 16-byte store's worth),
      // and the whole group window (32 KiB) stays L1-resident.
      const int64_t gbase = (t >> 4) << 14;
      const int64_t cbase = (t & 15) << 3;
      uint16_t rel16[1024];
      // hi < lo for tiles wholly past d_fill (zero-pad region).
      const int64_t fill = hi > lo ? hi - lo : 0;
      for (int64_t e = 0; e < fill; e++)
        rel16[e] = static_cast<uint16_t>(
            idx_abs[static_cast<size_t>(lo + e)] - rel0);
      for (int64_t e = fill; e < 1024; e++) rel16[e] = 0;
      uint16_t* out_base = idx_rel + gbase + cbase;
      for (int64_t l = 0; l < 128; l++) {
        uint16_t* o = out_base + l * 128;
        const uint16_t* r = rel16 + l;
        o[0] = r[0];
        o[1] = r[128];
        o[2] = r[256];
        o[3] = r[384];
        o[4] = r[512];
        o[5] = r[640];
        o[6] = r[768];
        o[7] = r[896];
      }
    }
  }
  return fallback;
}

int64_t stpu_decompress_len(const uint8_t* src, uint64_t n, stpu_error* err) {
  err->code = STPU_OK;
  if (n == 0) return 0;
  uint64_t declen;
  size_t hdr = varint_read(src, n, &declen);
  if (hdr == 0) {
    err->code = STPU_E_HEADER;
    return -1;
  }
  if (declen > kMaxInputSize) {
    err->code = STPU_E_TOO_BIG;
    err->a = declen;
    err->b = kMaxInputSize;
    return -1;
  }
  return static_cast<int64_t>(declen);
}

int64_t stpu_decompress(const uint8_t* src, uint64_t src_len, uint8_t* dst,
                        uint64_t dst_cap, stpu_error* err) {
  err->code = STPU_OK;
  if (src_len == 0) {
    err->code = STPU_E_EMPTY;
    return -1;
  }
  uint64_t declen64;
  size_t hdr = varint_read(src, src_len, &declen64);
  if (hdr == 0) {
    err->code = STPU_E_HEADER;
    return -1;
  }
  if (declen64 > kMaxInputSize) {
    err->code = STPU_E_TOO_BIG;
    err->a = declen64;
    err->b = kMaxInputSize;
    return -1;
  }
  if (declen64 > dst_cap) {
    err->code = STPU_E_BUFFER_TOO_SMALL;
    err->a = dst_cap;
    err->b = declen64;
    return -1;
  }
  const size_t dst_len = static_cast<size_t>(declen64);
  src += hdr;
  const size_t n = static_cast<size_t>(src_len - hdr);

  size_t s = 0, d = 0;
  static const uint32_t kMask[5] = {0, 0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF};
  const uint32_t* T = tag_table().e;
  while (s < n) {
    // Careful path: one table load decodes the tag (reference build.rs:40-67
    // builds the same table at compile time; decompress.rs:130-148
    // dispatches on it).
    const uint32_t e = T[src[s++]];
    if (e & kTagLiteral) {
      // Literal (reference src/decompress.rs:161-228).
      uint64_t len = e & 0xFF;
      const size_t extra = (e >> 8) & 7;
      if (extra == 0) {
        if (len <= 16 && s + 16 <= n && d + 16 <= dst_len) {
          std::memcpy(dst + d, src + s, 16);
          s += len;
          d += len;
          continue;
        }
      } else {
        if (s + 4 > n) {
          err->code = STPU_E_LITERAL;
          err->a = 4;
          err->b = n - s;
          err->c = dst_len - d;
          return -1;
        }
        len = static_cast<uint64_t>(load32(src + s) & kMask[extra]) + 1;
        s += extra;
      }
      if (n - s < len || dst_len - d < len) {
        err->code = STPU_E_LITERAL;
        err->a = len;
        err->b = n - s;
        err->c = dst_len - d;
        return -1;
      }
      std::memcpy(dst + d, src + s, static_cast<size_t>(len));
      s += len;
      d += len;
      continue;
    }
    // Copy (reference src/decompress.rs:233-343 + tag table build.rs:40-67).
    size_t num_tag_bytes = (e >> 8) & 7;
    size_t len = e & 0xFF;
    size_t offset;
    if (s + 4 <= n) {
      offset = (load32(src + s) & kMask[num_tag_bytes]) + (e >> 16);
    } else if (num_tag_bytes == 1) {
      if (s >= n) {
        err->code = STPU_E_COPY_READ;
        err->a = 1;
        err->b = n - s;
        return -1;
      }
      offset = src[s] + (e >> 16);
    } else if (num_tag_bytes == 2) {
      if (s + 1 >= n) {
        err->code = STPU_E_COPY_READ;
        err->a = 2;
        err->b = n - s;
        return -1;
      }
      offset = src[s] | (static_cast<size_t>(src[s + 1]) << 8);
    } else {
      err->code = STPU_E_COPY_READ;
      err->a = num_tag_bytes;
      err->b = n - s;
      return -1;
    }
    s += num_tag_bytes;

    if (offset == 0 || d < offset) {
      err->code = STPU_E_OFFSET;
      err->a = offset;
      err->b = d;
      return -1;
    }
    size_t end = d + len;
    if (end > dst_len) {
      err->code = STPU_E_COPY_WRITE;
      err->a = len;
      err->b = dst_len - d;
      return -1;
    }
    if (offset >= 8 && d + len + 16 <= dst_len) {
      // Wide copies with slack: widen the stride until past overlap.
      uint8_t* dp = dst + d;
      const uint8_t* sp = dp - offset;
      size_t written = 0;
      while (written < len) {
        std::memcpy(dp + written, sp + written, 8);
        std::memcpy(dp + written + 8, sp + written + 8, 8);
        written += 16;
      }
    } else if (offset >= len) {
      // Disjoint copy, exact bounds (end-of-buffer tail).
      std::memcpy(dst + d, dst + d - offset, len);
    } else {
      // Overlapping copy: period-doubling. The region [base, base+k) holds a
      // valid period-`offset` pattern; appending its own prefix (cnt <= k, so
      // source and destination are disjoint) keeps the invariant while the
      // region doubles. O(log(len/offset)) memcpys, exact bounds — replaces
      // the reference's byte-at-a-time overlap loop (src/decompress.rs:289).
      uint8_t* base = dst + d - offset;
      size_t k = offset;
      const size_t need = offset + len;
      while (k < need) {
        const size_t cnt = std::min(k, need - k);
        std::memcpy(base + k, base, cnt);
        k += cnt;
      }
    }
    d = end;
  }
  if (d != dst_len) {
    err->code = STPU_E_HEADER_MISMATCH;
    err->a = dst_len;
    err->b = d;
    return -1;
  }
  return static_cast<int64_t>(d);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multithreaded frame (streaming) codec.
//
// The frame format's chunks are fully independent (64 KiB of source
// each, own CRC: reference src/frame.rs:62-104), so the host runtime
// compresses/decompresses them across cores — the deployment-grade host
// path the single-threaded reference does not have. Wire bytes are
// byte-identical to the Python frame writer (and hence the reference).

namespace {

constexpr size_t kMaxCompressBlockLen = 76490;  // max_compress_len(65536)
constexpr size_t kChunkSlot = 8 + kMaxCompressBlockLen;
const uint8_t kStreamIdent[10] = {0xFF, 0x06, 0x00, 0x00,
                                  's', 'N', 'a', 'P', 'p', 'Y'};

void parallel_for(uint64_t count, int threads, void (*fn)(uint64_t, uint64_t, void*),
                  void* ctx) {
  // Dynamic (work-stealing) chunking: rows vary ~2x in walk time by
  // content, so a static equal split is bound by its worst thread —
  // measurable at small batches (decode16's host flatten ran 35%
  // slower per block than the 392-row batch, round 4). Threads pull
  // one row at a time from an atomic counter; the fetch_add is ~ns
  // against the >=30 us row walks it schedules.
  if (threads <= 0) threads = static_cast<int>(std::thread::hardware_concurrency());
  if (threads < 1) threads = 1;
  if (count == 0) return;
  uint64_t nt = std::min<uint64_t>(threads, count);
  if (nt <= 1) {
    fn(0, count, ctx);
    return;
  }
  std::atomic<uint64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      uint64_t i = next.fetch_add(1, std::memory_order_relaxed);
      if (i >= count) break;
      fn(i, i + 1, ctx);
    }
  };
  std::vector<std::thread> pool;
  for (uint64_t t = 1; t < nt; t++) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

struct FrameCompressCtx {
  const uint8_t* src;
  uint64_t n;
  uint8_t* dst;
  uint32_t* sizes;
};

void frame_compress_range(uint64_t begin, uint64_t end, void* vctx) {
  auto* ctx = static_cast<FrameCompressCtx*>(vctx);
  uint16_t table[kMaxTableSize];
  for (uint64_t c = begin; c < end; c++) {
    const uint8_t* cs = ctx->src + c * kMaxBlockSize;
    size_t clen = static_cast<size_t>(
        std::min<uint64_t>(kMaxBlockSize, ctx->n - c * kMaxBlockSize));
    uint8_t* out = ctx->dst + 10 + c * kChunkSlot;
    uint32_t crc = crc32c_dispatch(cs, clen);
    crc = ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
    size_t p = varint_write(out + 8, clen);
    p = compress_block(cs, clen, out + 8, p, table);
    uint8_t type;
    uint32_t payload_len;
    if (p >= clen - clen / 8) {  // < 12.5% saved: Uncompressed chunk
      type = 0x01;
      payload_len = static_cast<uint32_t>(clen);
      std::memcpy(out + 8, cs, clen);
    } else {
      type = 0x00;
      payload_len = static_cast<uint32_t>(p);
    }
    uint32_t blen = payload_len + 4;
    out[0] = type;
    out[1] = blen & 0xFF;
    out[2] = (blen >> 8) & 0xFF;
    out[3] = (blen >> 16) & 0xFF;
    out[4] = crc & 0xFF;
    out[5] = (crc >> 8) & 0xFF;
    out[6] = (crc >> 16) & 0xFF;
    out[7] = (crc >> 24) & 0xFF;
    ctx->sizes[c] = 8 + payload_len;
  }
}

struct FrameChunk {
  uint64_t src_off;   // payload start (after the 4-byte CRC)
  uint32_t pay_len;   // payload bytes (without CRC)
  uint32_t declen;
  uint64_t dst_off;
  uint32_t crc;
  uint8_t compressed;
};

struct FrameDecompressCtx {
  const uint8_t* src;
  uint8_t* dst;
  const FrameChunk* chunks;
  stpu_error* errs;  // per chunk
};

void frame_decompress_range(uint64_t begin, uint64_t end, void* vctx) {
  auto* ctx = static_cast<FrameDecompressCtx*>(vctx);
  for (uint64_t c = begin; c < end; c++) {
    const FrameChunk& ch = ctx->chunks[c];
    stpu_error* e = &ctx->errs[c];
    e->code = STPU_OK;
    uint8_t* out = ctx->dst + ch.dst_off;
    if (ch.compressed) {
      if (ch.pay_len == 0) {
        e->code = STPU_E_EMPTY;
        continue;
      }
      if (stpu_decompress(ctx->src + ch.src_off, ch.pay_len, out, ch.declen, e) < 0)
        continue;
    } else {
      std::memcpy(out, ctx->src + ch.src_off, ch.declen);
    }
    uint32_t crc = crc32c_dispatch(out, ch.declen);
    crc = ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
    if (crc != ch.crc) {
      e->code = STPU_E_CHECKSUM;
      e->a = ch.crc;
      e->b = crc;
    }
  }
}

// Walk the chunk structure (streaming-reader semantics, reference
// src/read.rs:105-238). Fills `chunks` (may be null to only count/size),
// sets *total_declen. On a structural error returns its code via *pending
// (processing stops there, matching the sequential reader's visit order).
uint64_t frame_walk(const uint8_t* src, uint64_t n, FrameChunk* chunks,
                    uint64_t* total_declen, stpu_error* pending) {
  pending->code = STPU_OK;
  uint64_t pos = 0, count = 0, total = 0;
  bool seen_ident = false;
  while (pos < n) {
    if (pos + 4 > n) {
      pending->code = STPU_E_EOF;
      break;
    }
    uint8_t ty = src[pos];
    uint32_t length = src[pos + 1] | (static_cast<uint32_t>(src[pos + 2]) << 8) |
                      (static_cast<uint32_t>(src[pos + 3]) << 16);
    if (!seen_ident) {
      if (ty != 0xFF) {
        pending->code = STPU_E_STREAM_HEADER;
        pending->a = ty;
        break;
      }
      seen_ident = true;
    }
    if (length > kMaxCompressBlockLen) {
      pending->code = STPU_E_UNSUPPORTED_CHUNK_LENGTH;
      pending->a = length;
      pending->b = 0;
      break;
    }
    if (ty >= 0x02 && ty <= 0x7F) {
      pending->code = STPU_E_UNSUPPORTED_CHUNK_TYPE;
      pending->a = ty;
      break;
    }
    // Per-type length validity precedes the body read: the sequential
    // reader raises on a bad declared length without consuming the body,
    // so a truncated stream surfaces the length error, not EOF.
    if (ty == 0xFF && length != 6) {
      pending->code = STPU_E_UNSUPPORTED_CHUNK_LENGTH;
      pending->a = length;
      pending->b = 1;
      break;
    }
    if ((ty == 0x00 || ty == 0x01) && length < 4) {
      pending->code = STPU_E_UNSUPPORTED_CHUNK_LENGTH;
      pending->a = length;
      pending->b = 0;
      break;
    }
    if (pos + 4 + length > n) {
      pending->code = STPU_E_EOF;
      break;
    }
    const uint8_t* body = src + pos + 4;
    if ((ty >= 0x80 && ty <= 0xFD) || ty == 0xFE) {
      pos += 4 + length;
      continue;
    }
    if (ty == 0xFF) {
      if (std::memcmp(body, kStreamIdent + 4, 6) != 0) {
        pending->code = STPU_E_STREAM_HEADER_MISMATCH;
        uint64_t packed = 0;
        for (int i = 5; i >= 0; i--) packed = (packed << 8) | body[i];
        pending->a = packed;
        pending->b = 6;
        break;
      }
      pos += 4 + length;
      continue;
    }
    // Data chunk (0x00 compressed / 0x01 uncompressed); length >= 4
    // was checked before the body read above.
    uint32_t crc = body[0] | (static_cast<uint32_t>(body[1]) << 8) |
                   (static_cast<uint32_t>(body[2]) << 16) |
                   (static_cast<uint32_t>(body[3]) << 24);
    uint32_t pay = length - 4;
    uint64_t declen = 0;
    uint8_t is_comp = (ty == 0x00);
    if (!is_comp) {
      if (pay > kMaxBlockSize) {
        pending->code = STPU_E_UNSUPPORTED_CHUNK_LENGTH;
        pending->a = pay;
        pending->b = 0;
        break;
      }
      declen = pay;
    } else if (pay > 0) {
      uint64_t dl;
      size_t hdr = varint_read(body + 4, pay, &dl);
      if (hdr == 0) {
        // Defer: the sequential reader surfaces this via the chunk's
        // decode step (Header error), after earlier chunks are checked.
        dl = 0;
      } else if (dl > kMaxInputSize) {
        // decompress_len's TooBig precedes the block-size bound, matching
        // the Python paths' _check_header (reference src/read.rs:210-218
        // runs decompress_len before the MAX_BLOCK_SIZE comparison).
        pending->code = STPU_E_TOO_BIG;
        pending->a = dl;
        pending->b = kMaxInputSize;
        break;
      } else if (dl > kMaxBlockSize) {
        pending->code = STPU_E_UNSUPPORTED_CHUNK_LENGTH;
        pending->a = dl;
        pending->b = 0;
        break;
      }
      declen = (hdr == 0) ? 0 : dl;
    }
    if (chunks) {
      chunks[count].src_off = pos + 8;
      chunks[count].pay_len = pay;
      chunks[count].declen = static_cast<uint32_t>(declen);
      chunks[count].dst_off = total;
      chunks[count].crc = crc;
      chunks[count].compressed = is_comp;
    }
    total += declen;
    count++;
    pos += 4 + length;
    if (is_comp && pay == 0) break;  // sequential reader stops (Empty)
  }
  *total_declen = total;
  return count;
}

}  // namespace

extern "C" {

int64_t stpu_frame_compress(const uint8_t* src, uint64_t n, uint8_t* dst,
                            uint64_t dst_cap, int threads, stpu_error* err) {
  err->code = STPU_OK;
  if (n == 0) return 0;
  if (n > kMaxInputSize) {
    err->code = STPU_E_TOO_BIG;
    err->a = n;
    err->b = kMaxInputSize;
    return -1;
  }
  uint64_t chunks = (n + kMaxBlockSize - 1) / kMaxBlockSize;
  uint64_t need = 10 + chunks * kChunkSlot;
  if (dst_cap < need) {
    err->code = STPU_E_BUFFER_TOO_SMALL;
    err->a = dst_cap;
    err->b = need;
    return -1;
  }
  std::memcpy(dst, kStreamIdent, 10);
  std::vector<uint32_t> sizes(chunks);
  FrameCompressCtx ctx{src, n, dst, sizes.data()};
  parallel_for(chunks, threads, frame_compress_range, &ctx);
  // Compact the per-chunk worst-case slots into a contiguous stream.
  uint64_t d = 10;
  for (uint64_t c = 0; c < chunks; c++) {
    uint8_t* from = dst + 10 + c * kChunkSlot;
    if (d != static_cast<uint64_t>(from - dst)) std::memmove(dst + d, from, sizes[c]);
    d += sizes[c];
  }
  return static_cast<int64_t>(d);
}

int64_t stpu_frame_decompress_len(const uint8_t* src, uint64_t n,
                                  stpu_error* err) {
  err->code = STPU_OK;
  uint64_t total = 0;
  stpu_error pending;
  frame_walk(src, n, nullptr, &total, &pending);
  // Structural errors surface during the decompress call, in order.
  return static_cast<int64_t>(total);
}

int64_t stpu_frame_decompress(const uint8_t* src, uint64_t n, uint8_t* dst,
                              uint64_t dst_cap, int threads, stpu_error* err) {
  err->code = STPU_OK;
  uint64_t total = 0;
  stpu_error pending;
  uint64_t count = frame_walk(src, n, nullptr, &total, &pending);
  if (total > dst_cap) {
    err->code = STPU_E_BUFFER_TOO_SMALL;
    err->a = dst_cap;
    err->b = total;
    return -1;
  }
  std::vector<FrameChunk> chunks(count);
  std::vector<stpu_error> errs(count);
  frame_walk(src, n, chunks.data(), &total, &pending);
  FrameDecompressCtx ctx{src, dst, chunks.data(), errs.data()};
  parallel_for(count, threads, frame_decompress_range, &ctx);
  for (uint64_t c = 0; c < count; c++) {
    if (errs[c].code != STPU_OK) {
      *err = errs[c];
      return -1;
    }
  }
  if (pending.code != STPU_OK) {
    *err = pending;
    return -1;
  }
  return static_cast<int64_t>(total);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched raw codec: many independent raw-format streams, chunk-parallel
// across host cores. The host mirror of the device batch API
// (snappy_tpu/ops/api.py) — rows are strided, each row is a complete raw
// stream (varint header + body), failures are isolated per row. This is
// the data-loader / serving shape: the reference crate has no batch
// entry point (its parallelism story is one stream at a time,
// src/raw.rs), so aggregate host throughput here is a framework
// addition, wire-compatible by construction.

namespace {

struct BatchCtx {
  const uint8_t* srcs;
  uint64_t src_stride;
  const uint64_t* lens;
  uint8_t* dsts;
  uint64_t dst_stride;
  uint64_t* out_lens;
  uint64_t* errs;  // n x 4: [code, a, b, c]
};

void batch_compress_range(uint64_t begin, uint64_t end, void* vctx) {
  auto* ctx = static_cast<BatchCtx*>(vctx);
  for (uint64_t i = begin; i < end; i++) {
    stpu_error e;
    int64_t n = stpu_compress(ctx->srcs + i * ctx->src_stride, ctx->lens[i],
                              ctx->dsts + i * ctx->dst_stride,
                              ctx->dst_stride, &e);
    uint64_t* row = ctx->errs + i * 4;
    if (n < 0) {
      row[0] = static_cast<uint64_t>(e.code);
      row[1] = e.a;
      row[2] = e.b;
      row[3] = e.c;
      ctx->out_lens[i] = 0;
    } else {
      row[0] = STPU_OK;
      ctx->out_lens[i] = static_cast<uint64_t>(n);
    }
  }
}

void batch_decompress_range(uint64_t begin, uint64_t end, void* vctx) {
  auto* ctx = static_cast<BatchCtx*>(vctx);
  for (uint64_t i = begin; i < end; i++) {
    stpu_error e;
    int64_t n = stpu_decompress(ctx->srcs + i * ctx->src_stride, ctx->lens[i],
                                ctx->dsts + i * ctx->dst_stride,
                                ctx->dst_stride, &e);
    uint64_t* row = ctx->errs + i * 4;
    if (n < 0) {
      row[0] = static_cast<uint64_t>(e.code);
      row[1] = e.a;
      row[2] = e.b;
      row[3] = e.c;
      ctx->out_lens[i] = 0;
    } else {
      row[0] = STPU_OK;
      ctx->out_lens[i] = static_cast<uint64_t>(n);
    }
  }
}

struct ScanBatchCtx {
  const uint8_t* srcs;
  uint64_t src_stride;
  const uint64_t* lens;
  uint8_t* bits;
  uint64_t bits_stride;
};

void batch_scan_range(uint64_t begin, uint64_t end, void* vctx) {
  auto* ctx = static_cast<ScanBatchCtx*>(vctx);
  for (uint64_t i = begin; i < end; i++)
    stpu_scan_ops(ctx->srcs + i * ctx->src_stride, ctx->lens[i],
                  ctx->bits + i * ctx->bits_stride);
}

struct ScanRecordsBatchCtx {
  const uint8_t* srcs;
  uint64_t src_stride;
  const uint64_t* lens;
  const uint64_t* declens;
  int32_t* recs;
  int64_t rec_cap;  // records per row (recs stride = rec_cap * 2 words)
  int64_t* nops;
  int32_t* errs;
  int64_t* dtotals;
};

void batch_scan_records_range(uint64_t begin, uint64_t end, void* vctx) {
  auto* ctx = static_cast<ScanRecordsBatchCtx*>(vctx);
  for (uint64_t i = begin; i < end; i++)
    ctx->nops[i] = stpu_scan_records(
        ctx->srcs + i * ctx->src_stride, ctx->lens[i], ctx->declens[i],
        ctx->recs + i * ctx->rec_cap * 2, ctx->rec_cap, &ctx->errs[i],
        &ctx->dtotals[i]);
}

struct FlattenBatchCtx {
  const uint8_t* srcs;
  uint64_t src_stride;
  const uint64_t* lens;
  const uint64_t* declens;
  int64_t s_rows;
  uint16_t* idx_rel;
  uint64_t d_pad;
  int32_t* tile_meta;  // per row: (d_pad/1024, 2)
  int64_t* fallbacks;
  int32_t* errs;
  int64_t* dtotals;
  int layout;
};

void batch_flatten_range(uint64_t begin, uint64_t end, void* vctx) {
  auto* ctx = static_cast<FlattenBatchCtx*>(vctx);
  const uint64_t meta_stride = (ctx->d_pad / 1024) * 2;
  for (uint64_t i = begin; i < end; i++)
    ctx->fallbacks[i] = stpu_flatten_idx(
        ctx->srcs + i * ctx->src_stride, ctx->lens[i], ctx->declens[i],
        ctx->s_rows, ctx->idx_rel + i * ctx->d_pad, ctx->d_pad,
        ctx->tile_meta + i * meta_stride, &ctx->errs[i], &ctx->dtotals[i],
        ctx->layout);
}

}  // namespace

extern "C" {

void stpu_compress_batch(const uint8_t* srcs, uint64_t src_stride,
                         const uint64_t* lens, uint8_t* dsts,
                         uint64_t dst_stride, uint64_t* out_lens,
                         uint64_t* errs, uint64_t n, int threads) {
  BatchCtx ctx{srcs, src_stride, lens, dsts, dst_stride, out_lens, errs};
  parallel_for(n, threads, batch_compress_range, &ctx);
}

void stpu_decompress_batch(const uint8_t* srcs, uint64_t src_stride,
                           const uint64_t* lens, uint8_t* dsts,
                           uint64_t dst_stride, uint64_t* out_lens,
                           uint64_t* errs, uint64_t n, int threads) {
  BatchCtx ctx{srcs, src_stride, lens, dsts, dst_stride, out_lens, errs};
  parallel_for(n, threads, batch_decompress_range, &ctx);
}

void stpu_scan_ops_batch(const uint8_t* srcs, uint64_t src_stride,
                         const uint64_t* lens, uint8_t* bits,
                         uint64_t bits_stride, uint64_t n, int threads) {
  ScanBatchCtx ctx{srcs, src_stride, lens, bits, bits_stride};
  parallel_for(n, threads, batch_scan_range, &ctx);
}

void stpu_scan_records_batch(const uint8_t* srcs, uint64_t src_stride,
                             const uint64_t* lens, const uint64_t* declens,
                             int32_t* recs, int64_t rec_cap, int64_t* nops,
                             int32_t* errs, int64_t* dtotals, uint64_t n,
                             int threads) {
  ScanRecordsBatchCtx ctx{srcs,    src_stride, lens, declens, recs,
                          rec_cap, nops,       errs, dtotals};
  parallel_for(n, threads, batch_scan_records_range, &ctx);
}

void stpu_flatten_idx_batch(const uint8_t* srcs, uint64_t src_stride,
                            const uint64_t* lens, const uint64_t* declens,
                            int64_t s_rows, uint16_t* idx_rel, uint64_t d_pad,
                            int32_t* tile_meta, int64_t* fallbacks,
                            int32_t* errs, int64_t* dtotals, uint64_t n,
                            int threads, int layout) {
  FlattenBatchCtx ctx{srcs,    src_stride, lens,      declens, s_rows,
                      idx_rel, d_pad,      tile_meta, fallbacks, errs,
                      dtotals, layout};
  parallel_for(n, threads, batch_flatten_range, &ctx);
}

}  // extern "C"
