// A Zstandard decoder (RFC 8878) in host C++, behind a plain C interface.
//
// The JAX package's Orbax checkpoints keep every array as zarr chunks
// compressed with zstd, inside an OCDBT key-value store whose manifests and
// B-tree nodes are zstd-compressed too (retinex_tpu_torch/train/orbax.py
// reads both). This file decodes those frames, so the port reads a
// checkpoint with nothing but a C++ compiler: it is built on first use with
// the host's c++ (ops/_kernels.py::host_library) and loaded with ctypes.
//
// What it decodes:
//   - frames with and without a content size, single-segment or windowed,
//     with or without a content checksum (XXH64, checked);
//   - raw, RLE and compressed blocks;
//   - literals raw, RLE or Huffman-coded (tree described by FSE-compressed or
//     direct weights), in one or four streams, and the treeless repeat;
//   - sequences with each code table predefined, RLE, FSE-described or
//     repeated from the previous block, and the three repeat offsets;
//   - several frames one after another, and skippable frames.
// A dictionary ID other than 0 raises, as does anything malformed: every
// read is bounds-checked, every table and bitstream checked for its exact
// length, and a match may not reach before the frame's first byte.
//
// The algorithms follow the RFC's own description (the decoding tables are
// built as its "educational decoder" builds them); the bit readers load
// little-endian words.
//
// C interface:
//   int zstd_decode(src, n, &out, &out_len, err, err_cap)
//       0 and a malloc'd buffer (free it with zstd_free), or nonzero and a
//       message in err.
//   void zstd_free(out)
//   uint32_t crc32c(p, n)   CRC-32C (Castagnoli), as OCDBT files carry it.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Corrupt(what); }

constexpr size_t kBlockMax = 128 * 1024;

inline uint32_t rd16(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8; }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | uint32_t(p[2]) << 16; }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | rd16(p + 2) << 16; }
inline uint64_t rd64(const uint8_t* p) { return uint64_t(rd32(p)) | uint64_t(rd32(p + 4)) << 32; }

inline uint64_t load_le64(const uint8_t* p) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
#else
  return rd64(p);
#endif
}

inline int highbit(uint32_t x) { return 31 - __builtin_clz(x); }  // x > 0

// ---- bit readers -------------------------------------------------------

// Forward, least significant bit first (FSE table descriptions). Bits past
// the end read as 0; the caller checks bytes() against the length.
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;

  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++bit) {
      if ((bit >> 3) < n) v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes() const { return (bit + 7) >> 3; }
};

// Backward: the stream is read from its last bit towards its first, after
// the final byte's highest set bit (the end mark). `offset` counts the bits
// left; reads past the start give zeros and drive it negative, which the
// callers test.
struct BackwardBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t offset = 0;

  void init(const uint8_t* src, size_t len) {
    if (len == 0) fail("empty bitstream");
    if (src[len - 1] == 0) fail("bitstream without its end mark");
    p = src;
    n = len;
    offset = int64_t(len - 1) * 8 + highbit(src[len - 1]);
  }

  // bits [lo, lo + k) of the stream, k <= 32
  uint64_t bits_at(int64_t lo, int k) const {
    size_t byte = size_t(lo >> 3);
    uint64_t w = 0;
    if (n - byte >= 8) {
      w = load_le64(p + byte);
    } else {
      for (size_t i = 0; byte + i < n; ++i) w |= uint64_t(p[byte + i]) << (8 * i);
    }
    return (w >> (lo & 7)) & ((uint64_t(1) << k) - 1);
  }

  uint64_t read(int k) {
    if (k == 0) return 0;
    offset -= k;
    if (offset >= 0) return bits_at(offset, k);
    int have = int(k + offset);
    if (have <= 0) return 0;
    return bits_at(0, have) << (-offset);
  }
};

// ---- FSE ------------------------------------------------------------------

struct FseEntry {
  uint8_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct Fse {
  int log = 0;
  std::vector<FseEntry> t;
  bool ready = false;
};

// The decoding table of a normalised distribution (-1: "less than one").
void fse_build(Fse& f, const int16_t* freq, int nsym, int log) {
  const uint32_t size = 1u << log;
  f.log = log;
  f.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint16_t> next(size_t(nsym), 0);
  uint32_t high = size;
  for (int s = 0; s < nsym; ++s) {
    if (freq[s] == -1) {
      if (high == 0) fail("FSE table: too many low-probability symbols");
      f.t[--high].symbol = uint8_t(s);
      next[s] = 1;
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (freq[s] <= 0) continue;
    if (high == 0) fail("FSE table: no room for the spread");
    next[s] = uint16_t(freq[s]);
    for (int i = 0; i < freq[s]; ++i) {
      f.t[pos].symbol = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE table: the distribution does not fill the table");
  for (uint32_t i = 0; i < size; ++i) {
    const uint16_t x = next[f.t[i].symbol]++;
    const int nb = log - highbit(x);
    f.t[i].bits = uint8_t(nb);
    f.t[i].base = uint16_t((uint32_t(x) << nb) - size);
  }
  f.ready = true;
}

// An FSE table description; returns the bytes it took.
size_t fse_read(Fse& f, const uint8_t* src, size_t len, int max_log, int max_sym) {
  if (len == 0) fail("FSE table description: no bytes");
  ForwardBits b{src, len};
  const int log = 5 + int(b.read(4));
  if (log > max_log) fail("FSE table: accuracy log " + std::to_string(log) + " over " + std::to_string(max_log));
  int32_t remaining = 1 << log;
  int16_t freq[256];
  int sym = 0;
  while (remaining > 0) {
    if (sym > max_sym) fail("FSE table: more symbols than the alphabet holds");
    const int bits = highbit(uint32_t(remaining + 1)) + 1;
    uint32_t val = b.read(bits);
    const uint32_t lower_mask = (1u << (bits - 1)) - 1;
    const uint32_t threshold = (1u << bits) - 1 - uint32_t(remaining + 1);
    if ((val & lower_mask) < threshold) {
      b.bit -= 1;
      val &= lower_mask;
    } else if (val > lower_mask) {
      val -= threshold;
    }
    const int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    freq[sym++] = int16_t(proba);
    if (proba == 0) {
      uint32_t rep = b.read(2);
      for (;;) {
        for (uint32_t i = 0; i < rep; ++i) {
          if (sym > max_sym) fail("FSE table: zero run past the alphabet");
          freq[sym++] = 0;
        }
        if (rep != 3) break;
        rep = b.read(2);
      }
    }
  }
  if (remaining != 0) fail("FSE table: probabilities do not sum to the table size");
  if (b.bytes() > len) fail("FSE table description runs past its section");
  fse_build(f, freq, sym, log);
  return b.bytes();
}

// ---- Huffman --------------------------------------------------------------

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> symbol, bits;
  bool ready = false;
};

// A Huffman tree description; returns the bytes it took.
size_t huffman_read(Huffman& h, const uint8_t* src, size_t len) {
  if (len == 0) fail("Huffman tree description: no bytes");
  uint8_t w[256];
  int n = 0;
  size_t used;
  const uint8_t head = src[0];
  if (head >= 128) {
    n = head - 127;
    used = 1 + size_t(n + 1) / 2;
    if (used > len) fail("Huffman weights run past the literals section");
    for (int i = 0; i < n; ++i) w[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
  } else {
    used = 1 + size_t(head);
    if (used > len) fail("Huffman weights run past the literals section");
    Fse f;
    const size_t hdr = fse_read(f, src + 1, head, 6, 255);
    if (hdr >= head) fail("Huffman weights: no bitstream after the table");
    BackwardBits br;
    br.init(src + 1 + hdr, head - hdr);
    uint32_t s1 = uint32_t(br.read(f.log)), s2 = uint32_t(br.read(f.log));
    for (;;) {
      if (n >= 255) fail("Huffman weights: more than 255");
      w[n++] = f.t[s1].symbol;
      s1 = f.t[s1].base + uint32_t(br.read(f.t[s1].bits));
      if (br.offset < 0) {
        if (n >= 255) fail("Huffman weights: more than 255");
        w[n++] = f.t[s2].symbol;
        break;
      }
      if (n >= 255) fail("Huffman weights: more than 255");
      w[n++] = f.t[s2].symbol;
      s2 = f.t[s2].base + uint32_t(br.read(f.t[s2].bits));
      if (br.offset < 0) {
        if (n >= 255) fail("Huffman weights: more than 255");
        w[n++] = f.t[s1].symbol;
        break;
      }
    }
  }
  uint32_t sum = 0;
  for (int i = 0; i < n; ++i) {
    if (w[i] > 11) fail("Huffman weight over 11");
    if (w[i]) sum += 1u << (w[i] - 1);
  }
  if (sum == 0) fail("Huffman weights all zero");
  const int max_bits = highbit(sum) + 1;
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  const uint32_t left = (1u << max_bits) - sum;
  if (left & (left - 1)) fail("Huffman weights: the implied last weight is not a power of two");
  w[n++] = uint8_t(highbit(left) + 1);

  uint8_t nb[256];
  uint32_t rank_count[13] = {0};
  for (int i = 0; i < n; ++i) {
    nb[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
    rank_count[nb[i]]++;
  }
  const uint32_t size = 1u << max_bits;
  h.max_bits = max_bits;
  h.symbol.assign(size, 0);
  h.bits.assign(size, 0);
  uint32_t rank_idx[13] = {0};
  rank_idx[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    rank_idx[b - 1] = rank_idx[b] + rank_count[b] * (1u << (max_bits - b));
    if (rank_idx[b - 1] > size) fail("Huffman weights overfill the table");
    std::memset(&h.bits[rank_idx[b]], b, rank_idx[b - 1] - rank_idx[b]);
  }
  if (rank_idx[0] != size) fail("Huffman weights do not fill the table");
  for (int i = 0; i < n; ++i) {
    if (!nb[i]) continue;
    const uint32_t code = rank_idx[nb[i]], len_i = 1u << (max_bits - nb[i]);
    std::memset(&h.symbol[code], i, len_i);
    rank_idx[nb[i]] += len_i;
  }
  h.ready = true;
  return used;
}

void huffman_stream(const Huffman& h, const uint8_t* src, size_t len, uint8_t* out, size_t nout) {
  BackwardBits br;
  br.init(src, len);
  // Each symbol peeks the next max_bits bits (the table holds every code
  // under all its completions) and consumes its own length.
  const int mb = h.max_bits;
  const uint64_t mask = (uint64_t(1) << mb) - 1;
  int64_t pos = br.offset;
  for (size_t i = 0; i < nout; ++i) {
    const int64_t lo = pos - mb;
    uint32_t idx;
    if (lo >= 0 && (size_t(lo) >> 3) + 8 <= len) {
      idx = uint32_t((load_le64(src + (lo >> 3)) >> (lo & 7)) & mask);
    } else if (lo >= 0) {
      idx = uint32_t(br.bits_at(lo, mb));
    } else {
      idx = lo > -mb ? uint32_t(br.bits_at(0, int(mb + lo)) << (-lo)) : 0;
    }
    out[i] = h.symbol[idx];
    pos -= h.bits[idx];
  }
  if (pos != 0) fail("Huffman stream length does not match its literals");
}

// ---- sequences ------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,   13,   14,   15,   16,    17,    18,   19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28,  29,  30,   31,   32,   33,   34,    35,    37,   39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  Huffman huffman;
  Fse ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
};

// One code table by its mode; returns the bytes it took.
size_t seq_table(Fse& f, int mode, const uint8_t* p, size_t n, const int16_t* def, int def_n, int def_log,
                 int max_log, int max_sym, const char* name) {
  switch (mode) {
    case 0:
      fse_build(f, def, def_n, def_log);
      return 0;
    case 1:
      if (n < 1) fail(std::string(name) + " RLE table: no byte");
      if (p[0] > max_sym) fail(std::string(name) + " RLE symbol out of range");
      f.log = 0;
      f.t.assign(1, FseEntry{p[0], 0, 0});
      f.ready = true;
      return 1;
    case 2:
      return fse_read(f, p, n, max_log, max_sym);
    default:
      if (!f.ready) fail(std::string(name) + " table repeated with no table before it");
      return 0;
  }
}

size_t read_literals(const uint8_t* p, size_t n, FrameState& st) {
  if (n < 1) fail("block without a literals section");
  const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
  std::vector<uint8_t>& lit = st.literals;
  if (type <= 1) {
    size_t regen, hdr;
    if ((sf & 1) == 0) {
      regen = p[0] >> 3;
      hdr = 1;
    } else if (sf == 1) {
      if (n < 2) fail("literals header truncated");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
      hdr = 2;
    } else {
      if (n < 3) fail("literals header truncated");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      hdr = 3;
    }
    if (regen > kBlockMax) fail("literals over the block maximum");
    if (type == 0) {
      if (n < hdr + regen) fail("raw literals truncated");
      lit.assign(p + hdr, p + hdr + regen);
      return hdr + regen;
    }
    if (n < hdr + 1) fail("RLE literals truncated");
    lit.assign(regen, p[hdr]);
    return hdr + 1;
  }
  static const int kHdr[4] = {3, 3, 4, 5}, kBits[4] = {10, 10, 14, 18};
  const size_t hdr = size_t(kHdr[sf]);
  const int bits = kBits[sf];
  const int streams = sf == 0 ? 1 : 4;
  if (n < hdr) fail("literals header truncated");
  uint64_t v = 0;
  for (size_t i = 0; i < hdr; ++i) v |= uint64_t(p[i]) << (8 * i);
  const size_t regen = size_t((v >> 4) & ((1u << bits) - 1));
  const size_t comp = size_t((v >> (4 + bits)) & ((1u << bits) - 1));
  if (regen > kBlockMax) fail("literals over the block maximum");
  if (n < hdr + comp) fail("compressed literals truncated");
  const uint8_t* q = p + hdr;
  size_t qn = comp;
  if (type == 2) {
    const size_t used = huffman_read(st.huffman, q, qn);
    q += used;
    qn -= used;
  } else if (!st.huffman.ready) {
    fail("treeless literals with no Huffman table before them");
  }
  lit.resize(regen);
  if (streams == 1) {
    huffman_stream(st.huffman, q, qn, lit.data(), regen);
  } else {
    if (qn < 6) fail("four-stream literals: jump table truncated");
    const size_t s1 = rd16(q), s2 = rd16(q + 2), s3 = rd16(q + 4);
    if (6 + s1 + s2 + s3 > qn) fail("four-stream literals: streams past the section");
    const size_t s4 = qn - 6 - s1 - s2 - s3;
    const size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("four-stream literals: too few literals for four streams");
    const uint8_t* s = q + 6;
    huffman_stream(st.huffman, s, s1, lit.data(), seg);
    huffman_stream(st.huffman, s + s1, s2, lit.data() + seg, seg);
    huffman_stream(st.huffman, s + s1 + s2, s3, lit.data() + 2 * seg, seg);
    huffman_stream(st.huffman, s + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg);
  }
  return hdr + comp;
}

void compressed_block(const uint8_t* p, size_t n, FrameState& st, std::vector<uint8_t>& out, size_t frame_start) {
  const size_t block_start = out.size();
  const size_t used = read_literals(p, n, st);
  p += used;
  n -= used;
  if (n < 1) fail("block without a sequences section");
  size_t nseq = p[0], hdr = 1;
  if (nseq >= 128) {
    if (nseq < 255) {
      if (n < 2) fail("sequence count truncated");
      nseq = ((nseq - 128) << 8) + p[1];
      hdr = 2;
    } else {
      if (n < 3) fail("sequence count truncated");
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      hdr = 3;
    }
  }
  const std::vector<uint8_t>& lit = st.literals;
  size_t lit_pos = 0;
  // The block's output is written in place into room for the largest
  // block, then cut to what it holds.
  out.resize(block_start + kBlockMax);
  uint8_t* o = out.data();
  size_t at = block_start;
  if (nseq > 0) {
    if (n < hdr + 1) fail("sequence modes truncated");
    const uint8_t modes = p[hdr];
    if (modes & 3) fail("sequence modes: reserved bits set");
    size_t pos = hdr + 1;
    pos += seq_table(st.ll, modes >> 6, p + pos, n - pos, kLLDefault, 36, 6, 9, 35, "literal-length");
    pos += seq_table(st.of, (modes >> 4) & 3, p + pos, n - pos, kOFDefault, 29, 5, 8, 31, "offset");
    pos += seq_table(st.ml, (modes >> 2) & 3, p + pos, n - pos, kMLDefault, 53, 6, 9, 52, "match-length");
    if (pos >= n) fail("sequences without a bitstream");
    BackwardBits br;
    br.init(p + pos, n - pos);
    uint32_t sll = uint32_t(br.read(st.ll.log)), sof = uint32_t(br.read(st.of.log)),
             sml = uint32_t(br.read(st.ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry &ell = st.ll.t[sll], &eof = st.of.t[sof], &eml = st.ml.t[sml];
      const int ofc = eof.symbol;
      const uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
      const size_t ml = kMLBase[eml.symbol] + size_t(br.read(kMLBits[eml.symbol]));
      const size_t ll = kLLBase[ell.symbol] + size_t(br.read(kLLBits[ell.symbol]));
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = offset;
      } else {
        const uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = st.rep[0];
        } else {
          offset = idx < 3 ? st.rep[idx] : st.rep[0] - 1;
          if (idx > 1) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = ell.base + uint32_t(br.read(ell.bits));
        sml = eml.base + uint32_t(br.read(eml.bits));
        sof = eof.base + uint32_t(br.read(eof.bits));
      }
      if (ll > lit.size() - lit_pos) fail("sequence takes more literals than the block has");
      if (at - block_start + ll + ml > kBlockMax) fail("block output over the block maximum");
      std::memcpy(o + at, lit.data() + lit_pos, ll);
      lit_pos += ll;
      at += ll;
      if (offset == 0 || offset > at - frame_start) fail("match offset reaches before the frame");
      // An overlapping match repeats its last `offset` bytes: copy from
      // `from` in chunks that double, each a whole number of periods.
      const size_t from = at - size_t(offset);
      for (size_t done = 0; done < ml;) {
        const size_t k = std::min(ml - done, at + done - from);
        std::memcpy(o + at + done, o + from, k);
        done += k;
      }
      at += ml;
    }
    if (br.offset != 0) fail("sequence bitstream length does not match its sequences");
  } else if (n != hdr) {
    fail("bytes after an empty sequences section");
  }
  if (at - block_start + (lit.size() - lit_pos) > kBlockMax) fail("block output over the block maximum");
  std::memcpy(o + at, lit.data() + lit_pos, lit.size() - lit_pos);
  out.resize(at + lit.size() - lit_pos);
}

// ---- XXH64 (the content checksum) ---------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                   P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* const end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += len;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- frames ---------------------------------------------------------------

// One frame at p (its magic already checked); returns the bytes it took.
size_t frame(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  size_t pos = 4;
  if (n < pos + 1) fail("frame header truncated");
  const uint8_t fhd = p[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  if (fhd & 8) fail("frame header: reserved bit set");
  if (!single) {
    if (n < pos + 1) fail("frame header truncated");
    pos += 1;  // the window descriptor: every match is checked against the frame's own output
  }
  static const int kDid[4] = {0, 1, 2, 4};
  const int did_size = kDid[did_flag];
  const int fcs_size = fcs_flag == 0 ? single : (1 << fcs_flag);
  if (n < pos + size_t(did_size) + size_t(fcs_size)) fail("frame header truncated");
  uint64_t did = 0;
  for (int i = 0; i < did_size; ++i) did |= uint64_t(p[pos + i]) << (8 * i);
  pos += did_size;
  if (did != 0) fail("frame needs dictionary " + std::to_string(did) + ": dictionaries are not supported");
  uint64_t fcs = 0;
  for (int i = 0; i < fcs_size; ++i) fcs |= uint64_t(p[pos + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  pos += fcs_size;

  const size_t frame_start = out.size();
  if (fcs_size > 0 && fcs < (uint64_t(1) << 32)) out.reserve(frame_start + size_t(fcs));
  FrameState st;
  for (;;) {
    if (n < pos + 3) fail("block header truncated");
    const uint32_t bh = rd24(p + pos);
    pos += 3;
    const int last = bh & 1, type = (bh >> 1) & 3;
    const size_t size = bh >> 3;
    if (size > kBlockMax) fail("block over the block maximum");
    if (type == 0) {
      if (n < pos + size) fail("raw block truncated");
      out.insert(out.end(), p + pos, p + pos + size);
      pos += size;
    } else if (type == 1) {
      if (n < pos + 1) fail("RLE block truncated");
      out.insert(out.end(), size, p[pos]);
      pos += 1;
    } else if (type == 2) {
      if (n < pos + size) fail("compressed block truncated");
      compressed_block(p + pos, size, st, out, frame_start);
      pos += size;
    } else {
      fail("reserved block type");
    }
    if (last) break;
  }
  if (fcs_size > 0 && out.size() - frame_start != fcs) fail("frame content size does not match its blocks");
  if (checksum) {
    if (n < pos + 4) fail("content checksum truncated");
    if (uint32_t(xxh64(out.data() + frame_start, out.size() - frame_start)) != rd32(p + pos))
      fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

void decode_all(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  if (n == 0) fail("no zstd frame in an empty input");
  size_t pos = 0;
  while (pos < n) {
    if (n - pos < 4) fail("trailing bytes too short for a frame");
    const uint32_t magic = rd32(p + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail("skippable frame header truncated");
      const size_t size = rd32(p + pos + 4);
      if (n - pos - 8 < size) fail("skippable frame truncated");
      pos += 8 + size;
      continue;
    }
    if (magic != 0xFD2FB528u) fail("not a zstd frame (magic " + std::to_string(magic) + ")");
    pos += frame(p + pos, n - pos, out);
  }
}

uint32_t kCrcTable[256];
bool kCrcReady = [] {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    kCrcTable[i] = c;
  }
  return true;
}();

}  // namespace

extern "C" {

int zstd_decode(const uint8_t* src, size_t n, uint8_t** out, size_t* out_len, char* err, size_t err_cap) {
  *out = nullptr;
  *out_len = 0;
  try {
    std::vector<uint8_t> v;
    decode_all(src, n, v);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(v.size() ? v.size() : 1));
    if (buf == nullptr) throw std::bad_alloc();
    if (!v.empty()) std::memcpy(buf, v.data(), v.size());
    *out = buf;
    *out_len = v.size();
    return 0;
  } catch (const Corrupt& e) {
    std::snprintf(err, err_cap, "%s", e.what());
    return 1;
  } catch (const std::bad_alloc&) {
    std::snprintf(err, err_cap, "out of memory");
    return 2;
  }
}

void zstd_free(uint8_t* p) { std::free(p); }

uint32_t crc32c(const uint8_t* p, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = kCrcTable[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
