// Portable BLAKE3 implementation (from the public spec) with batch APIs
// tailored to the SEZKP-TPU host runtime:
//  - one-shot + incremental hashing with XOF output (transcript support)
//  - hash_many: N equal-length messages -> N x 32-byte digests
//  - parent_many: N (left,right) 32B pairs -> N parents (Merkle levels)
//  - merkle_root: left-balanced root with odd-promotion
//    (matches crates/sezkp-merkle/src/lib.rs:140-157 semantics)
//
// Build: crypto/blake3.py build_native() (produces _build/libsezkp_blake3.so)

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

constexpr uint32_t IV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                            0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u};

constexpr uint8_t MSG_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};

constexpr uint32_t CHUNK_START = 1u << 0;
constexpr uint32_t CHUNK_END = 1u << 1;
constexpr uint32_t PARENT = 1u << 2;
constexpr uint32_t ROOT = 1u << 3;

constexpr size_t BLOCK_LEN = 64;
constexpr size_t CHUNK_LEN = 1024;

static inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static inline void g(uint32_t *s, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
  s[a] = s[a] + s[b] + mx;
  s[d] = rotr(s[d] ^ s[a], 16);
  s[c] = s[c] + s[d];
  s[b] = rotr(s[b] ^ s[c], 12);
  s[a] = s[a] + s[b] + my;
  s[d] = rotr(s[d] ^ s[a], 8);
  s[c] = s[c] + s[d];
  s[b] = rotr(s[b] ^ s[c], 7);
}

static inline void round_fn(uint32_t *s, const uint32_t *m) {
  g(s, 0, 4, 8, 12, m[0], m[1]);
  g(s, 1, 5, 9, 13, m[2], m[3]);
  g(s, 2, 6, 10, 14, m[4], m[5]);
  g(s, 3, 7, 11, 15, m[6], m[7]);
  g(s, 0, 5, 10, 15, m[8], m[9]);
  g(s, 1, 6, 11, 12, m[10], m[11]);
  g(s, 2, 7, 8, 13, m[12], m[13]);
  g(s, 3, 4, 9, 14, m[14], m[15]);
}

// Full 16-word compression.
static void compress(const uint32_t cv[8], const uint32_t block[16], uint64_t counter,
                     uint32_t block_len, uint32_t flags, uint32_t out[16]) {
  uint32_t s[16] = {cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
                    IV[0], IV[1], IV[2], IV[3],
                    (uint32_t)counter, (uint32_t)(counter >> 32), block_len, flags};
  uint32_t m[16];
  std::memcpy(m, block, sizeof(m));
  for (int r = 0; r < 7; ++r) {
    round_fn(s, m);
    if (r != 6) {
      uint32_t p[16];
      for (int i = 0; i < 16; ++i) p[i] = m[MSG_PERM[i]];
      std::memcpy(m, p, sizeof(m));
    }
  }
  for (int i = 0; i < 8; ++i) {
    out[i] = s[i] ^ s[i + 8];
    out[i + 8] = s[i + 8] ^ cv[i];
  }
}

static inline void compress_cv(const uint32_t cv[8], const uint32_t block[16], uint64_t counter,
                               uint32_t block_len, uint32_t flags, uint32_t out_cv[8]) {
  uint32_t full[16];
  compress(cv, block, counter, block_len, flags, full);
  std::memcpy(out_cv, full, 8 * sizeof(uint32_t));
}

static void words_from_le(const uint8_t *p, size_t len, uint32_t out[16]) {
  uint8_t buf[BLOCK_LEN] = {0};
  std::memcpy(buf, p, len);
  for (int i = 0; i < 16; ++i) {
    out[i] = (uint32_t)buf[4 * i] | ((uint32_t)buf[4 * i + 1] << 8) |
             ((uint32_t)buf[4 * i + 2] << 16) | ((uint32_t)buf[4 * i + 3] << 24);
  }
}

struct Output {
  uint32_t cv[8];
  uint32_t block[16];
  uint64_t counter;
  uint32_t block_len;
  uint32_t flags;
};

static void output_cv(const Output &o, uint32_t out_cv[8]) {
  compress_cv(o.cv, o.block, o.counter, o.block_len, o.flags, out_cv);
}

static void output_root_bytes(const Output &o, uint8_t *out, size_t out_len) {
  uint64_t counter = 0;
  size_t off = 0;
  while (off < out_len) {
    uint32_t full[16];
    compress(o.cv, o.block, counter, o.block_len, o.flags | ROOT, full);
    uint8_t tmp[64];
    for (int i = 0; i < 16; ++i) {
      tmp[4 * i] = (uint8_t)full[i];
      tmp[4 * i + 1] = (uint8_t)(full[i] >> 8);
      tmp[4 * i + 2] = (uint8_t)(full[i] >> 16);
      tmp[4 * i + 3] = (uint8_t)(full[i] >> 24);
    }
    size_t take = out_len - off < 64 ? out_len - off : 64;
    std::memcpy(out + off, tmp, take);
    off += take;
    counter++;
  }
}

struct ChunkState {
  uint32_t cv[8];
  uint64_t chunk_counter;
  uint8_t block[BLOCK_LEN];
  uint8_t block_len;
  uint8_t blocks_compressed;
};

static void chunk_init(ChunkState &c, uint64_t counter) {
  std::memcpy(c.cv, IV, sizeof(IV));
  c.chunk_counter = counter;
  c.block_len = 0;
  c.blocks_compressed = 0;
}

static inline size_t chunk_len(const ChunkState &c) {
  return BLOCK_LEN * c.blocks_compressed + c.block_len;
}

static inline uint32_t chunk_start_flag(const ChunkState &c) {
  return c.blocks_compressed == 0 ? CHUNK_START : 0;
}

static void chunk_update(ChunkState &c, const uint8_t *data, size_t len) {
  size_t pos = 0;
  while (pos < len) {
    if (c.block_len == BLOCK_LEN) {
      uint32_t words[16];
      words_from_le(c.block, BLOCK_LEN, words);
      compress_cv(c.cv, words, c.chunk_counter, BLOCK_LEN, chunk_start_flag(c), c.cv);
      c.blocks_compressed++;
      c.block_len = 0;
    }
    size_t want = BLOCK_LEN - c.block_len;
    size_t take = len - pos < want ? len - pos : want;
    std::memcpy(c.block + c.block_len, data + pos, take);
    c.block_len += (uint8_t)take;
    pos += take;
  }
}

static Output chunk_output(const ChunkState &c) {
  Output o;
  std::memcpy(o.cv, c.cv, sizeof(o.cv));
  words_from_le(c.block, c.block_len, o.block);
  o.counter = c.chunk_counter;
  o.block_len = c.block_len;
  o.flags = chunk_start_flag(c) | CHUNK_END;
  return o;
}

static Output parent_output(const uint32_t left[8], const uint32_t right[8]) {
  Output o;
  std::memcpy(o.cv, IV, sizeof(IV));
  std::memcpy(o.block, left, 8 * sizeof(uint32_t));
  std::memcpy(o.block + 8, right, 8 * sizeof(uint32_t));
  o.counter = 0;
  o.block_len = BLOCK_LEN;
  o.flags = PARENT;
  return o;
}

struct HasherImpl {
  ChunkState chunk;
  uint32_t cv_stack[54][8];
  int stack_len;
};

static void hasher_init(HasherImpl &h) {
  chunk_init(h.chunk, 0);
  h.stack_len = 0;
}

static void hasher_add_chunk_cv(HasherImpl &h, uint32_t cv[8], uint64_t total_chunks) {
  while ((total_chunks & 1) == 0) {
    Output p = parent_output(h.cv_stack[--h.stack_len], cv);
    output_cv(p, cv);
    total_chunks >>= 1;
  }
  std::memcpy(h.cv_stack[h.stack_len++], cv, 8 * sizeof(uint32_t));
}

static void hasher_update(HasherImpl &h, const uint8_t *data, size_t len) {
  size_t pos = 0;
  while (pos < len) {
    if (chunk_len(h.chunk) == CHUNK_LEN) {
      Output o = chunk_output(h.chunk);
      uint32_t cv[8];
      output_cv(o, cv);
      uint64_t total = h.chunk.chunk_counter + 1;
      hasher_add_chunk_cv(h, cv, total);
      chunk_init(h.chunk, h.chunk.chunk_counter + 1);
    }
    size_t want = CHUNK_LEN - chunk_len(h.chunk);
    size_t take = len - pos < want ? len - pos : want;
    chunk_update(h.chunk, data + pos, take);
    pos += take;
  }
}

static void hasher_finalize(const HasherImpl &h, uint8_t *out, size_t out_len) {
  Output o = chunk_output(h.chunk);
  for (int i = h.stack_len - 1; i >= 0; --i) {
    uint32_t cv[8];
    output_cv(o, cv);
    o = parent_output(h.cv_stack[i], cv);
  }
  output_root_bytes(o, out, out_len);
}

// Fast path: single-chunk message (len <= 1024) straight to 32-byte digest.
static void hash_short(const uint8_t *data, size_t len, uint8_t out[32]) {
  uint32_t cv[8];
  std::memcpy(cv, IV, sizeof(IV));
  size_t nblocks = len == 0 ? 1 : (len + BLOCK_LEN - 1) / BLOCK_LEN;
  for (size_t b = 0; b < nblocks; ++b) {
    size_t off = b * BLOCK_LEN;
    size_t blen = (b == nblocks - 1) ? len - off : BLOCK_LEN;
    uint32_t words[16];
    words_from_le(data + off, blen, words);
    uint32_t flags = 0;
    if (b == 0) flags |= CHUNK_START;
    if (b == nblocks - 1) flags |= CHUNK_END | ROOT;
    if (b == nblocks - 1) {
      uint32_t full[16];
      compress(cv, words, 0, (uint32_t)blen, flags, full);
      for (int i = 0; i < 8; ++i) {
        out[4 * i] = (uint8_t)full[i];
        out[4 * i + 1] = (uint8_t)(full[i] >> 8);
        out[4 * i + 2] = (uint8_t)(full[i] >> 16);
        out[4 * i + 3] = (uint8_t)(full[i] >> 24);
      }
    } else {
      compress_cv(cv, words, 0, BLOCK_LEN, flags, cv);
    }
  }
}

}  // namespace

extern "C" {

void b3_hash(const uint8_t *data, size_t len, uint8_t *out, size_t out_len) {
  if (len <= CHUNK_LEN && out_len == 32) {
    hash_short(data, len, out);
    return;
  }
  HasherImpl h;
  hasher_init(h);
  hasher_update(h, data, len);
  hasher_finalize(h, out, out_len);
}

void *b3_new() {
  HasherImpl *h = new HasherImpl;
  hasher_init(*h);
  return h;
}

void *b3_copy(const void *hp) {
  HasherImpl *h = new HasherImpl;
  std::memcpy(h, hp, sizeof(HasherImpl));
  return h;
}

void b3_update(void *hp, const uint8_t *data, size_t len) {
  hasher_update(*(HasherImpl *)hp, data, len);
}

void b3_finalize(const void *hp, uint8_t *out, size_t out_len) {
  hasher_finalize(*(const HasherImpl *)hp, out, out_len);
}

void b3_free(void *hp) { delete (HasherImpl *)hp; }

// N equal-length messages, contiguous; each <= any length (tree logic used
// only when needed). out = N x 32 bytes.
void b3_hash_many(const uint8_t *data, size_t n, size_t msg_len, uint8_t *out) {
  if (msg_len <= CHUNK_LEN) {
    for (size_t i = 0; i < n; ++i) hash_short(data + i * msg_len, msg_len, out + i * 32);
  } else {
    for (size_t i = 0; i < n; ++i) b3_hash(data + i * msg_len, msg_len, out + i * 32, 32);
  }
}

// N pairs of 32-byte nodes (64 bytes each) -> N parent hashes.
// Parent rule: BLAKE3(left || right) (64-byte message, single block).
void b3_parent_many(const uint8_t *pairs, size_t n, uint8_t *out) {
  for (size_t i = 0; i < n; ++i) hash_short(pairs + i * 64, 64, out + i * 32);
}

// Left-balanced Merkle root over n 32-byte leaves with odd-promotion.
// Empty input -> zero root. Matches crates/sezkp-merkle/src/lib.rs:140-157.
void b3_merkle_root(const uint8_t *leaves, size_t n, uint8_t *out) {
  if (n == 0) {
    std::memset(out, 0, 32);
    return;
  }
  std::vector<uint8_t> cur(leaves, leaves + n * 32);
  size_t len = n;
  std::vector<uint8_t> next;
  while (len > 1) {
    size_t half = len / 2;
    size_t rem = len & 1;
    next.resize((half + rem) * 32);
    for (size_t i = 0; i < half; ++i)
      hash_short(cur.data() + 2 * i * 32, 64, next.data() + i * 32);
    if (rem) std::memcpy(next.data() + half * 32, cur.data() + (len - 1) * 32, 32);
    cur.swap(next);
    len = half + rem;
  }
  std::memcpy(out, cur.data(), 32);
}

}  // extern "C"

// ---- C ABI version surface (reference: crates/sezkp-ffi/src/lib.rs:49-99) --

extern "C" {

unsigned int sezkp_abi_version() { return 1u; }

const char *sezkp_version() { return "0.1.0"; }

}  // extern "C"
