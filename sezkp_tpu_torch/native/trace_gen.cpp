// Native trace generator: bit-exact Rust `rand` 0.9 StdRng (ChaCha12).
//
// Mirrors sezkp_tpu/trace/rng.py + generator.py exactly (PCG32 seed
// expansion, rand_chacha 4-block buffer, BlockRng word pairing, Canon's
// method for integer ranges, u64 Bernoulli). Cross-tested against the
// Python implementation and the reference's golden blocks.cbor.
//
// Build: part of libsezkp_blake3.so (see crypto/blake3.py build_native).

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t rotl32(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

struct ChaCha12 {
  uint32_t key[8];
  uint64_t block_counter = 0;
  uint32_t buf[64];
  int index = 64;

  void seed_from_u64(uint64_t state) {
    const uint64_t MUL = 6364136223846793005ull;
    const uint64_t INC = 11634580027462260723ull;
    for (int i = 0; i < 8; ++i) {
      state = state * MUL + INC;
      uint32_t xorshifted = (uint32_t)(((state >> 18) ^ state) >> 27);
      uint32_t rot = (uint32_t)(state >> 59);
      key[i] = (xorshifted >> rot) | (xorshifted << ((32u - rot) & 31u));
    }
  }

  void block(uint64_t counter, uint32_t out[16]) {
    static const uint32_t C[4] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u};
    uint32_t x[16];
    uint32_t s[16];
    s[0] = C[0]; s[1] = C[1]; s[2] = C[2]; s[3] = C[3];
    for (int i = 0; i < 8; ++i) s[4 + i] = key[i];
    s[12] = (uint32_t)counter;
    s[13] = (uint32_t)(counter >> 32);
    s[14] = 0;
    s[15] = 0;
    std::memcpy(x, s, sizeof(x));
    auto qr = [&x](int a, int b, int c, int d) {
      x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 16);
      x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 12);
      x[a] += x[b]; x[d] = rotl32(x[d] ^ x[a], 8);
      x[c] += x[d]; x[b] = rotl32(x[b] ^ x[c], 7);
    };
    for (int r = 0; r < 6; ++r) {
      qr(0, 4, 8, 12); qr(1, 5, 9, 13); qr(2, 6, 10, 14); qr(3, 7, 11, 15);
      qr(0, 5, 10, 15); qr(1, 6, 11, 12); qr(2, 7, 8, 13); qr(3, 4, 9, 14);
    }
    for (int i = 0; i < 16; ++i) out[i] = x[i] + s[i];
  }

  void refill() {
    for (int i = 0; i < 4; ++i) block(block_counter + i, buf + 16 * i);
    block_counter += 4;
    index = 0;
  }

  uint32_t next_u32() {
    if (index >= 64) refill();
    return buf[index++];
  }

  uint64_t next_u64() {
    if (index < 63) {
      if (index >= 64) refill();
      uint64_t lo = buf[index];
      uint64_t hi = buf[index + 1];
      index += 2;
      return (hi << 32) | lo;
    }
    if (index >= 64) {
      refill();
      uint64_t lo = buf[0];
      uint64_t hi = buf[1];
      index = 2;
      return (hi << 32) | lo;
    }
    // index == 63: straddle the refill
    uint64_t lo = buf[63];
    refill();
    uint64_t hi = buf[0];
    index = 1;
    return (hi << 32) | lo;
  }

  // rand 0.9 UniformInt sample_single_inclusive (Canon's method), u32 sample.
  uint32_t canon_u32(uint32_t range) {
    uint64_t prod = (uint64_t)next_u32() * range;
    uint32_t result = (uint32_t)(prod >> 32);
    uint32_t lo_order = (uint32_t)prod;
    if (lo_order > (uint32_t)(-(int32_t)range)) {
      uint32_t new_hi = (uint32_t)(((uint64_t)next_u32() * range) >> 32);
      uint64_t sum = (uint64_t)lo_order + new_hi;
      result += (uint32_t)(sum >> 32);
    }
    return result;
  }

  bool bernoulli(uint64_t p_int) { return next_u64() < p_int; }
};

}  // namespace

extern "C" {

// Generate t steps with tau tapes (seed 42; reference generator.rs:38-73).
// Outputs: input_mv[t] (i8), tape_mv[t*tau] (i8), write_flag[t*tau] (u8),
// write_sym[t*tau] (u16).
void sezkp_generate_trace(uint64_t t, uint32_t tau, int8_t *input_mv,
                          int8_t *tape_mv, uint8_t *write_flag,
                          uint16_t *write_sym) {
  ChaCha12 rng;
  rng.seed_from_u64(42);
  // Bernoulli(0.4): p_int = (0.4 * 2^64) as u64 (Rust f64 semantics).
  const uint64_t P40 = (uint64_t)(0.4 * 18446744073709551616.0);
  for (uint64_t i = 0; i < t; ++i) {
    input_mv[i] = (int8_t)((int32_t)rng.canon_u32(3) - 1);
    for (uint32_t r = 0; r < tau; ++r) {
      uint64_t idx = i * tau + r;
      if (rng.bernoulli(P40)) {
        write_flag[idx] = 1;
        write_sym[idx] = (uint16_t)rng.canon_u32(16);
      } else {
        write_flag[idx] = 0;
        write_sym[idx] = 0;
      }
      tape_mv[idx] = (int8_t)((int32_t)rng.canon_u32(3) - 1);
    }
  }
}

// ---- resumable (streaming) variant -----------------------------------------
// The generator state (ChaCha12) is a trivially-copyable POD; callers hold
// an opaque byte buffer of sezkp_trace_state_size() bytes so `simulate` can
// generate+partition+write the trace in bounded chunks instead of
// materializing all T steps (reference scripts sweep T to 2^27; a resident
// trace is 8.6 GB at 2^22 with tau=8).

size_t sezkp_trace_state_size() { return sizeof(ChaCha12); }

void sezkp_trace_state_init(void *state) {
  ChaCha12 rng;
  rng.seed_from_u64(42);
  std::memcpy(state, &rng, sizeof(rng));
}

void sezkp_generate_trace_chunk(void *state, uint64_t t, uint32_t tau,
                                int8_t *input_mv, int8_t *tape_mv,
                                uint8_t *write_flag, uint16_t *write_sym) {
  ChaCha12 rng;
  std::memcpy(&rng, state, sizeof(rng));
  const uint64_t P40 = (uint64_t)(0.4 * 18446744073709551616.0);
  for (uint64_t i = 0; i < t; ++i) {
    input_mv[i] = (int8_t)((int32_t)rng.canon_u32(3) - 1);
    for (uint32_t r = 0; r < tau; ++r) {
      uint64_t idx = i * tau + r;
      if (rng.bernoulli(P40)) {
        write_flag[idx] = 1;
        write_sym[idx] = (uint16_t)rng.canon_u32(16);
      } else {
        write_flag[idx] = 0;
        write_sym[idx] = 0;
      }
      tape_mv[idx] = (int8_t)((int32_t)rng.canon_u32(3) - 1);
    }
  }
  std::memcpy(state, &rng, sizeof(rng));
}

}  // extern "C"
