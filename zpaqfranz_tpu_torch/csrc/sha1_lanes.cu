// Batched SHA-1 of byte strings for Hopper (sm_90a): one message a lane, a
// pair of warps for 32 lanes, the producer warp staging bytes and expanding
// the message schedule, the consumer warp running the rounds
// (csrc/hash_lanes.cuh holds the lanes, the pairs, the staging and the
// launch; this file the FIPS 180-4 SHA-1 schedule and rounds).
//
// Replaces the TPU kernel zpaqfranz_tpu/ops/hash_pallas.py
// _build_call(nstate=5) (body _make_kernel / _sha1_block).
//
// Bound (chip_smoke.py): the largest of three terms. Instructions: 597 per
// 64-byte block (80 rounds of 5, 64 schedule words of 3, 5 final adds;
// 3-input logic is one LOP3 and 3-input adds one IADD3) over the card's
// INT32 rate. Bytes: each input byte read once over 3.35 TB/s. The chain:
// a round's critical path is 2 dependent instructions (rotl(a, 5) beside
// f's LOP3, then one IADD3 with e + k + w summed off the path), 161 a block
// with the final add, at the cycles a dependent instruction takes one lane
// alone, times the longest lane's blocks. The consumer issues the rounds'
// 405 instructions a block, the producer the schedule's 192 and the rest.

#include "hash_lanes.cuh"

namespace {

using hash_lanes::u32;

__device__ __forceinline__ u32 rotl(u32 x, int k) {
  return __funnelshift_l(x, x, k);
}

struct Sha1 {
  static constexpr int NSTATE = 5;
  static constexpr int WORDS = 80;

  __device__ static __forceinline__ void init(u32 st[5]) {
    st[0] = 0x67452301u; st[1] = 0xEFCDAB89u; st[2] = 0x98BADCFEu;
    st[3] = 0x10325476u; st[4] = 0xC3D2E1F0u;
  }

  // the 80 words of the message schedule, on the producer warp
  template <class Store>
  __device__ static __forceinline__ void schedule(u32 w[16], Store store) {
#pragma unroll
    for (int t = 0; t < 80; ++t) {
      if (t >= 16)
        w[t & 15] = rotl(w[(t - 3) & 15] ^ w[(t - 8) & 15] ^ w[(t - 14) & 15]
                         ^ w[t & 15], 1);
      store(t, w[t & 15]);
    }
  }

  // the 80 rounds, on the consumer warp
  template <class Load>
  __device__ static __forceinline__ void rounds(u32 st[5], Load load) {
    u32 a = st[0], b = st[1], c = st[2], d = st[3], e = st[4];
#pragma unroll
    for (int t = 0; t < 80; ++t) {
      u32 f, k;
      if (t < 20) { f = (b & c) | (~b & d); k = 0x5A827999u; }
      else if (t < 40) { f = b ^ c ^ d; k = 0x6ED9EBA1u; }
      else if (t < 60) { f = (b & c) | (b & d) | (c & d); k = 0x8F1BBCDCu; }
      else { f = b ^ c ^ d; k = 0xCA62C1D6u; }
      const u32 x = e + k + load(t);        // off the chain
      const u32 tmp = rotl(a, 5) + f + x;
      e = d; d = c; c = rotl(b, 30); b = a; a = tmp;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d; st[4] += e;
  }
};

}  // namespace

extern "C" int sha1_lanes_launch(const void* data, const void* off,
                                 const void* len, const void* order,
                                 void* out, void* prof, long long n,
                                 long long nbytes, long long blocks,
                                 void* stream) {
  return hash_lanes::launch<Sha1>(data, off, len, order, out, prof, n,
                                  nbytes, blocks, stream);
}
