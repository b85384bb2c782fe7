// Batched SHA-256 of byte strings for Hopper (sm_90a): one message a lane,
// a pair of warps for 32 lanes, the producer warp staging bytes and
// expanding the message schedule, the consumer warp running the rounds
// (csrc/hash_lanes.cuh holds the lanes, the pairs, the staging and the
// launch; this file the FIPS 180-4 SHA-256 schedule and rounds).
//
// Replaces the TPU kernel zpaqfranz_tpu/ops/hash_pallas.py
// _build_call(nstate=8) (body _make_kernel / _sha256_block).
//
// Bound (chip_smoke.py): the largest of three terms. Instructions: 1,384
// per 64-byte block (64 rounds of 14, 48 schedule steps of 10, 8 final
// adds; 3-input logic is one LOP3 and 3-input adds one IADD3) over the
// card's INT32 rate. Bytes: each input byte read once over 3.35 TB/s. The
// chain: a round's critical path is 3 dependent instructions (e's three
// funnel shifts side by side, the LOP3 of S1 beside ch's, then one IADD3
// with h + K + w summed off the path; a's path is as long), 193 a block
// with the final add, at the cycles a dependent instruction takes one lane
// alone, times the longest lane's blocks. The consumer issues the rounds'
// 904 instructions a block, the producer the schedule's 480 and the rest.

#include "hash_lanes.cuh"

namespace {

using hash_lanes::u32;

__constant__ u32 K256[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__device__ __forceinline__ u32 rotr(u32 x, int k) {
  return __funnelshift_r(x, x, k);
}

struct Sha256 {
  static constexpr int NSTATE = 8;
  static constexpr int WORDS = 64;

  __device__ static __forceinline__ void init(u32 st[8]) {
    st[0] = 0x6a09e667u; st[1] = 0xbb67ae85u; st[2] = 0x3c6ef372u;
    st[3] = 0xa54ff53au; st[4] = 0x510e527fu; st[5] = 0x9b05688cu;
    st[6] = 0x1f83d9abu; st[7] = 0x5be0cd19u;
  }

  // the 64 words of the message schedule, on the producer warp
  template <class Store>
  __device__ static __forceinline__ void schedule(u32 w[16], Store store) {
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      if (t >= 16) {
        const u32 x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
        const u32 s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
        const u32 s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
        w[t & 15] += s0 + w[(t - 7) & 15] + s1;
      }
      store(t, w[t & 15]);
    }
  }

  // the 64 rounds, on the consumer warp
  template <class Load>
  __device__ static __forceinline__ void rounds(u32 st[8], Load load) {
    u32 a = st[0], b = st[1], c = st[2], d = st[3];
    u32 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      const u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      const u32 ch = (e & f) ^ (~e & g);
      const u32 t1 = S1 + ch + (h + K256[t] + load(t));
      const u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      const u32 maj = (a & b) ^ (a & c) ^ (b & c);
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + S0 + maj;
    }
    st[0] += a; st[1] += b; st[2] += c; st[3] += d;
    st[4] += e; st[5] += f; st[6] += g; st[7] += h;
  }
};

}  // namespace

extern "C" int sha256_lanes_launch(const void* data, const void* off,
                                   const void* len, const void* order,
                                   void* out, void* prof, long long n,
                                   long long nbytes, long long blocks,
                                   void* stream) {
  return hash_lanes::launch<Sha256>(data, off, len, order, out, prof, n,
                                    nbytes, blocks, stream);
}
