// Batched SHA-256 of byte strings for Hopper (sm_90a): one message per thread.
//
// Replaces the TPU kernel zpaqfranz_tpu/ops/hash_pallas.py
// _build_call(nstate=8) (body _make_kernel / _sha256_block), which held the
// state of an (8, 128) lane tile in VMEM scratch and stepped one 64-byte
// block per grid step, with long messages chained through a host-side
// window ladder. As in sha1_lanes.cu, each thread walks its own message's
// blocks in a loop, so there is no ladder and no host staging: the input is
// the concatenated message bytes plus per-lane offsets and lengths, and the
// thread builds the FIPS 180-4 padding (0x80, zeros, 64-bit big-endian bit
// length) of its last one or two blocks in registers.
//
// Bound: 1,384 integer instructions per 64-byte block (64 rounds of 14, 48
// schedule steps of 10, 8 final adds; 3-input logic is one LOP3 and 3-input
// adds one IADD3, as chip_smoke.py counts them) against the card's INT32
// rate, and each input byte read once against 3.35 TB/s. Each thread reads
// its own message, so loads do not coalesce across a warp; lanes are sorted
// longest first (the wrapper passes the order) so a warp's threads run
// similar block counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint8_t u8;
typedef uint32_t u32;
typedef int64_t i64;
typedef uint64_t u64;

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

__device__ __forceinline__ u32 load_be(const u8* p) {
  return (u32(p[0]) << 24) | (u32(p[1]) << 16) | (u32(p[2]) << 8) | u32(p[3]);
}

__device__ __forceinline__ void compress(u32 st[8], u32 w[16]) {
  u32 a = st[0], b = st[1], c = st[2], d = st[3];
  u32 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const u32 x15 = w[(t - 15) & 15], x2 = w[(t - 2) & 15];
      const u32 s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
      const u32 s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
      w[t & 15] += s0 + w[(t - 7) & 15] + s1;
    }
    const u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const u32 ch = (e & f) ^ (~e & g);
    const u32 t1 = h + S1 + ch + K256[t] + w[t & 15];
    const u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const u32 maj = (a & b) ^ (a & c) ^ (b & c);
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + S0 + maj;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__global__ void sha256_lanes_kernel(const u8* __restrict__ data,
                                    const i64* __restrict__ off,
                                    const i64* __restrict__ len,
                                    const i64* __restrict__ order,
                                    u32* __restrict__ out, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const i64 lane = order[t];
  const u8* msg = data + off[lane];
  const i64 nbytes = len[lane];
  const i64 full = nbytes >> 6;                 // blocks of message bytes only
  const i64 nblk = (nbytes + 9 + 63) >> 6;      // with padding
  u32 st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
               0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  u32 w[16];
  const bool aligned = ((reinterpret_cast<uintptr_t>(msg)) & 3) == 0;
  for (i64 blk = 0; blk < full; ++blk) {
    const u8* p = msg + (blk << 6);
    if (aligned) {
      const u32* q = reinterpret_cast<const u32*>(p);
#pragma unroll
      for (int k = 0; k < 16; ++k) w[k] = __byte_perm(q[k], 0, 0x0123);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) w[k] = load_be(p + 4 * k);
    }
    compress(st, w);
  }
  // tail: remaining message bytes, 0x80, zeros, bit length
  const u64 bits = u64(nbytes) * 8;
  for (i64 blk = full; blk < nblk; ++blk) {
    const i64 base = blk << 6;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      u32 v = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const i64 pos = base + 4 * k + q;
        u32 byte = pos < nbytes ? u32(msg[pos]) : (pos == nbytes ? 0x80u : 0u);
        v = (v << 8) | byte;
      }
      w[k] = v;
    }
    if (blk == nblk - 1) {
      w[14] = u32(bits >> 32);
      w[15] = u32(bits);
    }
    compress(st, w);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out[lane * 8 + k] = st[k];
}

}  // namespace

extern "C" int sha256_lanes_launch(const void* data, const void* off,
                                   const void* len, const void* order,
                                   void* out, long long n,
                                   void* stream) {
  if (n < 1 || n > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = int((n + threads - 1) / threads);
  sha256_lanes_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const u8*)data, (const i64*)off, (const i64*)len, (const i64*)order,
      (u32*)out, int(n));
  return (int)cudaGetLastError();
}
