// Batched SHA-1 of byte strings for Hopper (sm_90a): one message per thread.
//
// Replaces the TPU kernel zpaqfranz_tpu/ops/hash_pallas.py
// _build_call(nstate=5) (body _make_kernel / _sha1_block), which held the
// state of an (8, 128) lane tile in VMEM scratch and stepped one 64-byte
// block per grid step, with long messages chained through a host-side
// window ladder. Here each thread walks its own message's blocks in a loop,
// so there is no ladder and no host staging: the input is the concatenated
// message bytes plus per-lane offsets and lengths, and the thread builds the
// FIPS 180-4 padding (0x80, zeros, 64-bit big-endian bit length) of its last
// one or two blocks in registers.
//
// Bound: 597 integer instructions per 64-byte block (80 rounds of 5, 64
// schedule words of 3, 5 final adds; 3-input logic is one LOP3 and 3-input
// adds one IADD3, as chip_smoke.py counts them) against the card's INT32
// rate, and each input byte read once against 3.35 TB/s. Each thread
// reads its own message, so loads do not coalesce across a warp; lanes are
// sorted longest first (the wrapper passes the order) so a warp's threads
// run similar block counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint8_t u8;
typedef uint32_t u32;
typedef int64_t i64;
typedef uint64_t u64;

__device__ __forceinline__ u32 rotl(u32 x, int k) {
  return __funnelshift_l(x, x, k);
}

__device__ __forceinline__ u32 load_be(const u8* p) {
  return (u32(p[0]) << 24) | (u32(p[1]) << 16) | (u32(p[2]) << 8) | u32(p[3]);
}

__device__ __forceinline__ void compress(u32 st[5], u32 w[16]) {
  u32 a = st[0], b = st[1], c = st[2], d = st[3], e = st[4];
#pragma unroll
  for (int t = 0; t < 80; ++t) {
    if (t >= 16)
      w[t & 15] = rotl(w[(t - 3) & 15] ^ w[(t - 8) & 15] ^ w[(t - 14) & 15]
                       ^ w[t & 15], 1);
    u32 f, k;
    if (t < 20) { f = (b & c) | (~b & d); k = 0x5A827999u; }
    else if (t < 40) { f = b ^ c ^ d; k = 0x6ED9EBA1u; }
    else if (t < 60) { f = (b & c) | (b & d) | (c & d); k = 0x8F1BBCDCu; }
    else { f = b ^ c ^ d; k = 0xCA62C1D6u; }
    u32 tmp = rotl(a, 5) + f + e + k + w[t & 15];
    e = d; d = c; c = rotl(b, 30); b = a; a = tmp;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d; st[4] += e;
}

__global__ void sha1_lanes_kernel(const u8* __restrict__ data,
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
  u32 st[5] = {0x67452301u, 0xEFCDAB89u, 0x98BADCFEu, 0x10325476u,
               0xC3D2E1F0u};
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
  for (int k = 0; k < 5; ++k) out[lane * 5 + k] = st[k];
}

}  // namespace

extern "C" int sha1_lanes_launch(const void* data, const void* off,
                                 const void* len, const void* order,
                                 void* out, long long n,
                                 void* stream) {
  if (n < 1 || n > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = int((n + threads - 1) / threads);
  sha1_lanes_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const u8*)data, (const i64*)off, (const i64*)len, (const i64*)order,
      (u32*)out, int(n));
  return (int)cudaGetLastError();
}
