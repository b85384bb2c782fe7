// Batched CRC-32 of byte strings for Hopper (sm_90a): one message a lane,
// one thread a lane.
//
// Replaces the device program zpaqfranz_tpu/ops/hash_batched.py
// crc32_lanes (a jnp lax.scan over the byte columns of an (L, N) tile, two
// 16-entry nibble-table steps a byte, every lane stepping to the longest
// lane's end). It gives the same result, the reflected IEEE CRC-32 (poly
// 0xEDB88320, initial and final XOR 0xFFFFFFFF, native.crc32's), not the
// same steps: a byte is one step of a 256-entry table here.
//
// The input is the flat layout of ops/sha1.py: the concatenated message
// bytes plus int64 offsets and lengths (ops/hash_batched.py repacks the
// padded (L, N) rows into it without a copy).
//
// What bounds it on this card: a lane is one dependent chain, a table
// lookup a byte, so for the fragment shape of chip_smoke.py (16,384 lanes
// of up to 128 KiB) the longest lane's bytes times one step, not bytes
// (each input byte is read once) or the card's instruction rate. A step's
// critical path is XOR of the byte into the CRC's low byte and the table
// address (one LOP3, one LEA), the shared-memory load, and the XOR with the
// CRC shifted down (the shift is off the path). The design:
//
// - The table (1 KiB) is built in shared memory by each block at its
//   start: a shared-memory load has a fixed short latency, where a load
//   from device memory or L2 would sit on the chain.
// - A lane's bytes are read as the aligned 16-byte pieces of device memory
//   that cover them, each piece loaded one piece ahead of
//   its use, so the load's latency hides behind the previous piece's 16
//   steps. A piece's bytes outside the message are skipped. No read leaves
//   the tensor's storage: its start is 16-byte aligned (the wrapper checks
//   it), and the one piece that runs past the tensor's last byte is read
//   byte by byte up to it.
// - 64 threads a block, so that the blocks of a few thousand lanes spread
//   over all 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint8_t u8;
typedef uint32_t u32;
typedef int64_t i64;

constexpr int THREADS = 64;
constexpr u32 POLY = 0xEDB88320u;

__device__ __forceinline__ u32 step(const u32* tab, u32 crc, u32 byte) {
  return tab[(crc ^ byte) & 255u] ^ (crc >> 8);
}

// the aligned 16-byte piece at a; bytes at or past dend read as 0
__device__ __forceinline__ uint4 piece(uintptr_t a, uintptr_t dend) {
  if (a + 16 <= dend) return __ldg(reinterpret_cast<const uint4*>(a));
  u32 w[4] = {0, 0, 0, 0};
  for (int k = 0; a + k < dend; ++k)
    w[k >> 2] |= (u32)__ldg(reinterpret_cast<const u8*>(a + k))
                 << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(THREADS)
crc32_kernel(const u8* __restrict__ data, const i64* __restrict__ off,
             const i64* __restrict__ len, u32* __restrict__ out, i64 n,
             i64 nbytes) {
  __shared__ u32 tab[256];
  for (int i = threadIdx.x; i < 256; i += THREADS) {
    u32 c = (u32)i;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (POLY & (0u - (c & 1u)));
    tab[i] = c;
  }
  __syncthreads();
  const i64 lane = (i64)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  const uintptr_t start = (uintptr_t)(data + off[lane]);
  const uintptr_t end = start + (uintptr_t)len[lane];
  const uintptr_t dend = (uintptr_t)(data + nbytes);
  u32 crc = 0xFFFFFFFFu;
  uintptr_t a = start & ~(uintptr_t)15;
  uint4 cur = make_uint4(0, 0, 0, 0);
  if (a < end) cur = piece(a, dend);
  for (; a < end; a += 16) {
    uint4 next = make_uint4(0, 0, 0, 0);
    if (a + 16 < end) next = piece(a + 16, dend);
    const u32 w[4] = {cur.x, cur.y, cur.z, cur.w};
    // the piece's bytes [lo, hi) belong to the message
    const int lo = a < start ? (int)(start - a) : 0;
    const int hi = end - a < 16 ? (int)(end - a) : 16;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k >= lo && k < hi)
        crc = step(tab, crc, (w[k >> 2] >> (8 * (k & 3))) & 255u);
    cur = next;
  }
  out[lane] = ~crc;
}

}  // namespace

// the CRC-32 of n >= 1 lanes: lane i is data[off[i] : off[i] + len[i]],
// inside the nbytes of data; returns the launch's CUDA error code
extern "C" int crc32_lanes_launch(const void* data, const void* off,
                                  const void* len, void* out, long long n,
                                  long long nbytes, void* stream) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  crc32_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const u8*)data, (const i64*)off, (const i64*)len, (u32*)out, n,
      nbytes);
  return (int)cudaGetLastError();
}
