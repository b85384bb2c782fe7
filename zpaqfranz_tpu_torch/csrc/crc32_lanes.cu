// Batched CRC-32 of byte strings for Hopper (sm_90a): every lane cut into
// segments of at most S bytes, one warp a segment, then a group of threads
// a lane that combines the segments' CRCs in GF(2).
//
// Replaces the device program zpaqfranz_tpu/ops/hash_batched.py
// crc32_lanes (a jnp lax.scan over the byte columns of an (L, N) tile, two
// 16-entry nibble-table steps a byte, every lane stepping to the longest
// lane's end). It gives the same result, the reflected IEEE CRC-32 (poly
// 0xEDB88320, initial and final XOR 0xFFFFFFFF, native.crc32's), not the
// same steps.
//
// The input is the flat layout of ops/sha1.py: the concatenated message
// bytes plus int64 offsets and lengths (ops/hash_batched.py repacks the
// padded (L, N) rows into it without a copy), and the segment plan that
// ops/hash_batched.py builds on the card with torch ops: each lane's first
// segment (an exclusive cumsum of the lanes' segment counts) and each
// segment's lane.
//
// What bounds it on this card: bytes. Each input byte is read once from
// device memory, and the work on it is an extract, a table lookup and an
// XOR. The design before this one ran a lane on one thread: a warp waited
// on its longest lane, one 1 MiB lane took 1/1000 of the card, and each
// byte step sat under a per-byte branch. What this design does about it:
//
// - Segments. A lane is cut at the device addresses that are multiples of
//   S (a power of two, at least 64, chosen by the wrapper), so that every
//   segment but a lane's first starts on a 16-byte address and its body is
//   aligned 16-byte pieces. A warp takes one segment at a time: the blocks
//   stay resident (one an SM, SEG_THREADS threads) and their warps walk
//   the segments, so any mix of lane lengths becomes near-equal work on
//   every SM, and the longest chain is one segment long. A segment's bytes
//   before its first aligned piece (only in a lane's first segment) and
//   after its last (only in a lane's last) are stepped byte by byte outside
//   the hot loop. No read leaves the lane's bytes, so none leaves the
//   tensor.
// - Rows read together. The warp takes a row of ROW pieces at once, thread
//   t the RUN pieces at RUN t, so one load instruction of the warp reads
//   32 pieces RUN pieces apart, not 32 pieces a segment apart as one
//   thread a segment would (a different 128-byte line for each thread).
//   Thread t folds its run from 0 and carries c <- shift(c, row) ^ run
//   from row to row, as if the other threads' bytes were zeros; then five
//   shuffles gather the 32 registers into thread 31, each shifted past the
//   runs after it. shift(c, n), the register after n zero bytes (c *
//   x^(8n) mod P), is a 4 x 256 table in shared memory for each n used
//   (it is linear, one table a byte of c). A segment's first row is padded
//   with zero pieces in front, which leave a register of 0 at 0.
// - Slicing by 4 without bank conflicts. A word is the register XORed into
//   it, four independent lookups (table k: a byte followed by k zero bytes)
//   and their XOR: no per-byte condition. Random indices into one table
//   would conflict on shared memory's 32 banks, and the conflicts, not the
//   bytes, bounded slicing by 16 through plain tables (chip_smoke.py times
//   the fragment shape on zero bytes, where every lookup is one word,
//   beside random bytes). Each entry of the four tables is held once per
//   bank (128 KiB), and a thread reads only its own bank's copies.
// - The combine. A segment yields its raw CRC: register 0 at its start,
//   no final XOR, except a lane's first segment, which starts at
//   0xFFFFFFFF (the CRC's initial value; the same as shifting 0xFFFFFFFF
//   over its bytes and XORing its raw CRC). Then, over the lane's segments
//   in order, crc <- shift(crc, len_k) ^ raw_k (zlib's crc32_combine), and
//   last the final NOT. Every segment between a lane's first and last is S
//   bytes: shift(., S) is a table. The last segment's shift goes by
//   square-and-multiply over x^(2^k) mod P. A group of G threads (a power
//   of two up to a warp, chosen by the wrapper from the longest lane's
//   segments) takes a lane: each folds a run of its segments, shifts its
//   run past the segments after it, and the group XORs them with shuffles.
//   An empty lane gives 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint8_t u8;
typedef uint32_t u32;
typedef int32_t i32;
typedef int64_t i64;
typedef unsigned long long u64;

constexpr int THREADS = 256;       // a block of the combine: 8 warps
constexpr int SEG_THREADS = 1024;  // a block of the segments: one an SM
constexpr int LG_RUN = 1;
constexpr int RUN = 1 << LG_RUN;  // side-by-side 16-byte pieces a thread
constexpr int ROW = 32 * RUN;     // pieces a warp takes at once
// The segments' shared memory, in words: the four slicing tables with
// each entry once for each of the 32 banks (entry i of table k for lane l
// at (256 k + i) 32 + l), the plain tables 0-3, six shift tables, their
// basis
constexpr int REP_WORDS = 4 * 256 * 32;
constexpr int SEG_SMEM = (REP_WORDS + 4 * 256 + 6 * 4 * 256 + 6 * 32) * 4;
constexpr u32 POLY = 0xEDB88320u;
constexpr u32 ONE = 0x80000000u;  // the polynomial 1, reflected

// x^(2^k) mod P, reflected, k = 0..31 (zlib's x2n_table); x^(2^32) = x, so
// k counts modulo 32
__constant__ u32 X2N[32] = {
    0x40000000u, 0x20000000u, 0x08000000u, 0x00800000u, 0x00008000u,
    0xEDB88320u, 0xB1E6B092u, 0xA06A2517u, 0xED627DAEu, 0x88D14467u,
    0xD7BBFE6Au, 0xEC447F11u, 0x8E7EA170u, 0x6427800Eu, 0x4D47BAE0u,
    0x09FE548Fu, 0x83852D0Fu, 0x30362F1Au, 0x7B5A9CC3u, 0x31FEC169u,
    0x9FEC022Au, 0x6C8DEDC4u, 0x15D6874Du, 0x5FDE7A4Eu, 0xBAD90E37u,
    0x2E4E5EEFu, 0x4EABA214u, 0xA8A472C0u, 0x429A969Eu, 0x148D302Au,
    0xC40BA6D0u, 0xC4E22C3Cu};

__device__ __forceinline__ u32 byte_step(const u32* tab, u32 crc, u32 b) {
  return tab[(crc ^ b) & 255u] ^ (crc >> 8);
}

__device__ __forceinline__ u32 load_byte(u64 a) {
  return __ldg(reinterpret_cast<const u8*>(a));
}

// The register after the 4 bytes of a (the register XORed into the next
// word), slicing by 4: byte j meets table 3 - j, each lookup in this
// thread's bank (rep: the replicated tables; l4: the lane times 4), so the
// warp's 32 lookups of one instruction never conflict.
__device__ __forceinline__ u32 lds(const u32* rep, u32 byte_off) {
  return *reinterpret_cast<const u32*>(
      reinterpret_cast<const char*>(rep) + byte_off);
}
__device__ __forceinline__ u32 word_step(const u32* rep, u32 l4, u32 a) {
  constexpr u32 TB = 256 * 32 * 4;  // bytes of one replicated table
  return lds(rep, 3 * TB + (((a << 7) & 0x7F80u) | l4)) ^
         lds(rep, 2 * TB + (((a >> 1) & 0x7F80u) | l4)) ^
         lds(rep, TB + (((a >> 9) & 0x7F80u) | l4)) ^
         lds(rep, ((a >> 17) & 0x7F80u) | l4);
}

// a * b mod P, reflected (zlib's multmodp), without branches
__device__ __forceinline__ u32 multmodp(u32 a, u32 b) {
  u32 p = 0;
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    p ^= b & (0u - ((a >> i) & 1u));
    b = (b >> 1) ^ (POLY & (0u - (b & 1u)));
  }
  return p;
}

// x^(8n) mod P: the multiplier of shift(., n)
__device__ u32 x8n(const u32* x2n, u64 n) {
  u32 p = ONE;
  for (int k = 3; n; n >>= 1, ++k)
    if (n & 1) p = multmodp(x2n[k & 31], p);
  return p;
}

// a lane's segments: its bytes [start, end) cut at the multiples of 2^s
__device__ __forceinline__ i64 segments(u64 start, u64 end, int s) {
  return end > start ? (i64)(((end - 1) >> s) - (start >> s)) + 1 : 0;
}

// shift(c, n) through the 4 x 256 table of one n (byte j of c at [j])
__device__ __forceinline__ u32 shift_by(const u32 (*t)[256], u32 c) {
  return t[0][c & 255u] ^ t[1][(c >> 8) & 255u] ^ t[2][(c >> 16) & 255u] ^
         t[3][c >> 24];
}

// One warp a segment: its raw CRC into raw[g]. A row is the next ROW
// pieces, thread t taking RUN of them side by side, so that each load of
// the warp reads 32 x 16 bytes RUN pieces apart; the rows are aligned to
// the body's end (the first row padded with zero pieces in front, which add
// nothing to a register that starts at 0). prof (or null): segment 0's
// clock cycles over its rows, and its pieces.
__global__ void __launch_bounds__(SEG_THREADS)
crc32_segments(const u8* __restrict__ data, const i64* __restrict__ off,
               const i64* __restrict__ len, const i64* __restrict__ first,
               const i32* __restrict__ seg_lane, u32* __restrict__ raw,
               i64 total, int s, i64* __restrict__ prof) {
  extern __shared__ u32 smem[];
  u32* rep = smem;
  u32(*tab)[256] = reinterpret_cast<u32(*)[256]>(smem + REP_WORDS);
  // shift(., 16 RUN 2^b bytes) at [b]: the butterfly's five levels and,
  // at b = 5, a row
  u32(*sh)[4][256] = reinterpret_cast<u32(*)[4][256]>(smem + REP_WORDS +
                                                       4 * 256);
  u32(*basis)[32] = reinterpret_cast<u32(*)[32]>(smem + REP_WORDS +
                                                 4 * 256 + 6 * 4 * 256);
  for (int i = threadIdx.x; i < 256; i += SEG_THREADS) {
    u32 c = i;
#pragma unroll
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (POLY & (0u - (c & 1u)));
    tab[0][i] = c;
  }
  // shift(bit i, n): 8n = 2^(7 + LG_RUN + b)
  for (int i = threadIdx.x; i < 6 * 32; i += SEG_THREADS)
    basis[i >> 5][i & 31] =
        multmodp(X2N[(7 + LG_RUN + (i >> 5)) & 31], 1u << (i & 31));
  __syncthreads();
  for (int i = threadIdx.x; i < 256; i += SEG_THREADS) {
    u32 c = tab[0][i];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      c = (c >> 8) ^ tab[0][c & 255u];
      tab[k][i] = c;
    }
  }
  for (int i = threadIdx.x; i < 6 * 1024; i += SEG_THREADS) {
    const int b = i >> 10, j = (i >> 8) & 3, x = i & 255;
    u32 v = 0;
#pragma unroll
    for (int bit = 0; bit < 8; ++bit)
      v ^= basis[b][8 * j + bit] & (0u - ((u32)(x >> bit) & 1u));
    sh[b][j][x] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < REP_WORDS; i += SEG_THREADS)
    rep[i] = tab[i >> 13][(i >> 5) & 255];
  __syncthreads();

  const int li = threadIdx.x & 31;
  const u32 l4 = (u32)li << 2;
  const i64 warps = (i64)gridDim.x * (SEG_THREADS / 32);
  for (i64 g = (i64)blockIdx.x * (SEG_THREADS / 32) + (threadIdx.x >> 5);
       g < total; g += warps) {
    const i32 lane = seg_lane[g];
    const i64 k = g - first[lane];
    const u64 start = (u64)(uintptr_t)data + (u64)off[lane];
    const u64 end = start + (u64)len[lane];
    const u64 blk = (start >> s) + (u64)k;
    const u64 lo = max(start, blk << s);
    const u64 hi = min(end, (blk + 1) << s);
    // [lo, head) bytes, [head, body) aligned pieces, [body, hi) bytes
    const u64 head = min(hi, (lo + 15) & ~15ull);
    const u64 body = max(head, hi & ~15ull);
    u32 h = k == 0 ? 0xFFFFFFFFu : 0u;
    for (u64 a = lo; a < head; ++a) h = byte_step(tab[0], h, load_byte(a));

    const uint4* q = reinterpret_cast<const uint4*>(head);
    const int pieces = (int)((body - head) >> 4);
    const int rows = (pieces + ROW - 1) / ROW;
    const int pad = rows * ROW - pieces;
    const bool timed = prof != nullptr && g == 0 && li == 0;
    const long long t0 = timed ? clock64() : 0;
    // c: the register after this thread's runs, the others' bytes as zeros
    u32 c = 0;
    for (int j = 0; j < rows; ++j) {
      const int r = RUN * li + ROW * j - pad;  // its run's first piece
      uint4 v[RUN];
#pragma unroll
      for (int u = 0; u < RUN; ++u) {
        v[u] = r + u >= 0 ? __ldg(q + r + u) : make_uint4(0, 0, 0, 0);
        if (r + u == 0) v[u].x ^= h;  // the head's register, into piece 0
      }
      u32 x = 0;
#pragma unroll
      for (int u = 0; u < RUN; ++u) {
        x = word_step(rep, l4, x ^ v[u].x);
        x = word_step(rep, l4, x ^ v[u].y);
        x = word_step(rep, l4, x ^ v[u].z);
        x = word_step(rep, l4, x ^ v[u].w);
      }
      c = shift_by(sh[5], c) ^ x;
    }
    if (timed) {
      prof[0] = clock64() - t0;
      prof[1] = pieces;
    }
    // thread 31 gathers the runs, each shifted past the runs after it
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const u32 o = shift_by(sh[b], __shfl_up_sync(0xFFFFFFFFu, c, 1 << b));
      if ((li & ((2 << b) - 1)) == (2 << b) - 1) c ^= o;
    }
    c = pieces > 0 ? __shfl_sync(0xFFFFFFFFu, c, 31) : h;
    for (u64 a = body; a < hi; ++a) c = byte_step(tab[0], c, load_byte(a));
    if (li == 0) raw[g] = c;
  }
}

// A group of G threads a lane: the lane's CRC from its segments' raw CRCs.
// prof (or null): lane 0's clock cycles in its first thread, and its
// segments.
__global__ void __launch_bounds__(THREADS)
crc32_combine(const u8* __restrict__ data, const i64* __restrict__ off,
              const i64* __restrict__ len, const i64* __restrict__ first,
              const u32* __restrict__ raw, u32* __restrict__ out, i64 n,
              int s, int G, i64* __restrict__ prof) {
  __shared__ u32 x2n[32];
  __shared__ u32 basis[32];
  __shared__ u32 shift_s[4][256];  // shift(b << 8j, S) at [j][b]
  const int tid = threadIdx.x;
  if (tid < 32) {
    x2n[tid] = X2N[tid];
    // shift(bit tid, S): 8S = 2^(s + 3)
    basis[tid] = multmodp(X2N[(s + 3) & 31], 1u << tid);
  }
  __syncthreads();
  for (int i = tid; i < 1024; i += THREADS) {
    const int j = i >> 8, b = i & 255;
    u32 v = 0;
#pragma unroll
    for (int bit = 0; bit < 8; ++bit)
      v ^= basis[8 * j + bit] & (0u - ((u32)(b >> bit) & 1u));
    shift_s[j][b] = v;
  }
  __syncthreads();

  const i64 gid = (i64)blockIdx.x * THREADS + tid;
  const i64 lane = gid / G;
  const int t = (int)(gid % G);
  const bool live = lane < n;
  const bool timed = prof != nullptr && gid == 0;
  const long long t0 = timed ? clock64() : 0;
  u64 start = 0, end = 0;
  i64 m = 0, f = 0;
  if (live) {
    start = (u64)(uintptr_t)data + (u64)off[lane];
    end = start + (u64)len[lane];
    m = segments(start, end, s);
    f = first[lane];
  }
  // Q = the register after the lane's segments but the last: thread t
  // folds its run [a, b) of them, then shifts it past segments [b, m - 1)
  u32 q = 0;
  if (m >= 2) {
    const i64 K = m - 1, r = (K + G - 1) / G;
    const i64 a = min(K, t * r), b = min(K, a + r);
    for (i64 k = a; k < b; ++k)
      q = shift_s[0][q & 255u] ^ shift_s[1][(q >> 8) & 255u] ^
          shift_s[2][(q >> 16) & 255u] ^ shift_s[3][q >> 24] ^ raw[f + k];
    if (a < b && b < K) q = multmodp(x8n(x2n, (u64)(K - b) << s), q);
  }
  // every thread of the warp reaches the shuffles
  for (int o = G >> 1; o; o >>= 1) q ^= __shfl_xor_sync(0xFFFFFFFFu, q, o);
  if (!live || t != 0) return;
  u32 crc = 0;
  if (m == 1) {
    crc = ~raw[f];
  } else if (m >= 2) {
    const u64 last = end - max(start, ((end - 1) >> s) << s);
    crc = ~(multmodp(x8n(x2n, last), q) ^ raw[f + m - 1]);
  }
  out[lane] = crc;
  if (timed) {
    prof[2] = clock64() - t0;
    prof[3] = m;
  }
}

}  // namespace

// The CRC-32 of n >= 1 lanes: lane i is data[off[i] : off[i] + len[i]].
// first[i] is lane i's first segment, seg_lane[g] segment g's lane, of
// total segments cut at the multiples of 2^s (s >= 6) of the device
// address; raw holds total words of scratch; G threads combine a lane.
// prof: null, or 4 int64 (segment 0's cycles and pieces, lane 0's
// combine cycles and segments). Returns the launches' CUDA error code.
extern "C" int crc32_lanes_launch(const void* data, const void* off,
                                  const void* len, const void* first,
                                  const void* seg_lane, void* raw, void* out,
                                  long long n, long long total, long long s,
                                  long long G, void* prof, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (total > 0) {
    // as many blocks as the card holds at once, or fewer: each warp walks
    // the segments (the tables are built once a block). The attribute
    // and the occupancy belong to the current device.
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(crc32_segments,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SEG_SMEM);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, crc32_segments,
                                                  SEG_THREADS, SEG_SMEM);
    const long long resident = (long long)sms * per;
    const long long warps = SEG_THREADS / 32;
    const long long need = (total + warps - 1) / warps;
    const long long blocks = need < resident ? need : resident;
    crc32_segments<<<(unsigned)blocks, SEG_THREADS, SEG_SMEM, st>>>(
        (const u8*)data, (const i64*)off, (const i64*)len, (const i64*)first,
        (const i32*)seg_lane, (u32*)raw, total, (int)s, (i64*)prof);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  crc32_combine<<<(unsigned)((n * G + THREADS - 1) / THREADS), THREADS, 0,
                  st>>>((const u8*)data, (const i64*)off, (const i64*)len,
                        (const i64*)first, (const u32*)raw, (u32*)out, n,
                        (int)s, (int)G, (i64*)prof);
  return (int)cudaGetLastError();
}
