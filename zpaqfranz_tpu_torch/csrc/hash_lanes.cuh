// Batched Merkle-Damgard hashing of byte strings for Hopper (sm_90a): the
// lane machinery that csrc/sha1_lanes.cu and csrc/sha256_lanes.cu share.
// Each includes this header and supplies its hash as a type H: the state
// size H::NSTATE, the message schedule's length H::WORDS, H::init(st),
// H::schedule(w, store) (expands sixteen big-endian words into the
// schedule, handing each word to store(t, word)) and H::rounds(st, load)
// (one compression over the schedule's words load(t)).
//
// Replaces the TPU kernel zpaqfranz_tpu/ops/hash_pallas.py _build_call
// (body _make_kernel), which held an (8, 128) tile of lane states in VMEM
// scratch, stepped one 64-byte block per grid step from a (16, 8, 128)
// word tile the host had packed, and chained long messages through a
// host-side window ladder. Here one message is one lane, its blocks a
// chain walked in a loop: no ladder, no host packing. The input is the
// concatenated message bytes plus per-lane offsets and lengths, at any
// byte offset.
//
// What bounds it on this card: for a few thousand lanes, the longest
// lane's chain (its blocks times one compression's rounds), not bytes or
// the card's instruction rate; a warp alone on a scheduler issues its
// integer instructions at half rate (16 lanes a cycle), so the rounds of a
// block cost twice their instruction count in cycles. For hundreds of
// thousands of lanes, the card's integer rate. The design:
//
// - Two warps share 32 lanes (a pair). The consumer warp runs only the
//   rounds, the chain; the producer warp does everything else for the same
//   lanes one block ahead: it waits for the bytes, builds the block's
//   big-endian words, expands the message schedule and stores it in shared
//   memory at W[buffer][t][lane] (no bank conflicts), double-buffered, the
//   two warps handing buffers over with named barriers (FULL, EMPTY).
// - The producer stages bytes into shared memory by cp.async, AHEAD blocks
//   ahead, so a load's latency hides behind the rounds. A lane's bytes are
//   the 16-byte-aligned pieces of device memory that cover it; piece m of
//   lane i lives in ring slot m % SLOTS at [slot][i], the Hopper
//   counterpart of the TPU's (16, 8, 128) word tile. Thread ln copies
//   piece ln % 4 of each block for lanes ln / 4 + 8r: four neighbouring
//   threads fetch one lane's 64 bytes.
// - Every load is an aligned 16-byte copy, whatever the lane's offset; the
//   thread reads its block's 17 words from the ring at offsets fixed for
//   the lane and builds each big-endian word with one byte permute. No
//   byte loads at all: the last one or two blocks mask the bytes past the
//   message and write the FIPS 180-4 padding (0x80, zeros, 64-bit
//   big-endian bit length) into the words. A copy stops at the end of the
//   message's last piece and at the end of data (cp.async zero-fills the
//   rest), so no read leaves the aligned 16-byte pieces that hold the
//   message or the tensor.
// - A thread block is one pair (ops/sha1.py plan()): the card spreads the
//   blocks over its SMs in order, so up to one pair per SM each warp has a
//   scheduler of its own, and beyond that an SM's pairs come from far apart
//   in the launch. Lanes come sorted longest first, so the longest chains
//   start first, share their SM with shorter ones, and a pair's lanes run
//   similar block counts. (Blocks of four pairs put the four longest pairs
//   on one SM, two warps to a scheduler: 1.5x the time on the fragment
//   shape of chip_smoke.py.)
// - A profiled launch (PROF) has the longest lane (global lane 0) count
//   its clock cycles: the consumer's wait for a schedule and its rounds,
//   the producer's wait for bytes and its words, schedule and copies
//   (ops/sha1.py PROFILE).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hash_lanes {

typedef uint8_t u8;
typedef uint32_t u32;
typedef int64_t i64;
typedef uint64_t u64;

// 16-byte pieces in a lane's ring: a block needs five (its 64 bytes at any
// offset, the fifth shared with the next block); once a block's words are
// read, the ring holds the next AHEAD blocks' 4 * AHEAD + 1. Slot SLOTS
// mirrors slot 0, so a block's five pieces sit in consecutive slots.
constexpr int SLOTS = 16;
constexpr int AHEAD = 3;
static_assert(4 * AHEAD + 1 <= SLOTS, "the ring holds too few pieces");
constexpr int RING_BYTES = (SLOTS + 1) * 32 * 16;
// the named barriers: the schedule buffer b is full, is empty
constexpr int FULL = 1, EMPTY = 3;

// profile counters, in the order of ops/sha1.py PROFILE
enum { P_WAIT, P_ROUNDS, P_BYTES, P_WORDS, P_BLOCKS, P_TOTAL, P_N };

// a 16-byte copy, if `on`, from device memory to shared address `dst` that
// reads the first `bytes` (1..16) of the piece and zero-fills the rest
__device__ __forceinline__ void copy16(bool on, u32 dst, const u8* src,
                                       u32 bytes) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n"
      " @p cp.async.cg.shared.global [%1], [%2], 16, %3;\n}\n" ::"r"(int(on)),
      "r"(dst), "l"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// named barrier ID (+ 1 if b) of the block's 64 threads: wait for it, or
// arrive. The ID is an immediate, so the block holds five barriers, not
// the sixteen a register operand reserves.
template <int ID>
__device__ __forceinline__ void pair_sync(int b) {
  if (b) asm volatile("bar.sync %0, 64;\n" ::"n"(ID + 1) : "memory");
  else asm volatile("bar.sync %0, 64;\n" ::"n"(ID) : "memory");
}

template <int ID>
__device__ __forceinline__ void pair_arrive(int b) {
  if (b) asm volatile("bar.arrive %0, 64;\n" ::"n"(ID + 1) : "memory");
  else asm volatile("bar.arrive %0, 64;\n" ::"n"(ID) : "memory");
}

// one pair of warps: warp 0 the consumer, warp 1 the producer. The bound
// of 16 blocks an SM caps a thread at 64 registers: ptxas then schedules
// SHA-256's rounds 4% faster than with the 84 it picks itself (H100).
template <class H, bool PROF>
__global__ void __launch_bounds__(64, 16)
    lanes_kernel(const u8* __restrict__ data, const u8* end,
                 const i64* __restrict__ off, const i64* __restrict__ len,
                 const i64* __restrict__ order, u32* __restrict__ out, int n,
                 long long* __restrict__ prof) {
  // the ring, then two schedule buffers W[b][t][lane]
  __shared__ uint4 ring[(SLOTS + 1) * 32];
  __shared__ u32 sched_all[2 * H::WORDS * 32];
  const int ln = threadIdx.x & 31;
  const bool producer = threadIdx.x >= 32;
  u32* sched = sched_all + ln;

  const int t = blockIdx.x * 32 + ln;
  const bool live = t < n;
  const i64 lane = live ? order[t] : 0;
  const i64 nbytes = live ? len[lane] : 0;
  const u32 nblk = live ? u32((nbytes + 9 + 63) >> 6) : 0;
  const u32 wblk = __reduce_max_sync(0xffffffffu, nblk);
  long long c_wait = 0, c_work = 0, c0 = 0, c1 = 0;
  if (PROF) c0 = clock64();
  const long long t_start = c0;

  if (!producer) {
    u32 st[H::NSTATE];
    H::init(st);
    for (u32 blk = 0; blk < wblk; ++blk) {
      const int b = blk & 1;
      pair_sync<FULL>(b);
      if (PROF) { c1 = clock64(); c_wait += c1 - c0; c0 = c1; }
      const u32* w = sched + b * (H::WORDS * 32);
      if (blk < nblk) H::rounds(st, [&](int i) { return w[i * 32]; });
      if (blk + 2 < wblk) pair_arrive<EMPTY>(b);
      if (PROF) { c1 = clock64(); c_work += c1 - c0; c0 = c1; }
    }
    if (live) {
#pragma unroll
      for (int k = 0; k < H::NSTATE; ++k) out[lane * H::NSTATE + k] = st[k];
    }
    if (PROF && t == 0) {
      prof[P_WAIT] = c_wait;
      prof[P_ROUNDS] = c_work;
      prof[P_BLOCKS] = nblk;
      prof[P_TOTAL] = clock64() - t_start;
    }
    return;
  }

  const u64 start = reinterpret_cast<u64>(data) + (live ? off[lane] : 0);
  const u64 base = start & ~u64(15);
  // pieces from base that hold message bytes, and that lie wholly in data
  // (fewer than 2^31: the wrapper's MAX_DATA)
  const u32 npieces = live ? u32((start + nbytes - base + 15) >> 4) : 0;
  const u32 nfull = u32((reinterpret_cast<u64>(end) - base) >> 4);
  const u32 full = u32(nbytes >> 6);

  // the copies this thread makes: piece 4k + 1 + pc of lanes ln / 4 + 8r
  // for block group k (group -1: piece 0, by pc == 3)
  const int pc = ln & 3;
  const u8* src[4];
  u32 np[4], nf[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int from = (ln >> 2) + 8 * r;
    src[r] = reinterpret_cast<const u8*>(__shfl_sync(0xffffffffu, base, from));
    np[r] = __shfl_sync(0xffffffffu, npieces, from);
    nf[r] = __shfl_sync(0xffffffffu, nfull, from);
  }
  const u32 edge = u32(reinterpret_cast<u64>(end) & 15);
  const u32 ring_s = static_cast<u32>(__cvta_generic_to_shared(ring))
                     + (ln >> 2) * 16;
  auto stage = [&](int k) {
    const u32 m = u32(4 * k + 1 + pc);
    const u32 dst = ring_s + (m & (SLOTS - 1)) * 512;
    const bool mirror = (m & (SLOTS - 1)) == 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool on = m < np[r];
      const u8* p = src[r] + u64(m) * 16;
      const u32 bytes = m < nf[r] ? 16u : edge;
      copy16(on, dst + r * 128, p, bytes);
      copy16(on && mirror, dst + SLOTS * 512 + r * 128, p, bytes);
    }
    copy_commit();
  };
  for (int k = -1; k < AHEAD; ++k) stage(k);

  // word j of block blk sits in the ring at words + (blk % 4) * 512 +
  // at[j % 4] + (j / 4) * 128: piece (s / 4 + j) / 4 of the block's five,
  // word (s / 4 + j) % 4 of it
  const u32* words = reinterpret_cast<const u32*>(ring) + ln * 4;
  const int s = int(start & 15);
  u32 at[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    at[r] = ((s / 4 + r) / 4) * 128 + (s / 4 + r) % 4;
  // big-endian word from bytes s % 4 .. s % 4 + 3 of (lo, hi)
  const u32 sel = (s & 3) * 0x1111u + 0x0123u;
  const u64 bits = u64(nbytes) * 8;
  for (u32 blk = 0; blk < wblk; ++blk) {
    const int b = blk & 1;
    if (blk >= 2) pair_sync<EMPTY>(b);
    copy_wait<AHEAD - 1>();
    __syncwarp();
    if (PROF) { c1 = clock64(); c_wait += c1 - c0; c0 = c1; }
    if (blk < nblk) {
      const u32* wb = words + (blk & 3) * 512;
      u32 raw[17], w[16];
#pragma unroll
      for (int j = 0; j < 17; ++j) raw[j] = wb[at[j & 3] + (j >> 2) * 128];
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = __byte_perm(raw[j], raw[j + 1], sel);
      if (blk >= full) {        // the message ends here: mask and pad
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const i64 left = nbytes - ((i64(blk) << 6) + 4 * j);
          if (left < 4) {
            u32 x = left > 0 ? w[j] & ~(0xffffffffu >> (8 * left)) : 0u;
            if (left >= 0) x |= 0x80000000u >> (8 * left);
            w[j] = x;
          }
        }
        if (blk == nblk - 1) {
          w[14] = u32(bits >> 32);
          w[15] = u32(bits);
        }
      }
      u32* out_w = sched + b * (H::WORDS * 32);
      H::schedule(w, [&](int i, u32 v) { out_w[i * 32] = v; });
    }
    __syncwarp();                 // the ring slots of block blk - 1 are free
    stage(int(blk) + AHEAD);
    pair_arrive<FULL>(b);
    if (PROF) { c1 = clock64(); c_work += c1 - c0; c0 = c1; }
  }
  if (PROF && t == 0) {
    prof[P_BYTES] = c_wait;
    prof[P_WORDS] = c_work;
  }
}

// one launch over n lanes in `blocks` thread blocks of one pair (the plan
// of ops/sha1.py); prof null or P_N int64 counters
template <class H>
int launch(const void* data, const void* off, const void* len,
           const void* order, void* out, void* prof, long long n,
           long long nbytes, long long blocks, void* stream) {
  if (n < 1 || n > 0x7fffffff || nbytes < 0 || blocks < 1
      || blocks > 0x7fffffff || blocks * 32 < n)
    return (int)cudaErrorInvalidValue;
  const u8* d = static_cast<const u8*>(data);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (prof)
    lanes_kernel<H, true><<<int(blocks), 64, 0, s>>>(
        d, d + nbytes, (const i64*)off, (const i64*)len, (const i64*)order,
        (u32*)out, int(n), (long long*)prof);
  else
    lanes_kernel<H, false><<<int(blocks), 64, 0, s>>>(
        d, d + nbytes, (const i64*)off, (const i64*)len, (const i64*)order,
        (u32*)out, int(n), nullptr);
  return (int)cudaGetLastError();
}

}  // namespace hash_lanes
