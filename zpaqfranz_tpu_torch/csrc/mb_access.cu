// Per-lane table-access microbenchmarks for Hopper (sm_90a): kernels A to E.
//
// Replace the TPU kernels of experiments/mb_access.py: mk_gather_kernel (A),
// mk_onehot_kernel (B), mk_selwrite_kernel (C), mk_lane_loop_kernel (D) and
// mk_dma_kernel (E). Each computes what its TPU kernel computes, output for
// output, and keeps the access mechanism its row measures; the wrappers, the
// plain PyTorch versions and the launch plans are in
// experiments/mb_access.py.
//
// Bound: every kernel is a chain of dependent accesses, so none of them is
// bound by bytes or operations at these shapes; what bounds each is its
// chain floor (PERF.md): its dependent accesses at the latency of the level
// they touch, plus the integer instructions between them. The design keeps
// the chain to what the work needs:
//  - A, B, C stage each block's lanes of the (S, L) table in shared memory
//    by row and column cursors that advance by increments (no divide per
//    element), 16-byte loads where the row segment allows them, eight
//    loads a thread in flight;
//  - every floor modulo goes through floor_mod.cuh (a mask, or a
//    multiply-high by the wrapper's reciprocal): no divide in the chain;
//  - A: one thread a lane, its column laid out [row * T + t], so a step is
//    the index add, the modulo, the address, one shared load and the sum;
//  - B: one warp a lane, the lane's column contiguous, each thread
//    comparing and selecting its share of the rows (four u8 rows to a word,
//    one compare a word) and __reduce_add_sync summing the warp's selects:
//    the TPU's compare against every row, 32 threads wide;
//  - C: one warp a lane, each thread rewriting its share of the column's
//    words every pass by a select (the TPU's select-pass write); no word
//    has two writers, so one __syncwarp before column[0] is read.
// B and C touch the column through volatile loads and stores, so that the
// compiler can neither skip the rows a compare rejects nor the stores a
// select leaves unchanged; a thread loads eight of its words before it
// selects or stores any, in loops of the same length for the whole warp.
//  - D: per lane, rounds of a W-byte row read at a data-dependent offset of
//    an (L, S) u8 table in device memory (16 MiB at S = 131072:
//    L2-resident), written back + 1 and read again: weak L2 accesses (not
//    the strong system-scope ones volatile gives), the lanes spread over
//    the SMs so that no SM queues 32 rows' lines behind each other, and a
//    16-byte row's round free of loop control.
//  - E: per lane, rounds of a W-byte row copied from an (L, S) table in
//    device memory (128 MiB at the script's S = 1 MiB) into shared memory
//    by one bulk copy of the tensor memory accelerator, waited on through
//    the lane's mbarrier, and read; the lanes spread as D's.
// int32 arithmetic wraps as JAX's does (computed in uint32), and % is a
// floor modulo as jnp's is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "floor_mod.cuh"

namespace {

typedef uint8_t u8;
typedef int32_t i32;
typedef uint32_t u32;
typedef long long i64;

constexpr int SMEM_MAX = 227 * 1024;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return int(u32(a) + u32(b));
}

// Units a thread loads before it stores any: a thread's loads of one batch
// are in flight together.
constexpr int STAGE_BATCH = 8;
// Words of a lane's column (B, C) a thread loads before it selects any.
constexpr int WORD_BATCH = 8;

// Copies every unit of rows [0, S) of a row segment of `upr` units, thread
// by thread: v = load(row, unit), then store(row, unit, v), STAGE_BATCH
// units a thread at a time. Each of a thread's cursors advances by
// increments; the divides are the cursors' starts.
template <typename U, typename Load, typename Store>
__device__ __forceinline__ void for_units(int S, int upr, Load load,
                                          Store store) {
  const int nt = blockDim.x;
  int r[STAGE_BATCH], c[STAGE_BATCH];
#pragma unroll
  for (int b = 0; b < STAGE_BATCH; ++b) {
    const int q = threadIdx.x + b * nt;
    r[b] = q / upr;
    c[b] = q - r[b] * upr;
  }
  const int step = STAGE_BATCH * nt, dr = step / upr, dc = step - dr * upr;
  while (r[0] < S) {  // cursor 0 is the furthest behind
    U v[STAGE_BATCH];
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b)
      if (r[b] < S) v[b] = load(r[b], c[b]);
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b)
      if (r[b] < S) store(r[b], c[b], v[b]);
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b) {
      r[b] += dr;
      c[b] += dc;
      if (c[b] >= upr) {
        c[b] -= upr;
        ++r[b];
      }
    }
  }
}

// Copies lanes [lane0, lane0 + w) of every row of the (S, L) table into
// shared memory, U (16 bytes or one element) at a time: row-major
// ([row * T + t], A) or lane-major ([t * pitch + row], B and C; pitch in
// elements).
template <typename U, typename E, bool LANE_MAJOR>
__device__ __forceinline__ void stage_units(const E* tab, E* col, int S,
                                            int L, int lane0, int w, int T,
                                            int pitch) {
  constexpr int PER = int(sizeof(U) / sizeof(E));
  for_units<U>(
      S, w / PER,
      [&](int r, int c) {
        return __ldg(reinterpret_cast<const U*>(tab + i64(r) * L + lane0) +
                     c);
      },
      [&](int r, int c, const U& v) {
        if (LANE_MAJOR) {
          const E* e = reinterpret_cast<const E*>(&v);
#pragma unroll
          for (int j = 0; j < PER; ++j) col[(c * PER + j) * pitch + r] = e[j];
        } else {
          reinterpret_cast<U*>(col + r * T)[c] = v;
        }
      });
}

// 16-byte units where every row segment of this block allows them, else one
// element at a time.
template <typename E, bool LANE_MAJOR>
__device__ __forceinline__ void stage(const E* tab, E* col, int S, int L,
                                      int lane0, int w, int T, int pitch) {
  const i64 at = i64(reinterpret_cast<uintptr_t>(tab + lane0));
  const int rowb = L * int(sizeof(E)), segb = w * int(sizeof(E));
  const int colb = T * int(sizeof(E));  // A's rows of shared memory
  if (at % 16 == 0 && rowb % 16 == 0 && segb % 16 == 0 &&
      (LANE_MAJOR || colb % 16 == 0))
    stage_units<uint4, E, LANE_MAJOR>(tab, col, S, L, lane0, w, T, pitch);
  else
    stage_units<E, E, LANE_MAJOR>(tab, col, S, L, lane0, w, T, pitch);
  __syncthreads();
}

// A: acc += tab[(idx0 + acc) % S, lane], ITERS times; T lanes a block, one
// thread each (the block's other threads only stage).
template <typename E, bool POW2>
__global__ void gather_kernel(const E* tab, const i32* idx, i32* out, int S,
                              int L, int T, int pitch, int iters,
                              FloorMod d) {
  extern __shared__ __align__(16) unsigned char smem[];
  E* col = reinterpret_cast<E*>(smem);
  const int lane0 = blockIdx.x * T, w = min(T, L - lane0);
  stage<E, false>(tab, col, S, L, lane0, w, T, pitch);
  const int t = threadIdx.x;
  if (t >= w) return;
  const E* c = col + t;
  const int i0 = idx[lane0 + t];
  int acc = 0;
  for (int i = 0; i < iters; ++i)
    acc = wrap_add(acc, int(c[floor_mod<POW2>(wrap_add(i0, acc), d) * T]));
  out[lane0 + t] = acc;
}

// The row `r` of a lane-major column as B and C see it: word r / 4 and its
// byte r % 4 for u8, word r for int32.
template <typename E>
__device__ __forceinline__ int word_of(int r) {
  return sizeof(E) == 1 ? r >> 2 : r;
}

template <typename E>
__device__ __forceinline__ int shift_of(int r) {
  return sizeof(E) == 1 ? (r & 3) * 8 : 0;
}

// B: the same result as A; each row found by a compare against every row,
// a warp per lane (T lanes a block).
template <typename E, bool POW2>
__global__ void onehot_kernel(const E* tab, const i32* idx, i32* out, int S,
                              int L, int T, int pitch, int iters,
                              FloorMod d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane0 = blockIdx.x * T, w = min(T, L - lane0);
  stage<E, true>(tab, reinterpret_cast<E*>(smem), S, L, lane0, w, T,
                 pitch / int(sizeof(E)));
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  if (warp >= w) return;
  const volatile u32* cw = reinterpret_cast<const u32*>(smem + warp * pitch);
  const int words = (S * int(sizeof(E)) + 3) >> 2;
  const int i0 = idx[lane0 + warp];
  int acc = 0;
  for (int i = 0; i < iters; ++i) {
    const int r = floor_mod<POW2>(wrap_add(i0, acc), d);
    const int rw = word_of<E>(r);
    u32 sel = 0;
    for (int k0 = 0; k0 < words; k0 += 32 * WORD_BATCH) {  // warp-uniform
      u32 word[WORD_BATCH];
#pragma unroll
      for (int u = 0; u < WORD_BATCH; ++u) {
        const int k = k0 + 32 * u + j;
        word[u] = k < words ? cw[k] : 0u;
      }
#pragma unroll
      for (int u = 0; u < WORD_BATCH; ++u)
        sel += k0 + 32 * u + j == rw ? word[u] : 0u;
    }
    u32 row = __reduce_add_sync(0xffffffffu, sel) >> shift_of<E>(r);
    if (sizeof(E) == 1) row &= 0xFFu;
    acc = wrap_add(acc, int(row));
  }
  if (j == 0) out[lane0 + warp] = acc;
}

// C: ITERS passes, each writing carry & 0xFF into row (idx0 + i) % S of the
// lane's column by a select over every row; out = ITERS + column[0]. A warp
// per lane (T lanes a block). The caller's table is untouched: the column
// lives in shared memory.
template <typename E, bool POW2>
__global__ void selwrite_kernel(const E* tab, const i32* idx, i32* out,
                                int S, int L, int T, int pitch, int iters,
                                FloorMod d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane0 = blockIdx.x * T, w = min(T, L - lane0);
  stage<E, true>(tab, reinterpret_cast<E*>(smem), S, L, lane0, w, T,
                 pitch / int(sizeof(E)));
  const int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  if (warp >= w) return;
  volatile u32* cw = reinterpret_cast<u32*>(smem + warp * pitch);
  const int words = (S * int(sizeof(E)) + 3) >> 2;
  const int i0 = idx[lane0 + warp];
  int carry = 0;
  for (int i = 0; i < iters; ++i) {
    const int r = floor_mod<POW2>(wrap_add(i0, i), d);
    const int rw = word_of<E>(r), sh = shift_of<E>(r);
    const u32 keep = sizeof(E) == 1 ? ~(0xFFu << sh) : 0u;
    const u32 v = u32(carry & 0xFF) << sh;
    for (int k0 = 0; k0 < words; k0 += 32 * WORD_BATCH) {  // warp-uniform
      u32 word[WORD_BATCH];
#pragma unroll
      for (int u = 0; u < WORD_BATCH; ++u) {
        const int k = k0 + 32 * u + j;
        word[u] = k < words ? cw[k] : 0u;
      }
#pragma unroll
      for (int u = 0; u < WORD_BATCH; ++u) {
        const int k = k0 + 32 * u + j;
        if (k < words) cw[k] = k == rw ? (word[u] & keep) | v : word[u];
      }
    }
    carry = wrap_add(carry, 1);
  }
  __syncwarp();
  if (j == 0) {
    const u32 first = cw[0];
    out[lane0 + warp] =
        wrap_add(carry, int(sizeof(E) == 1 ? first & 0xFFu : first));
  }
}

// Adds each thread's v into *out: a warp sum, then one atomic per warp.
// Every thread of the block must call it.
__device__ __forceinline__ void add_out(i32* out, u32 v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(reinterpret_cast<u32*>(out), v);
}

// Loads and stores of the rows of D, in L2 (.cg: never cached in L1), each
// an asm statement the compiler may neither drop nor merge nor move across
// another: every round goes to memory. They are weak, not volatile (which
// compiles to strong system-scope accesses): a thread still reads its own
// last write of an address.
__device__ __forceinline__ uint4 ld16(const u8* p) {
  uint4 v;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st16(u8* p, uint4 v) {
  asm volatile("st.global.cg.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// 16 bytes, each + 1 (mod 256).
__device__ __forceinline__ uint4 add1(uint4 v) {
  return make_uint4(__vadd4(v.x, 0x01010101u), __vadd4(v.y, 0x01010101u),
                    __vadd4(v.z, 0x01010101u), __vadd4(v.w, 0x01010101u));
}

__device__ __forceinline__ u32 ld1(const u8* p) {
  u32 v;
  asm volatile("ld.global.cg.u8 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st1(u8* p, u32 v) {
  asm volatile("st.global.cg.u8 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// D: ROUNDS times per lane, read the W-byte row at tab[lane, idx[lane]],
// write it back + 1, and add its first byte to *out. Round 0 reads the
// caller's table `src` and every round writes `work` (same shape), so the
// caller's table is untouched without a copy of it: each lane only ever
// touches its own row. vec: W % 16 == 0 and every row 16-byte aligned, so a
// row moves as 16-byte words with a per-byte add (__vadd4); otherwise byte
// by byte. The lanes spread over the SMs, `lanes` a block (the wrapper's
// plan): a warp's loads to 32 rows in 32 lines would queue behind each
// other in one SM's L1, which the chain would then wait for.
__global__ void lane_loop_kernel(const i32* idx, const u8* src, u8* work,
                                 i32* out, i64 S, int W, int L, int rounds,
                                 int vec, int lanes) {
  const int t = threadIdx.x, lane = blockIdx.x * lanes + t;
  u32 acc = 0;
  if (t < lanes && lane < L) {
    const i64 at = i64(lane) * S + idx[lane];
    const u8* rd = src + at;
    u8* wr = work + at;
    for (int it = 0; it < rounds; ++it) {
      if (vec) {
        // the first 16 bytes outside the loop over the rest of the row: a
        // round of a 16-byte row then holds no loop control, which cost
        // about a third of an L2 trip a round (PERF.md)
        const uint4 v = ld16(rd);
        acc += v.x & 0xFFu;
        st16(wr, add1(v));
        for (int k = 16; k < W; k += 16) st16(wr + k, add1(ld16(rd + k)));
      } else {
        for (int k = 0; k < W; ++k) {
          const u32 b = ld1(rd + k);
          if (k == 0) acc += b;
          st1(wr + k, b + 1u);
        }
      }
      rd = wr;
    }
  }
  add_out(out, acc);
}

__device__ __forceinline__ u32 smem_addr(const void* p) {
  return u32(__cvta_generic_to_shared(p));
}

// E: ROUNDS times per lane, copy the W-byte row at hbm[lane, idx[lane]] into
// the lane's W bytes of shared memory by one bulk copy of the tensor memory
// accelerator (cp.async.bulk), which reports its bytes to the lane's
// mbarrier; wait on it, and add the copy's first byte to *out. Shared
// memory holds the block's mbarriers (8 bytes a lane, padded to 16), then
// its rows. The lanes spread over the SMs as D's; the launcher checks that
// W % 16 == 0 and every row is 16-byte aligned.
__global__ void dma_kernel(const i32* idx, const u8* hbm, i32* out, i64 S,
                           int W, int L, int rounds, int lanes) {
  extern __shared__ __align__(16) unsigned char scratch[];
  const int t = threadIdx.x, lane = blockIdx.x * lanes + t;
  u32 acc = 0;
  if (t < lanes && lane < L) {
    const u8* src = hbm + i64(lane) * S + idx[lane];
    const u32 bar = smem_addr(scratch + 8 * t);
    volatile u8* dst = scratch + ((8 * lanes + 15) & ~15) + t * W;
    const u32 sdst = smem_addr(const_cast<u8*>(dst));
    asm volatile(
        "mbarrier.init.shared::cta.b64 [%0], 1;\n"
        "fence.mbarrier_init.release.cluster;\n" ::"r"(bar)
        : "memory");
    u32 phase = 0;
    for (int it = 0; it < rounds; ++it) {
      // the last round's read of the row comes before the copy rewrites it
      asm volatile(
          "fence.proxy.async.shared::cta;\n"
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%2], [%3], %1, [%0];\n" ::"r"(bar),
          "r"(W), "r"(sdst), "l"(src)
          : "memory");
      u32 done = 0;
      while (!done)
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(phase)
            : "memory");
      phase ^= 1u;
      acc += dst[0];
    }
  }
  add_out(out, acc);
}

// The instantiation of KERNEL for the element type and the divisor's kind.
#define MB_PICK(KERNEL, E, POW2) \
  reinterpret_cast<const void*>(&KERNEL<E, POW2>)

// Launches a column kernel with the wrapper's plan (T lanes, threads,
// blocks, shared bytes, pitch) after checking that the plan covers every
// lane and row and fits the block: a plan that does not is refused, never
// run another way. lane_major: B and C (a warp a lane, a column of `pitch`
// bytes each); else A (a thread a lane, rows of T elements).
int launch_column(const void* kernel, bool lane_major, const void* tab,
                  const void* idx, void* out, i64 S, i64 L, i64 iters,
                  i64 esize, i64 T, i64 threads, i64 blocks, i64 smem,
                  i64 pitch, FloorMod d, void* stream) {
  const i64 need = lane_major ? T * pitch : S * T * esize;
  const bool ok =
      S >= 1 && L >= 1 && iters >= 0 && T >= 1 && blocks * T >= L &&
      (blocks - 1) * T < L && threads >= (lane_major ? 32 * T : T) &&
      threads <= 1024 && threads % 32 == 0 && smem >= need &&
      smem <= SMEM_MAX && d.n == u32(S) &&
      (!lane_major || (pitch >= S * esize && pitch % 16 == 0));
  if (!ok) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  int s = int(S), l = int(L), t = int(T), p = int(pitch), it = int(iters);
  void* args[] = {&tab, &idx, &out, &s, &l, &t, &p, &it, &d};
  e = cudaLaunchKernel(kernel, dim3(unsigned(blocks)), dim3(unsigned(threads)),
                       args, size_t(smem), (cudaStream_t)stream);
  return int(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// A, B, C: tab (S, L) of esize-byte elements, idx (1, L), out (1, L); the
// plan and the floor modulo's reciprocal (pow2, m, shift, k) from the
// wrapper.
#define MB_COLUMN_ENTRY(NAME, KERNEL, LANE_MAJOR)                             \
  int NAME(const void* tab, const void* idx, void* out, long long S,          \
           long long L, long long iters, long long esize, long long T,        \
           long long threads, long long blocks, long long smem,               \
           long long pitch, long long pow2, long long m, long long shift,     \
           long long k, void* stream) {                                       \
    const FloorMod d = {u32(S), u32(m), u32(shift), u32(k)};                  \
    const void* kernel;                                                       \
    if (esize == 1)                                                           \
      kernel = pow2 ? MB_PICK(KERNEL, u8, true) : MB_PICK(KERNEL, u8, false); \
    else if (esize == 4)                                                      \
      kernel =                                                                \
          pow2 ? MB_PICK(KERNEL, i32, true) : MB_PICK(KERNEL, i32, false);    \
    else                                                                      \
      return int(cudaErrorInvalidValue);                                      \
    return launch_column(kernel, LANE_MAJOR, tab, idx, out, S, L, iters,      \
                         esize, T, threads, blocks, smem, pitch, d, stream);  \
  }

MB_COLUMN_ENTRY(mb_gather_launch, gather_kernel, false)
MB_COLUMN_ENTRY(mb_onehot_launch, onehot_kernel, true)
MB_COLUMN_ENTRY(mb_selwrite_launch, selwrite_kernel, true)

// D and E take the wrapper's plan: `lanes` a block, `threads` (a multiple of
// 32, at least lanes) and `blocks`; E also its shared bytes. A plan that
// does not cover every lane, or E's rows, is refused.
int mb_lane_loop_launch(const void* idx, const void* src, void* work,
                        void* out, long long S, long long W, long long L,
                        long long rounds, long long vec, long long lanes,
                        long long threads, long long blocks, void* stream) {
  if (L < 1 || W < 1 || rounds < 0 || (vec && W % 16) || lanes < 1 ||
      threads < lanes || threads > 1024 || threads % 32 ||
      blocks * lanes < L || (blocks - 1) * lanes >= L)
    return int(cudaErrorInvalidValue);
  lane_loop_kernel<<<int(blocks), int(threads), 0, (cudaStream_t)stream>>>(
      (const i32*)idx, (const u8*)src, (u8*)work, (i32*)out, S, int(W),
      int(L), int(rounds), int(vec), int(lanes));
  return int(cudaGetLastError());
}

int mb_dma_launch(const void* idx, const void* hbm, void* out, long long S,
                  long long W, long long L, long long rounds, long long lanes,
                  long long threads, long long blocks, long long smem,
                  void* stream) {
  if (L < 1 || W < 16 || W % 16 || rounds < 0 || lanes < 1 ||
      threads < lanes || threads > 1024 || threads % 32 ||
      blocks * lanes < L || (blocks - 1) * lanes >= L ||
      smem < ((8 * lanes + 15) & ~15LL) + lanes * W || smem > SMEM_MAX)
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  dma_kernel<<<int(blocks), int(threads), size_t(smem),
               (cudaStream_t)stream>>>((const i32*)idx, (const u8*)hbm,
                                       (i32*)out, S, int(W), int(L),
                                       int(rounds), int(lanes));
  return int(cudaGetLastError());
}

}  // extern "C"
