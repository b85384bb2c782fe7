// Per-lane table-access microbenchmarks for Hopper (sm_90a): kernels A to E.
//
// Replace the TPU kernels of experiments/mb_access.py: mk_gather_kernel (A),
// mk_onehot_kernel (B), mk_selwrite_kernel (C), mk_lane_loop_kernel (D) and
// mk_dma_kernel (E). Each computes what its TPU kernel computes, output for
// output, and keeps the access mechanism its row measures; the wrappers and
// the plain PyTorch versions are in experiments/mb_access.py.
//
// A, B, C: the table is (S, L) row-major, one column per lane. A block holds
// the columns of T lanes in dynamic shared memory, laid out [row * T + t],
// with T set by the launcher so that S * T elements fit the block's 227 KB;
// one thread per lane. A makes ITERS dependent loads from its column, B
// finds each row by a compare-select-sum over all S rows (the TPU's one-hot
// gather), C rewrites its whole column with a select per iteration (the
// TPU's select-pass write). D reads and writes a W-byte row per lane at a
// data-dependent offset of an (L, S) u8 table in device memory (16 MiB at
// S = 131072: L2-resident). E copies a W-byte row per lane from an (L, S)
// table in device memory (128 MiB at the script's S = 1 MiB) into shared
// memory with cp.async in 16-byte granules, waits, and reads it.
//
// Bound: every kernel is a chain of dependent accesses, so none of them is
// bound by bytes or operations at these shapes (PERF.md gives the bounds);
// what they time is the latency of one access of each kind. int32
// arithmetic wraps as JAX's does (computed in uint32), and % is a floor
// modulo as jnp's is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint8_t u8;
typedef int32_t i32;
typedef uint32_t u32;
typedef long long i64;

constexpr int SMEM_MAX = 227 * 1024;
constexpr int LANE_BLOCK = 128;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return int(u32(a) + u32(b));
}

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// Copies the columns of this block's lanes into shared memory, [row * T + t].
template <typename E>
__device__ __forceinline__ E* load_columns(const E* tab, int S, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  E* col = reinterpret_cast<E*>(smem);
  const int T = blockDim.x;
  const int lane0 = blockIdx.x * T;
  for (int k = threadIdx.x; k < S * T; k += T) {
    const int r = k / T, c = k - r * T;
    col[k] = lane0 + c < L ? tab[i64(r) * L + lane0 + c] : E(0);
  }
  __syncthreads();
  return col;
}

// A: acc += tab[(idx0 + acc) % S, lane], ITERS times.
template <typename E>
__global__ void gather_kernel(const E* tab, const i32* idx, i32* out, int S,
                              int L, int iters) {
  const E* col = load_columns(tab, S, L);
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = blockIdx.x * T + t;
  if (lane >= L) return;
  const int i0 = idx[lane];
  int acc = 0;
  for (int i = 0; i < iters; ++i)
    acc = wrap_add(acc, int(col[floor_mod(wrap_add(i0, acc), S) * T + t]));
  out[lane] = acc;
}

// B: the same result as A; each row found by comparing every row index.
template <typename E>
__global__ void onehot_kernel(const E* tab, const i32* idx, i32* out, int S,
                              int L, int iters) {
  const E* col = load_columns(tab, S, L);
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = blockIdx.x * T + t;
  if (lane >= L) return;
  const int i0 = idx[lane];
  int acc = 0;
  for (int i = 0; i < iters; ++i) {
    const int r = floor_mod(wrap_add(i0, acc), S);
    u32 row = 0;
    for (int s = 0; s < S; ++s) row += s == r ? u32(col[s * T + t]) : 0u;
    acc = wrap_add(acc, int(row));
  }
  out[lane] = acc;
}

// C: ITERS passes, each writing carry & 0xFF into row (idx0 + i) % S of the
// lane's column by a select over every row; out = ITERS + column[0].
// The caller's table is untouched: the column lives in shared memory.
template <typename E>
__global__ void selwrite_kernel(const E* tab, const i32* idx, i32* out, int S,
                                int L, int iters) {
  E* col = load_columns(tab, S, L);
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = blockIdx.x * T + t;
  if (lane >= L) return;
  const int i0 = idx[lane];
  int carry = 0;
  for (int i = 0; i < iters; ++i) {
    const int r = floor_mod(wrap_add(i0, i), S);
    const E v = E(carry & 0xFF);
    for (int s = 0; s < S; ++s) {
      const E old = col[s * T + t];
      col[s * T + t] = s == r ? v : old;
    }
    carry = wrap_add(carry, 1);
  }
  out[lane] = wrap_add(carry, int(col[t]));
}

// Adds each thread's v into *out: a warp sum, then one atomic per warp.
// Every thread of the block must call it.
__device__ __forceinline__ void add_out(i32* out, u32 v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(reinterpret_cast<u32*>(out), v);
}

// 16-byte volatile load and store: the compiler may neither keep a row in
// registers across rounds nor drop a store, so every round goes to memory.
__device__ __forceinline__ uint4 ld16(const u8* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st16(u8* p, uint4 v) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// D: ROUNDS times per lane, read the W-byte row at tab[lane, idx[lane]],
// write it back + 1, and add its first byte to *out. Round 0 reads the
// caller's table `src` and every round writes `work` (same shape), so the
// caller's table is untouched without a copy of it: each lane only ever
// touches its own row. vec: W % 16 == 0 and every row 16-byte aligned, so a
// row moves as 16-byte words with a per-byte add (__vadd4); otherwise byte
// by byte. All accesses are volatile.
__global__ void lane_loop_kernel(const i32* idx, const u8* src, u8* work,
                                 i32* out, i64 S, int W, int L, int rounds,
                                 int vec) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  u32 acc = 0;
  if (lane < L) {
    const i64 at = i64(lane) * S + idx[lane];
    const u8* rd = src + at;
    u8* wr = work + at;
    for (int it = 0; it < rounds; ++it) {
      if (vec) {
        for (int k = 0; k < W; k += 16) {
          uint4 v = ld16(rd + k);
          if (k == 0) acc += v.x & 0xFFu;
          v.x = __vadd4(v.x, 0x01010101u);
          v.y = __vadd4(v.y, 0x01010101u);
          v.z = __vadd4(v.z, 0x01010101u);
          v.w = __vadd4(v.w, 0x01010101u);
          st16(wr + k, v);
        }
      } else {
        const volatile u8* r = rd;
        volatile u8* w = wr;
        acc += r[0];
        for (int k = 0; k < W; ++k) w[k] = u8(r[k] + 1);
      }
      rd = wr;
    }
  }
  add_out(out, acc);
}

// E: ROUNDS times per lane, copy the W-byte row at hbm[lane, idx[lane]] into
// the lane's W bytes of shared memory by cp.async (16-byte granules, L2
// only), wait for it, and add the copy's first byte to *out. The launcher
// checks that W % 16 == 0 and every row is 16-byte aligned.
__global__ void dma_kernel(const i32* idx, const u8* hbm, i32* out, i64 S,
                           int W, int L, int rounds) {
  extern __shared__ __align__(16) unsigned char scratch[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  u32 acc = 0;
  if (lane < L) {
    const u8* src = hbm + i64(lane) * S + idx[lane];
    volatile u8* dst = scratch + threadIdx.x * W;
    const u32 sdst = u32(__cvta_generic_to_shared(scratch + threadIdx.x * W));
    for (int it = 0; it < rounds; ++it) {
      for (int k = 0; k < W; k += 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         sdst + k),
                     "l"(src + k)
                     : "memory");
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      acc += dst[0];
    }
  }
  add_out(out, acc);
}

// Lanes per block for A, B, C: as many as fit shared memory, at most L.
inline int column_threads(int S, int esize, int L) {
  const int t = SMEM_MAX / (S * esize);
  return t < L ? (t < 1024 ? t : 1024) : (L < 1024 ? L : 1024);
}

template <typename E>
int launch_columns(void (*kernel)(const E*, const i32*, i32*, int, int, int),
                   const void* tab, const void* idx, void* out, int S, int L,
                   int iters, void* stream) {
  if (S < 1 || L < 1 || iters < 0) return int(cudaErrorInvalidValue);
  const int T = column_threads(S, int(sizeof(E)), L);
  if (T < 1) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(S) * T * sizeof(E);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  kernel<<<(L + T - 1) / T, T, smem, (cudaStream_t)stream>>>(
      (const E*)tab, (const i32*)idx, (i32*)out, S, L, iters);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define MB_COLUMN_ENTRY(NAME, KERNEL)                                        \
  int NAME(const void* tab, const void* idx, void* out, long long S,         \
           long long L, long long iters, long long esize, void* stream) {    \
    if (S * esize > SMEM_MAX) return int(cudaErrorInvalidValue);             \
    if (esize == 1)                                                          \
      return launch_columns<u8>(KERNEL<u8>, tab, idx, out, int(S), int(L),   \
                                int(iters), stream);                         \
    if (esize == 4)                                                          \
      return launch_columns<i32>(KERNEL<i32>, tab, idx, out, int(S), int(L), \
                                 int(iters), stream);                        \
    return int(cudaErrorInvalidValue);                                       \
  }

MB_COLUMN_ENTRY(mb_gather_launch, gather_kernel)
MB_COLUMN_ENTRY(mb_onehot_launch, onehot_kernel)
MB_COLUMN_ENTRY(mb_selwrite_launch, selwrite_kernel)

int mb_lane_loop_launch(const void* idx, const void* src, void* work,
                        void* out, long long S, long long W, long long L,
                        long long rounds, long long vec, void* stream) {
  if (L < 1 || W < 1 || rounds < 0 || (vec && W % 16))
    return int(cudaErrorInvalidValue);
  lane_loop_kernel<<<(L + LANE_BLOCK - 1) / LANE_BLOCK, LANE_BLOCK, 0,
                     (cudaStream_t)stream>>>(
      (const i32*)idx, (const u8*)src, (u8*)work, (i32*)out, S, int(W),
      int(L), int(rounds), int(vec));
  return int(cudaGetLastError());
}

int mb_dma_launch(const void* idx, const void* hbm, void* out, long long S,
                  long long W, long long L, long long rounds, void* stream) {
  if (L < 1 || W < 16 || W % 16 || rounds < 0 || W * LANE_BLOCK > SMEM_MAX)
    return int(cudaErrorInvalidValue);
  const size_t smem = size_t(W) * LANE_BLOCK;
  cudaError_t e = cudaFuncSetAttribute(
      dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  dma_kernel<<<(L + LANE_BLOCK - 1) / LANE_BLOCK, LANE_BLOCK, smem,
               (cudaStream_t)stream>>>((const i32*)idx, (const u8*)hbm,
                                       (i32*)out, S, int(W), int(L),
                                       int(rounds));
  return int(cudaGetLastError());
}

}  // extern "C"
