// Dependent-probe microbenchmarks for Hopper (sm_90a): kernels P1 and P2.
//
// Replace the two TPU kernels of experiments/mb_vmem_probe.py, closures
// inside its main(): `kernel` (P1) and `kernel2` (P2). The wrappers and the
// plain PyTorch versions are in experiments/mb_vmem_probe.py.
//
// P1 is one serial chain by definition: acc carries from lane to lane and
// from round to round, each probe's index coming from the previous probe's
// read. So one thread walks the (L, SW) int32 table in device memory (8 MiB
// at L = 64, SW = 32768: the ISSE table's 128 KiB per lane, L2-resident):
// per probe it reads a 4-word row at a data-dependent offset, writes it back
// + 1, and folds the row's first word into acc. This is the dependent 16-byte
// probe that the CM kernels' ICM and ISSE components pay per nibble.
//
// P2 keeps the LUT (4096 int32 = 16 KiB) in shared memory, one thread per
// lane, with dependent loads. The TPU kernel found each entry by a one-hot
// compare-select-sum, its only way to gather from VMEM; kernel B of
// mb_access.cu keeps that mechanism, and here the load is direct.
//
// Bound: both are latency chains, bound by their chain floors (PERF.md):
// P1 an L2 trip a probe, P2 a shared load a step, each with the integer
// instructions between. Both floor modulos go through floor_mod.cuh (a mask,
// or a multiply-high by the wrapper's reciprocal): no divide in the chain.
// int32 arithmetic wraps as JAX's does, and % is a floor modulo as jnp's
// is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "floor_mod.cuh"

namespace {

typedef int32_t i32;
typedef uint32_t u32;
typedef unsigned long long u64;
typedef long long i64;

constexpr int SMEM_MAX = 227 * 1024;
constexpr int LANE_BLOCK = 128;
constexpr u32 MIX = 741103597u;
constexpr int ACC_MASK = (1 << 20) - 1;  // floor mod 2^20 of an int32

// P1: for it < iters, for l < L: idx = (acc * MIX + l + it) mod (SW - W);
// row = tab[l, idx:idx+W]; tab[l, idx:idx+W] = row + 1;
// acc = (acc + row[0]) mod 2^20. tab is the wrapper's copy of the caller's;
// d the reciprocal of SW - W.
template <bool POW2>
__global__ void lane_rw_kernel(i32* tab, i32* out, int L, i64 SW, int W,
                               int iters, FloorMod d) {
  int acc = 0;
  for (int it = 0; it < iters; ++it)
    for (int l = 0; l < L; ++l) {
      const int x = int(u32(acc) * MIX + u32(l) + u32(it));
      i32* row = tab + i64(l) * SW + floor_mod<POW2>(x, d);
      const int r0 = row[0];
      for (int k = 0; k < W; ++k) row[k] = int(u32(row[k]) + 1u);
      acc = int(u32(acc) + u32(r0)) & ACC_MASK;
    }
  out[0] = acc;
}

// P2: per lane, acc = lane; steps times: idx = (acc + it) mod n;
// acc = (acc + lut[idx]) mod 2^20. The block stages the LUT (16-byte loads
// where n allows them); a step is the index add, the floor modulo (a mask
// at the script's n = 4096, a multiply-high by the wrapper's reciprocal
// otherwise: floor_mod.cuh), the address, one shared load and the
// accumulator's add and mask.
template <bool POW2>
__global__ void lut_kernel(const i32* lut, i32* out, int n, int lanes,
                           int steps, FloorMod d) {
  extern __shared__ __align__(16) i32 s[];
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(lut) % 16 == 0) {
    for (int k = threadIdx.x; k < n / 4; k += blockDim.x)
      reinterpret_cast<uint4*>(s)[k] =
          __ldg(reinterpret_cast<const uint4*>(lut) + k);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) s[k] = __ldg(lut + k);
  }
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  int acc = lane;
  for (int it = 0; it < steps; ++it) {
    const int idx = floor_mod<POW2>(int(u32(acc) + u32(it)), d);
    acc = int(u32(acc) + u32(s[idx])) & ACC_MASK;
  }
  out[lane] = acc;
}

// The chase: the microbenchmarks' yardstick, not a port of a TPU kernel. One
// thread walks a ring of pointers, each step's address being the word the
// step before loaded, so the dependent chain holds the loads and nothing
// else. chase_shared_kernel holds the ring in shared memory (each entry the
// shared address of the next); chase_global_kernel walks a ring in device
// memory with ld.global.cg (L2, never L1), each entry the address of the
// next, from the entry `start` bytes into the ring. out[0] is where the walk
// ended (an index for the shared ring, an
// address for the global one), out[1] the clock cycles of the walk.
// chase_rw_kernel prices what kernel D's chain holds beyond the chase: one
// thread reads a word of device memory with ld.global.cg, writes it back + 1
// and reads it again, `rounds` times, the next read issued right behind the
// store, as in D, so that each read waits on the value the thread's own last
// store left in L2; then the same on the next of `ncells` words, `stride`
// words apart (a word's latency depends on the L2 partition that holds it).
// out[0] is the sum of the values last written (ncells * rounds from zeroed
// words), out[1] the clock cycles of the loops.
__global__ void chase_shared_kernel(const i32* next, u64* out, int n,
                                    i64 steps) {
  extern __shared__ __align__(16) u32 ring[];
  const u32 base = u32(__cvta_generic_to_shared(ring));
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    ring[k] = base + 4u * u32(next[k]);
  __syncthreads();
  if (threadIdx.x) return;
  u32 p = base;
  const long long t0 = clock64();
#pragma unroll 4
  for (i64 i = 0; i < steps; ++i)
    asm volatile("ld.shared.u32 %0, [%0];\n" : "+r"(p)::"memory");
  const long long t1 = clock64();
  out[0] = (p - base) / 4u;
  out[1] = u64(t1 - t0);
}

__global__ void chase_global_kernel(const u64* start, u64* out, i64 steps) {
  u64 p = reinterpret_cast<u64>(start);
  const long long t0 = clock64();
#pragma unroll 4
  for (i64 i = 0; i < steps; ++i)
    asm volatile("ld.global.cg.u64 %0, [%0];\n" : "+l"(p)::"memory");
  const long long t1 = clock64();
  out[0] = p;
  out[1] = u64(t1 - t0);
}

__global__ void chase_rw_kernel(u64* cells, int ncells, i64 stride,
                                u64* out, i64 rounds) {
  u64 v = 0, sum = 0;
  const long long t0 = clock64();
  for (int c = 0; c < ncells; ++c) {
    u64* const cell = cells + c * stride;
    u64* p = cell;
#pragma unroll 4
    for (i64 i = 0; i < rounds; ++i) {
      asm volatile("ld.global.cg.u64 %0, [%1];\n" : "=l"(v) : "l"(p)
                   : "memory");
      asm volatile("st.global.cg.u64 [%0], %1;\n" ::"l"(p), "l"(v + 1)
                   : "memory");
      // v < 2^63, so p stays on the cell; but the compiler cannot see that
      // the next read is of the word just stored, and cannot hand it the
      // stored value in a register: each read goes to memory, as D's do.
      p = cell + (v >> 63);
    }
    sum += v + 1;
  }
  const long long t1 = clock64();
  out[0] = sum;
  out[1] = u64(t1 - t0);
}

}  // namespace

extern "C" {

// P1 with the floor modulo's reciprocal of SW - W (pow2, m, shift, k).
int mb_lane_rw_launch(void* tab, void* out, long long L, long long SW,
                      long long W, long long iters, long long pow2,
                      long long m, long long shift, long long k,
                      void* stream) {
  if (L < 0 || W < 1 || SW <= W || SW - W >= (1LL << 31) || iters < 0)
    return int(cudaErrorInvalidValue);
  const FloorMod d = {u32(SW - W), u32(m), u32(shift), u32(k)};
  if (pow2)
    lane_rw_kernel<true><<<1, 1, 0, (cudaStream_t)stream>>>(
        (i32*)tab, (i32*)out, int(L), SW, int(W), int(iters), d);
  else
    lane_rw_kernel<false><<<1, 1, 0, (cudaStream_t)stream>>>(
        (i32*)tab, (i32*)out, int(L), SW, int(W), int(iters), d);
  return int(cudaGetLastError());
}

// P2 with the wrapper's plan (threads, blocks, shared bytes) and the floor
// modulo's reciprocal (pow2, m, shift, k); a plan that does not cover every
// lane or the LUT is refused.
int mb_lut_launch(const void* lut, void* out, long long n, long long lanes,
                  long long steps, long long threads, long long blocks,
                  long long smem, long long pow2, long long m,
                  long long shift, long long k, void* stream) {
  if (n < 1 || lanes < 1 || steps < 0 || threads < 1 || threads > 1024 ||
      blocks * threads < lanes || (blocks - 1) * threads >= lanes ||
      smem < n * 4 || smem > SMEM_MAX)
    return int(cudaErrorInvalidValue);
  const FloorMod d = {u32(n), u32(m), u32(shift), u32(k)};
  const void* kernel =
      pow2 ? reinterpret_cast<const void*>(&lut_kernel<true>)
           : reinterpret_cast<const void*>(&lut_kernel<false>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  int nn = int(n), ln = int(lanes), st = int(steps);
  void* args[] = {&lut, &out, &nn, &ln, &st, const_cast<FloorMod*>(&d)};
  e = cudaLaunchKernel(kernel, dim3(unsigned(blocks)), dim3(unsigned(threads)),
                       args, size_t(smem), (cudaStream_t)stream);
  return int(e != cudaSuccess ? e : cudaGetLastError());
}

int mb_chase_shared_launch(const void* next, void* out, long long n,
                           long long steps, void* stream) {
  if (n < 1 || n * 4 > SMEM_MAX || steps < 0)
    return int(cudaErrorInvalidValue);
  const size_t smem = size_t(n) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      chase_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  chase_shared_kernel<<<1, 256, smem, (cudaStream_t)stream>>>(
      (const i32*)next, (u64*)out, int(n), steps);
  return int(cudaGetLastError());
}

int mb_chase_global_launch(const void* ring, long long start, void* out,
                           long long steps, void* stream) {
  if (steps < 0 || start < 0 || start % 8) return int(cudaErrorInvalidValue);
  chase_global_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const u64*)((const char*)ring + start), (u64*)out, steps);
  return int(cudaGetLastError());
}

int mb_chase_rw_launch(void* cells, long long ncells, long long stride,
                       void* out, long long rounds, void* stream) {
  if (ncells < 1 || stride < 1 || rounds < 1)
    return int(cudaErrorInvalidValue);
  chase_rw_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (u64*)cells, int(ncells), stride, (u64*)out, rounds);
  return int(cudaGetLastError());
}

}  // extern "C"
