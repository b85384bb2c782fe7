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
// Bound: both are latency chains (see PERF.md); int32 arithmetic wraps as
// JAX's does, and % is a floor modulo as jnp's is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef int32_t i32;
typedef uint32_t u32;
typedef long long i64;

constexpr int SMEM_MAX = 227 * 1024;
constexpr int LANE_BLOCK = 128;
constexpr u32 MIX = 741103597u;
constexpr int ACC_MASK = (1 << 20) - 1;  // floor mod 2^20 of an int32

__device__ __forceinline__ int floor_mod(int x, int m) {
  const int r = x % m;
  return r < 0 ? r + m : r;
}

// P1: for it < iters, for l < L: idx = (acc * MIX + l + it) mod (SW - W);
// row = tab[l, idx:idx+W]; tab[l, idx:idx+W] = row + 1;
// acc = (acc + row[0]) mod 2^20. tab is the wrapper's copy of the caller's.
__global__ void lane_rw_kernel(i32* tab, i32* out, int L, i64 SW, int W,
                               int iters) {
  const int m = int(SW - W);
  int acc = 0;
  for (int it = 0; it < iters; ++it)
    for (int l = 0; l < L; ++l) {
      const int x = int(u32(acc) * MIX + u32(l) + u32(it));
      i32* row = tab + i64(l) * SW + floor_mod(x, m);
      const int r0 = row[0];
      for (int k = 0; k < W; ++k) row[k] = int(u32(row[k]) + 1u);
      acc = int(u32(acc) + u32(r0)) & ACC_MASK;
    }
  out[0] = acc;
}

// P2: per lane, acc = lane; steps times: idx = (acc + it) mod n;
// acc = (acc + lut[idx]) mod 2^20.
__global__ void lut_kernel(const i32* lut, i32* out, int n, int lanes,
                           int steps) {
  extern __shared__ __align__(16) i32 s[];
  for (int k = threadIdx.x; k < n; k += blockDim.x) s[k] = lut[k];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  int acc = lane;
  for (int it = 0; it < steps; ++it) {
    const int idx = floor_mod(int(u32(acc) + u32(it)), n);
    acc = int(u32(acc) + u32(s[idx])) & ACC_MASK;
  }
  out[lane] = acc;
}

}  // namespace

extern "C" {

int mb_lane_rw_launch(void* tab, void* out, long long L, long long SW,
                      long long W, long long iters, void* stream) {
  if (L < 0 || W < 1 || SW <= W || iters < 0)
    return int(cudaErrorInvalidValue);
  lane_rw_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (i32*)tab, (i32*)out, int(L), SW, int(W), int(iters));
  return int(cudaGetLastError());
}

int mb_lut_launch(const void* lut, void* out, long long n, long long lanes,
                  long long steps, void* stream) {
  if (n < 1 || n * 4 > SMEM_MAX || lanes < 1 || steps < 0)
    return int(cudaErrorInvalidValue);
  const size_t smem = size_t(n) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      lut_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  lut_kernel<<<(lanes + LANE_BLOCK - 1) / LANE_BLOCK, LANE_BLOCK, smem,
               (cudaStream_t)stream>>>((const i32*)lut, (i32*)out, int(n),
                                       int(lanes), int(steps));
  return int(cudaGetLastError());
}

}  // extern "C"
