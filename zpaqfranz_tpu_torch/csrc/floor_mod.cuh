// Floor modulo of an int32 by a divisor fixed for a launch, without a divide.
//
// Hopper has no integer divider: x % n with n known only at run time
// compiles to a reciprocal sequence of some 20 instructions, all of them on
// a dependent chain that indexes a table. The wrappers compute the
// divisor's reciprocal on the host once per launch
// (experiments/mb_access.py, mod_plan), and the kernel is instantiated for
// one of two kinds of divisor:
//  - n a power of two: x & (n - 1), the floor modulo of a two's-complement
//    int32;
//  - any other n, with l = ceil(log2 n) >= 2: the low 31 bits u of x
//    reduced by m = ceil(2^(31 + l) / n), which is below 2^32 and gives
//    q = umulhi(u, m) >> (l - 1) = floor(u / n) for every u < 2^31
//    (Granlund and Montgomery, "Division by invariant integers using
//    multiplication", 1994, theorem 4.2). The sign bit's -2^31 enters as
//    k = 2^31 mod n, so r = u - k - q n lies in (-n, n), and min(r, r + n)
//    taken unsigned adds n exactly when r < 0.
// Both are exact for every int32 x.

#pragma once

#include <stdint.h>

struct FloorMod {
  uint32_t n, m, shift, k;
};

template <bool POW2>
__device__ __forceinline__ int floor_mod(int x, FloorMod d) {
  if (POW2) return int(uint32_t(x) & (d.n - 1u));
  const uint32_t u = uint32_t(x) & 0x7fffffffu;
  const uint32_t c = uint32_t(x >> 31) & d.k;
  const uint32_t q = __umulhi(u, d.m) >> d.shift;
  const uint32_t r = u - c - q * d.n;
  return int(min(r, r + d.n));
}
