// ZPAQ context-mixing model shared by the CM lane decoder (cm_decode.cu) and
// encoder (cm_encode.cu) for Hopper (sm_90a): the predictor, its update and
// HCOMP's ZPAQL interpreter, with the lane kernels' common set-up and launch.
//
// Replaces the model half of zpaqfranz_tpu/ops/codec_arena.py (ArenaCoder:
// byte_step's _probe_all, _bit and _byte_end) together with its HCOMP step
// (ops/hcomp_fast.py FastHcomp.run, fallback ops/vm_batched.py
// BatchedVM.run). Only the range coder differs between the two kernels.
// Component semantics follow the scalar engine native/src/tzpaq.cpp
// (Predictor::find, predict_generic, train, update_generic, update_tail),
// which is byte-identical to the arena engine.
//
// Bound: a lane is one ZPAQ d block, coded bit after bit; each bit's
// prediction is a chain of dependent table reads and integer steps, so a
// lane runs at latency, far below the card's 3.35 TB/s. On this card a
// dependent L2 access costs ~313 ns and a dependent shared-memory step
// ~75 ns (csrc/mb_vmem_probe.cu). The design takes the table reads off that
// chain:
//
// - A group of G threads (a power of two up to 32, chosen from the number of
//   components n by ops/cm_model.py Placement) codes one lane; thread k owns
//   components k, k+G, ... All lanes of a launch share one model, so the
//   groups of a warp run the same instructions on their own data.
// - Each bit runs in three phases. (a) Every thread issues the reads of its
//   components, none of which depends on the bit's other predictions: CM
//   counters, ICM/ISSE state bytes and their counters or weight pairs, MATCH
//   bits, MIX2 weights; the group copies each MIX weight row and each SSE
//   row of 32 counters (its interpolation picks two by the input's
//   prediction) into shared memory, from device memory with cp.async. (b)
//   Thread 0 of the group walks the combine (AVG, MIX2, MIX, ISSE, SSE) in
//   component order from shared memory and runs the range coder step;
//   MIX's dot product is summed in uint32 so that it is exact in any
//   order. The combine is a policy of the kernels (template parameter
//   Combine): FastCombine runs the model's combine as straight-line code
//   that ops/combine_fast.py generates, the loads that do not depend on
//   the bit issued ahead of the chain and the steps' outputs in registers;
//   GenericCombine (phase_b) walks one packed step per component, for the
//   models the generator refuses. (c) Every thread updates its own
//   components, and the group the MIX rows and SSE counters: each
//   component owns its tables, so the updates run in parallel and need no
//   second read of the values (a) loaded. Phase (c) of one bit and phase
//   (a) of the next run back to back without a barrier between them.
//   Phases (a) and (c) are a policy of the kernels too (template parameter
//   Phases): FastPhases runs the model's phases as straight-line code that
//   ops/phases_fast.py generates for its placement: thread k owns component
//   k (every preset has G >= n), loads its constants into registers once a
//   lane and keeps its own state there from bit to bit (its context, the
//   held row, what (a) read), the MIX and SSE rows unrolled with their
//   owners and placements fixed, only the model's own types compiled in;
//   the region keeps what other threads read or write. GenericPhases
//   (phase_a, phase_c) reads the model from the block header on every bit,
//   for the models the generator refuses (G < n).
// - Phases (a) and (c) are one instruction stream for every component type
//   (addresses and results selected by type): threads of one warp that took
//   different branches would run them one after another, and their reads'
//   latencies would add up instead of overlapping.
// - ICM/ISSE hash rows are fetched once per nibble: the three candidate
//   16-byte rows of find() arrive as three 16-byte loads in flight at once
//   and the chosen row stays with its thread for the nibble's four bits (in
//   shared memory, or in registers with the generated phases), written back
//   before the next find().
// - Small per-lane tables (ICM/ISSE state tables, small CM, MIX, MIX2, SSE
//   and MATCH pointer tables, HCOMP's H) live in shared memory, placed by
//   ops/cm_model.py Placement within a per-lane budget; the rest stay in
//   device memory behind phase (a)'s early reads. The squash, stretch and
//   state tables are shared by the block (stretch as its lower half, the
//   table being odd about its middle).
// - At a byte's end MATCH's length search compares G positions at a time
//   (__ballot_sync) and HCOMP runs on thread 0. The HCOMP step is a policy
//   of the kernels (template parameter Step): FastStep runs the model's
//   program as straight-line code that ops/hcomp_fast.py generates (the
//   port of zpaqfranz_tpu/ops/hcomp_fast.py): the last bytes in thread 0's
//   registers as a window, the contexts written straight into the lane's
//   h, no H and no M, no loads but the old contexts. Interp is a full ZPAQL
//   interpreter (every opcode, jumps and LJ included, H in shared memory
//   when placed, M in device memory) for the programs the specialiser
//   rejects, with a per-launch step limit.
//
// What bounds it now (a bit at -m4, ~2,500 cycles with every policy
// generated): phases (a) and (c), about half of it, phase (a) waiting for
// the nibble's hash rows and the device rows' cp.async and phase (c) for
// its loads of predictions, squash and counter steps; the combine and the
// coder step on thread 0, about a quarter; MATCH's byte end and the
// group's waits; HCOMP where it is interpreted (PERF.md;
// experiments/combine_profile.py prints the profiled phases).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef uint8_t u8;
typedef uint32_t u32;
typedef int32_t i32;
typedef uint64_t u64;
typedef int64_t i64;

enum { NONE, CONS, CM, ICM, MATCH, AVG, MIX2, MIX, ISSE, SSE };

// per-lane status codes (mirrored in ops/cm_model.py)
enum { ST_OK = 0, ST_OVERRUN = 1, ST_CORRUPT = 2, ST_EOF = 3, ST_ZPAQL = 4 };

// combined LUT layout: squash(4096) | stretch(32768) | sns(1024)
constexpr int SQ_OFF = 0;
constexpr int STR_OFF = 4096;
constexpr int SNS_OFF = 4096 + 32768;
constexpr int MAXC = 256;
constexpr int NPAR = 6;    // comp params: type p1..p5
constexpr int SMEM_LIMIT = 232448;   // shared bytes one block may use
// threads one block may have: the kernels are compiled for it
// (__launch_bounds__), which leaves a thread up to 128 registers; with
// 1024 a thread would get 64 and the kernels use about 120. A unit with
// the generated phases (ops/phases_fast.py) is compiled for its own block
// (CM_BLOCK_THREADS, lanes a block times G): its shared memory already
// holds an SM to one block, so the registers that frees cost nothing.
#ifdef CM_BLOCK_THREADS
constexpr int MAX_BLOCK_THREADS = CM_BLOCK_THREADS;
#else
constexpr int MAX_BLOCK_THREADS = 512;
#endif

// Placement of one model (ops/cm_model.py Placement.geometry): word offsets
// of the per-lane arrays inside a lane's shared region. H is at G_HT, or in
// device memory when G_HT < 0.
enum { G_H, G_P, G_CXT, G_WA, G_WB, G_ROWAT, G_ROW, G_MISC, G_HT, NGEO };
// Clock counters of a profiled launch, per lane (thread 0 of its group):
// cycles in phase (a), waiting for the group after it, the combine and
// coder step, the broadcast of the bit, phase (c), the bit's tail, MATCH's
// byte end, HCOMP and the new context hashes; then the coded bits and
// bytes.
enum { P_A, P_WAIT_A, P_B, P_WAIT_B, P_C, P_TAIL, P_MATCH, P_HCOMP, P_HASH,
       P_BITS, P_BYTES, NPROF };

// per-component placement columns: u32 table in shared memory (word offset
// in the lane's region, -1 = device memory), its size in words, offset of
// its MIX/SSE row copy in the lane's region (-1 = none)
enum { CP_SH32, CP_SZ32, CP_RS, NPLAN };

// Block header in shared memory: squash (i16), the state table (u8), the
// lower half of stretch (i16; stretch(32767 - x) = -stretch(x)), a
// counter's step per count (u32) and MATCH's 2048 / length (i16), then the
// model: the combine's steps, u8 and u32 table offsets, component
// parameters, placement, the MIX/SSE and MATCH component lists, and the
// HCOMP bytecode with one byte of padding.
__host__ __device__ inline int header_bytes(int n, int hlen) {
  return (4096 * 2 + 1024 + 16384 * 2 + 1024 * 4 + 256 * 2 + 16 * n
          + 16 * n + 4 * NPAR * n + 4 * NPLAN * n + 8 * n + 12 + hlen + 1
          + 15) & ~15;
}

struct Model {
  const short* sq;      // squash(x) at sq[x + 2048]
  const u8* sns;        // state table: next state at sns[s * 4 + y]
  const short* st;      // stretch(x) for x < 16384
  const u32* dt;        // ((1 << 17) / (2 * count + 3)) * 2
  const short* dt2k;    // 2048 / length (0 at 0)
  const i64* off8;      // device u8 arena offsets (64-byte aligned)
  const i64* off32;     // device u32 arena offsets
  const i32* cp;        // n * NPAR
  const i32* plan;      // n * NPLAN
  const i32* rows;      // MIX and SSE components
  const i32* matches;   // MATCH components
  const int4* combine;  // steps of the combine, one per component but CONS,
                        // CM, ICM and MATCH: (i | type << 16, first input,
                        // second input or MIX's m, AVG's weight or the
                        // row copy's offset)
  int nrows, nmatch, ncombine;
  const u8* code;       // hcomp bytecode
  int n, hlen;
  u32 hmask, mmask;
  // an interpreted HCOMP run that executes more instructions than this for
  // one byte is taken as a runaway program: the lane fails instead of
  // holding the card (ops/cm_model.py MAX_HCOMP_STEPS by default)
  u64 max_steps;
};

// One lane as one thread of its group sees it. The arrays are the lane's
// shared region; c8, hmap4, bit and status are the same in every thread of
// the group, the ZPAQL registers live in thread 0.
struct Lane {
  int k, G;
  unsigned gmask;   // the group's threads in the warp
  int gbase;        // the group's first lane in the warp
  u32* h;           // context hashes from HCOMP
  i32* p;           // component predictions (stretched) of this bit
  i32* pn;          // ... of the next bit (p and pn swap every bit)
  u32* cxt;         // per-component context / table index / MATCH bit
  u32* wa;          // values phase (a) read: counter, weight, weight pair
  u32* wb;
  u32* rowat;       // ICM/ISSE: byte offset + 1 of the held row (0: none)
  uint4* row;       // ICM/ISSE: the held row; MATCH: ml, mb, ma, byte
  u32* sw;          // the lane's shared region (placed tables, row copies)
  volatile u32* misc;   // thread 0's broadcasts
  u8* A8;
  u32* A32;
  u32* H;
  u8* M;
  u32* R;           // ZPAQL R (device memory: the standard programs never
                    // touch it)
  u32 c8, hmap4;
  int bit, status;
  u32 b, c, d, f;    // ZPAQL registers kept from byte to byte (A starts
                    // as the byte)
  long long* prof;      // this lane's NPROF counters (thread 0), or null
  long long acc[NPROF];
  long long t;
  long long* stamp;     // this lane's start and end in ns (thread 0), or
                        // null
};

// the card's nanosecond clock, one for every SM
__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// adds the cycles since the last mark to counter k of a profiled lane
__device__ __forceinline__ void mark(Lane& s, int k) {
  if (s.prof) {
    const long long t = clock64();
    s.acc[k] += t - s.t;
    s.t = t;
  }
}

__device__ __forceinline__ int clamp2k(int x) {
  return x < -2048 ? -2048 : (x > 2047 ? 2047 : x);
}
__device__ __forceinline__ int clamp512k(int x) {
  return x < -(1 << 19) ? -(1 << 19) : (x > (1 << 19) - 1 ? (1 << 19) - 1 : x);
}
__device__ __forceinline__ int stretch(const Model& m, u32 x) {
  return x < 16384 ? m.st[x] : -m.st[32767 - x];
}
__device__ __forceinline__ int squash(const Model& m, int x) {
  return m.sq[x + 2048];
}
__device__ __forceinline__ void gsync(const Lane& s) { __syncwarp(s.gmask); }

// component i's u32 table: in the lane's shared region or device memory
__device__ __forceinline__ u32* tab(const Lane& s, const Model& m, int i) {
  const int sh = m.plan[i * NPLAN + CP_SH32];
  return sh >= 0 ? s.sw + sh : s.A32 + m.off32[i];
}

__device__ __forceinline__ u32 row_byte(const uint4& r, u32 j) {
  const u32 w = j < 8 ? (j < 4 ? r.x : r.y) : (j < 12 ? r.z : r.w);
  return (w >> (8 * (j & 3))) & 255u;
}
__device__ __forceinline__ void set_row_byte(uint4& r, u32 j, u32 v) {
  const u32 sh = 8 * (j & 3);
  const u32 keep = ~(255u << sh), put = (v & 255u) << sh;
  if (j < 4) r.x = (r.x & keep) | put;
  else if (j < 8) r.y = (r.y & keep) | put;
  else if (j < 12) r.z = (r.z & keep) | put;
  else r.w = (r.w & keep) | put;
}

// ICM/ISSE hash probe of component i: write back the row held since the
// last probe, then 16-byte rows at h0, h0^16, h0^32 (one 64-byte line),
// check byte at +0, priority = state byte at +1, replace the lowest.
// Predicated so that every thread of a warp runs the same instructions:
// with go false it reads the table's first line and stores nothing.
__device__ __forceinline__ void fetch_row(Lane& s, const Model& m, int i,
                                          bool go, int bits, u32 cx) {
  u8* ht = s.A8 + m.off8[i];
  const u32 back = s.rowat[i];
  if (go && back) *reinterpret_cast<uint4*>(ht + back - 1) = s.row[i];
  const u32 chk = (cx >> (bits + 2)) & 255u;
  const u64 h0 = go ? u64(cx * 16u) & ((u64(64) << bits) - 16) : 0;
  const uint4 r0 = *reinterpret_cast<const uint4*>(ht + h0);
  const uint4 r1 = *reinterpret_cast<const uint4*>(ht + (h0 ^ 16));
  const uint4 r2 = *reinterpret_cast<const uint4*>(ht + (h0 ^ 32));
  const bool m0 = (r0.x & 255u) == chk, m1 = (r1.x & 255u) == chk,
             m2 = (r2.x & 255u) == chk;
  const u32 q0 = (r0.x >> 8) & 255u, q1 = (r1.x >> 8) & 255u,
            q2 = (r2.x >> 8) & 255u;
  const u64 low = (q0 <= q1 && q0 <= q2) ? h0 : (q1 < q2 ? h0 ^ 16 : h0 ^ 32);
  const u64 at = m0 ? h0 : m1 ? (h0 ^ 16) : m2 ? (h0 ^ 32) : low;
  const uint4 r = m0 ? r0 : m1 ? r1 : m2 ? r2 : make_uint4(chk, 0u, 0u, 0u);
  if (go) {
    s.row[i] = r;
    s.rowat[i] = u32(at) + 1u;
  }
}

// pn trained toward bit y (pn is the slot's value as phase (a) read it)
__device__ __forceinline__ u32 trained(const Model& m, u32 pn, int y,
                                       u32 limit) {
  const u32 count = pn & 1023u;
  const int error = y * 32767 - int(pn >> 17);
  return pn + ((u32(error) * m.dt[count]) & 0xFFFFFC00u) + (count < limit);
}

// 4-byte copy from device to shared memory that completes in the
// background (cp.async), waited for by copy_wait()
__device__ __forceinline__ void copy_async(u32* dst, const u32* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   u32(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Phase (a): every thread reads what its components and the group's MIX
// and SSE rows need for this bit. The rows' copies go first, in the
// background (cp.async from device memory), so that they overlap the
// components' reads. One instruction stream for every component type:
// addresses and results are selected by type, and a type that reads
// nothing reads the lane's region, so that the warp never splits on the
// type and all its reads are in flight at once.
__device__ __forceinline__ void phase_a(Lane& s, const Model& m) {
  for (int r = 0; r < m.nrows; ++r) {
    const int i = m.rows[r];
    const i32* cp = m.cp + i * NPAR;
    const bool mix = cp[0] == MIX;
    const u32 base = mix ? ((s.h[i] + (s.c8 & u32(cp[5])))
                            & ((1u << cp[1]) - 1u)) * u32(cp[3])
                         : ((s.h[i] + s.c8) * 32u) & ((32u << cp[1]) - 1u);
    const int len = mix ? cp[3] : 32;
    const u32* t = tab(s, m, i) + base;
    u32* dst = s.sw + m.plan[i * NPLAN + CP_RS];
    if (m.plan[i * NPLAN + CP_SH32] >= 0) {
      for (int j = s.k; j < len; j += s.G) dst[j] = t[j];
    } else {
      for (int j = s.k; j < len; j += s.G) copy_async(dst + j, t + j);
    }
  }
  const bool nibble = s.c8 == 1 || (s.c8 & 0xf0) == 16;
  const u32 j4 = s.hmap4 & 15u;
  for (int i = s.k; i < m.n; i += s.G) {
    const i32* cp = m.cp + i * NPAR;
    const int t = cp[0];
    const u32 h = s.h[i];
    const bool hashed = t == ICM || t == ISSE;
    if (nibble) fetch_row(s, m, i, hashed, hashed ? cp[1] : 0, h + 16u * s.c8);
    const uint4 row = s.row[i];          // MATCH: ml, mb, ma, its byte
    const u32 st = row_byte(row, j4);
    const u32 mask = (1u << (cp[1] & 31)) - 1u;
    const u32 idx = t == CM ? (h ^ s.hmap4) & mask
                  : t == MIX2 ? (h + (s.c8 & u32(cp[5]))) & mask
                  : t == ISSE ? st * 2 : st;
    const u32* tb = (hashed || t == CM || t == MIX2) ? tab(s, m, i) + idx
                                                     : s.sw;
    const u32 v0 = tb[0];
    const u32 v1 = t == ISSE ? tb[1] : 0u;
    const u32 mc = (row.w >> (7 - s.bit)) & 1u;
    const u32 sx = t == CM ? v0 >> 17 : t == ICM ? v0 >> 8
                 : u32(m.dt2k[row.z & 255u] * (1 - 2 * int(mc))) & 32767u;
    const int sp = stretch(m, sx);
    s.p[i] = t == CONS ? (cp[1] - 128) * 4 : (t == MATCH && row.z == 0) ? 0
                                                                   : sp;
    if (t != SSE) s.cxt[i] = t == MATCH ? mc : hashed ? st : idx;
    s.wa[i] = v0;
    s.wb[i] = v1;
  }
  copy_wait();
}

// Phase (b), thread 0: the dependent combine in component order. Returns
// P(next bit = 1) in 1/4096 units; the coders split at that * 2 + 1.
__device__ __forceinline__ int phase_b(Lane& s, const Model& m) {
  i32* p = s.p;
  int last = -1, lastp = 0;   // the previous step's output, in a register
  for (int q = 0; q < m.ncombine; ++q) {
    const int4 d = m.combine[q];
    const int i = d.x & 0xffff;
    int x1, x2;
    if (d.y == last) x1 = lastp;
    else x1 = p[d.y];
    int v;
    // if-else in order of frequency: one thread, so no branch diverges,
    // and compares cost less than a switch's indirect jump
    const int t = d.x >> 16;
    const int wa = int(s.wa[i]), wb = int(s.wb[i]);
    if (t == ISSE) {
      v = clamp2k((wa * x1 + wb * 64) >> 16);
    } else if (t == MIX) {
      const u32* w = s.sw + d.w;
      const i32* x = p + d.y;
      u32 sum = 0;
#pragma unroll 4
      for (int j = 0; j < d.z; ++j)
        sum += u32((i32(w[j]) >> 8) * (d.y + j == last ? lastp : x[j]));
      v = clamp2k(i32(sum) >> 8);
    } else if (t == MIX2 || t == AVG) {
      x2 = d.z == last ? lastp : p[d.z];
      v = t == MIX2 ? (wa * x1 + (65536 - wa) * x2) >> 16
                    : (x1 * d.w + x2 * (256 - d.w)) >> 8;
    } else if (t == SSE) {
      const u32* r = s.sw + d.w;
      int pq = x1 + 992;
      if (pq < 0) pq = 0;
      if (pq > 1983) pq = 1983;
      const int wt = pq & 63;
      pq >>= 6;
      v = stretch(m, u32((int(r[pq] >> 10) * (64 - wt)
                          + int(r[pq + 1] >> 10) * wt) >> 13));
      s.cxt[i] = (s.h[i] + s.c8) * 32u + u32(pq) + u32(wt >> 5);
    } else {
      s.status = ST_CORRUPT;
      return 0;
    }
    p[i] = v;
    last = i;
    lastp = v;
  }
  return squash(m, last == m.n - 1 ? lastp : p[m.n - 1]);
}

// The combine a kernel runs in phase (b), a policy of the kernels (template
// parameter Combine) as the HCOMP step is: GenericCombine walks the model's
// steps with phase_b; FastCombine<C> runs the model's combine as the
// straight-line code that ops/combine_fast.py generates (struct
// CombineFast), with the same result and side effects.
struct GenericCombine {
  __device__ __forceinline__ static int run(Lane& s, const Model& m) {
    return phase_b(s, m);
  }
};

template <class C>
struct FastCombine {
  __device__ __forceinline__ static int run(Lane& s, const Model& m) {
    return C::run(s.p, s.wa, s.wb, s.sw, s.cxt, s.h, s.c8, m.sq, m.st);
  }
};

// Phase (c): every thread updates its components toward bit y, in one
// instruction stream for every type as in phase (a); the group updates
// the MIX rows and SSE counters, each element by the thread that copied it.
__device__ __forceinline__ void phase_c(Lane& s, const Model& m, int y) {
  const i32* p = s.p;
  const u32 j4 = s.hmap4 & 15u;
  for (int i = s.k; i < m.n; i += s.G) {
    const i32* cp = m.cp + i * NPAR;
    const int t = cp[0];
    const u32 cx = s.cxt[i], v0 = s.wa[i], v1 = s.wb[i];
    const u32 err = u32(y * 32767 - squash(m, p[i]));
    const u32 x2 = u32(p[cp[2] & 255]), x3 = u32(p[cp[3] & 255]);
    const u32 isse0 = u32(clamp512k(i32(v0) + (i32(err * x2 + 4096u) >> 13)));
    const u32 isse1 = u32(clamp512k(i32(v1) + ((i32(err) + 16) >> 5)));
    int w = i32(v0) + (i32(u32(i32(err * u32(cp[4])) >> 5) * (x2 - x3)
                           + 4096u) >> 13);
    w = w < 0 ? 0 : (w > 65535 ? 65535 : w);
    const u32 new0 = t == CM ? trained(m, v0, y, u32(cp[2]) * 4u)
                   : t == ICM ? v0 + u32((y * 32767 - int(v0 >> 8)) >> 2)
                   : t == ISSE ? isse0 : u32(w);
    const bool hashed = t == ICM || t == ISSE;
    u32* tb = tab(s, m, i) + (t == ISSE ? cx * 2 : cx);
    if (hashed || t == CM || t == MIX2) tb[0] = new0;
    if (t == ISSE) tb[1] = isse1;
    if (hashed) {
      uint4 r = s.row[i];
      set_row_byte(r, j4, m.sns[(cx & 255u) * 4 + y]);
      s.row[i] = r;
    }
    if (t == MATCH && s.row[i].z != 0 && int(cx) != y) s.row[i].z = 0;
  }
  for (int r = 0; r < m.nrows; ++r) {
    const int i = m.rows[r];
    const i32* cp = m.cp + i * NPAR;
    const u32* w = s.sw + m.plan[i * NPLAN + CP_RS];
    if (cp[0] == MIX) {
      const int err = ((y * 32767 - squash(m, p[i])) * cp[4]) >> 4;
      const u32 cx = ((s.h[i] + (s.c8 & u32(cp[5]))) & ((1u << cp[1]) - 1u))
                     * u32(cp[3]);
      u32* t = tab(s, m, i) + cx;
      const i32* x = p + cp[2];
      for (int j = s.k; j < cp[3]; j += s.G)
        t[j] = u32(clamp512k(i32(w[j]) + ((err * x[j] + (1 << 12)) >> 13)));
    } else {
      const u32 cx = s.cxt[i];
      const int j = int(cx & 31u);
      if (j % s.G == s.k)
        tab(s, m, i)[cx & ((32u << cp[1]) - 1u)] =
            trained(m, w[j], y, u32(cp[4]) * 4u);
    }
  }
}

// Phases (a) and (c), a policy of the kernels (template parameter Phases,
// see the header note): GenericPhases runs phase_a and phase_c;
// FastPhases<P> the model's struct PhasesFast from ops/phases_fast.py,
// which keeps its state from bit to bit (q). Both give the same
// predictions, table entries, rows and contexts.
struct GenericPhases {
  __device__ __forceinline__ void init(const Lane&, const Model&) {}
  __device__ __forceinline__ void a(Lane& s, const Model& m) {
    phase_a(s, m);
  }
  __device__ __forceinline__ void c(Lane& s, const Model& m, int y) {
    phase_c(s, m, y);
  }
};

template <class P>
struct FastPhases {
  P q;
  __device__ __forceinline__ void init(const Lane& s, const Model&) {
    q.init(s.k, s.sw, s.A8, s.A32);
  }
  __device__ __forceinline__ void a(Lane& s, const Model& m) {
    q.a(s.sw, s.A32, s.p, s.c8, s.hmap4, s.bit, m.st, m.dt2k);
  }
  __device__ __forceinline__ void c(Lane& s, const Model& m, int y) {
    q.c(s.sw, s.A32, s.p, s.c8, s.hmap4, y, m.sq, m.sns, m.dt);
  }
};

// MATCH at a byte's end: append the byte to the history, then find the
// length of the match at the hashed pointer, G positions per step.
__device__ __forceinline__ void match_byte_end(Lane& s, const Model& m,
                                               u32 byte) {
  for (int q = 0; q < m.nmatch; ++q) {
    const int i = m.matches[q];
    if (i % s.G != s.k) continue;
    const i32* cp = m.cp + i * NPAR;
    u8* ht = s.A8 + m.off8[i];
    const u32 mask = (1u << cp[2]) - 1u;
    uint4 r = s.row[i];
    ht[r.x & mask] = u8(byte);
    r.x = (r.x + 1) & mask;
    u32 search = 0;
    if (r.z == 0) {
      r.y = r.x - tab(s, m, i)[s.h[i] & ((1u << cp[1]) - 1u)];
      search = (r.y & mask) != 0;
    } else if (r.z < 255) {
      ++r.z;
    }
    s.row[i] = r;
    s.wa[i] = search;
  }
  gsync(s);
  for (int q = 0; q < m.nmatch; ++q) {
    const int i = m.matches[q];
    if (!s.wa[i]) continue;
    const u8* ht = s.A8 + m.off8[i];
    const u32 mask = (1u << m.cp[i * NPAR + 2]) - 1u;
    const u32 ml = s.row[i].x, mb = s.row[i].y;
    u32 len = 255;
    for (u32 base = 0; base < 255; base += u32(s.G)) {
      const u32 at = base + u32(s.k);
      const bool stop = at >= 255
          || ht[(ml - at - 1) & mask] != ht[(ml - at - mb - 1) & mask];
      const unsigned hit = (__ballot_sync(s.gmask, stop) >> s.gbase)
                           & (s.G == 32 ? ~0u : (1u << s.G) - 1u);
      if (hit) {
        len = base + u32(__ffs(int(hit)) - 1);
        break;
      }
    }
    if (i % s.G == s.k) s.row[i].z = len;
  }
  for (int q = 0; q < m.nmatch; ++q) {
    const int i = m.matches[q];
    if (i % s.G != s.k) continue;
    const i32* cp = m.cp + i * NPAR;
    const u8* ht = s.A8 + m.off8[i];
    uint4 r = s.row[i];
    tab(s, m, i)[s.h[i] & ((1u << cp[1]) - 1u)] = r.x;
    if (r.z) r.w = ht[(r.x - r.y) & ((1u << cp[2]) - 1u)];
    s.row[i] = r;
  }
}

// ZPAQL interpreter: libzpaq semantics (tzpaq.cpp VM::run, zpaql/vm.py).
// It dispatches with compares and selects, not switches: on one thread
// they cost less than a switch's indirect jump.
__device__ __forceinline__ void run_hcomp(Lane& s, const Model& m, u32 input) {
  const u8* code = m.code;
  const int n = m.hlen;
  u32* H = s.H;
  u8* M = s.M;
  u32 a = input, b = s.b, c = s.c, d = s.d, f = s.f;
  int pc = 0;
  int st = ST_OK;
  const u64 max_steps = m.max_steps;
  for (u64 steps = 0;; ++steps) {
    if (pc >= n || steps >= max_steps) { st = ST_ZPAQL; break; }
    // the next byte is read with the opcode (the bytecode is padded), so
    // that an operand costs no second dependent read
    const int op = code[pc++];
    const u32 arg = code[pc];
    if (op >= 64 && op != 255) {
      const int sss = op & 7;
      u32 v;
      if (sss < 4) {
        v = sss == 0 ? a : sss == 1 ? b : sss == 2 ? c : d;
      } else if (sss == 7) {
        if (pc >= n) { st = ST_ZPAQL; break; }
        v = arg;
        ++pc;
      } else {
        v = sss == 6 ? H[d & m.hmask] : M[(sss == 4 ? b : c) & m.mmask];
      }
      if (op < 128) {                                      // 01dddsss
        const int ddd = (op >> 3) & 7;                     // ddd 7: no-op
        a = ddd == 0 ? v : a;
        b = ddd == 1 ? v : b;
        c = ddd == 2 ? v : c;
        d = ddd == 3 ? v : d;
        if (ddd == 4) M[b & m.mmask] = u8(v);
        else if (ddd == 5) M[c & m.mmask] = u8(v);
        else if (ddd == 6) H[d & m.hmask] = v;
        continue;
      }
      const int alu = (op >> 3) & 15;                      // 1xxxxsss
      if (alu == 0) a += v;
      else if (alu == 2) a *= v;
      else if (alu == 5) a &= v;
      else if (alu == 1) a -= v;
      else if (alu == 9) a <<= (v & 31u);
      else if (alu == 11) f = a == v;
      else if (alu == 12) f = a < v;
      else if (alu == 13) f = a > v;
      else if (alu == 8) a ^= v;
      else if (alu == 7) a |= v;
      else if (alu == 6) a &= ~v;
      else if (alu == 10) a >>= (v & 31u);
      else if (alu == 3) a = v ? a / v : 0u;
      else if (alu == 4) a = v ? a % v : 0u;
      else { st = ST_ZPAQL; break; }
      continue;
    }
    if (op == 56) break;                                   // HALT
    if (op == 59) {                                        // HASH
      a = (a + M[b & m.mmask] + 512u) * 773u;
      continue;
    }
    if (op == 60) {                                        // HASHD
      u32& hd = H[d & m.hmask];
      hd = (hd + a + 512u) * 773u;
      continue;
    }
    if (op == 39 || op == 47 || op == 63) {                // JT, JF, JMP
      if (pc >= n) { st = ST_ZPAQL; break; }
      const bool jump = op == 63 || (op == 39) == (f != 0);
      pc += jump ? int((arg + 128) & 255) - 127 : 1;
      continue;
    }
    if (op == 255) {                                       // LJ
      if (pc + 1 >= n) { st = ST_ZPAQL; break; }
      pc = code[pc] + 256 * code[pc + 1];
      if (pc >= n) { st = ST_ZPAQL; break; }
      continue;
    }
    if (op == 55) {                                        // R=A n
      if (pc >= n) { st = ST_ZPAQL; break; }
      s.R[arg] = a;
      ++pc;
      continue;
    }
    if (op == 57) continue;                                // OUT (no-op)
    if (op == 0) { st = ST_ZPAQL; break; }                 // ERROR
    const int ddd = op >> 3, xxx = op & 7;                 // 00dddxxx
    if (xxx == 5 || xxx == 6 || (xxx == 7 && pc >= n)) {
      st = ST_ZPAQL;
      break;
    }
    // the operand's old value, for swap, ++, --, ~
    u32 old;
    if (ddd < 4) old = ddd == 0 ? a : ddd == 1 ? b : ddd == 2 ? c : d;
    else if (ddd == 6) old = H[d & m.hmask];
    else old = M[(ddd == 4 ? b : c) & m.mmask];
    u32 v;
    if (xxx == 0) v = a;                                   // swap with A
    else if (xxx == 1) v = old + 1u;
    else if (xxx == 2) v = old - 1u;
    else if (xxx == 3) v = ~old;
    else if (xxx == 4) v = 0u;
    else v = s.R[arg], ++pc;                               // ddd = R n
    if (xxx == 0) a = ddd == 4 || ddd == 5 ? (a & ~0xFFu) | (old & 0xFFu)
                                          : old;
    if (ddd == 0) a = xxx == 0 ? a : v;
    else if (ddd == 1) b = v;
    else if (ddd == 2) c = v;
    else if (ddd == 3) d = v;
    else if (ddd == 4) M[b & m.mmask] = u8(v);
    else if (ddd == 5) M[c & m.mmask] = u8(v);
    else if (ddd == 6) H[d & m.hmask] = v;
  }
  s.b = b;
  s.c = c;
  s.d = d;
  s.f = f;
  if (st != ST_OK) s.status = st;
}

// The HCOMP step at a byte's end, run by the group's thread 0: Interp
// interprets the bytecode over H and M and leaves the contexts in H, which
// the group copies into s.h; FastStep<P> runs the program P generated by
// ops/hcomp_fast.py (struct HcompFast) and writes s.h itself. Its window
// of the last 4 * P::words bytes (the most the program reads at c + k)
// lives in thread 0's registers: the program's offsets are compile-time
// constants, so a byte is pushed with one funnel shift a word and read
// with one shift and mask, where a window in shared memory would put a
// dependent shared-memory access on the chain for every read.
struct Interp {
  static constexpr bool fast = false;
  __device__ __forceinline__ void init() {}
  __device__ __forceinline__ void run(Lane& s, const Model& m, u32 byte) {
    run_hcomp(s, m, byte);
  }
};

template <class P>
struct FastStep {
  static constexpr bool fast = true;
  u32 w[P::words];
  u32 c;
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < P::words; ++k) w[k] = 0;   // M starts as zeros
    c = 0;
  }
  __device__ __forceinline__ void run(Lane& s, const Model&, u32 byte) {
    P::run(w, c, s.h, byte);
  }
};

// After phase (c): the bit's context update, and at a byte's end MATCH's
// search, HCOMP on thread 0 and the new context hashes (the group in step
// after it); s.status is the group's.
template <class Step>
__device__ __forceinline__ void tail(Lane& s, const Model& m, Step& step,
                                     int y) {
  s.c8 += s.c8 + u32(y);
  ++s.bit;
  if (s.c8 >= 256) {
    mark(s, P_TAIL);
    if (m.nmatch) match_byte_end(s, m, s.c8 - 256);
    // FastStep writes s.h in place: every thread is done reading this
    // byte's contexts (phase (c)'s rows, MATCH's pointer) first
    if (Step::fast) gsync(s);
    mark(s, P_MATCH);
    if (s.k == 0) {
      step.run(s, m, s.c8 - 256);
      s.misc[2] = u32(s.status);
    }
    mark(s, P_HCOMP);
    gsync(s);
    s.status = int(s.misc[2]);
    if (!Step::fast)
      for (int i = s.k; i < m.n; i += s.G) s.h[i] = s.H[i & m.hmask];
    if (s.prof) ++s.acc[P_BYTES];
    gsync(s);
    mark(s, P_HASH);
    s.hmap4 = 1;
    s.c8 = 1;
    s.bit = 0;
  } else if (s.c8 >= 16 && s.c8 < 32) {
    s.hmap4 = (s.hmap4 & 0xfu) << 5 | u32(y) << 4 | 1u;
  } else {
    s.hmap4 = (s.hmap4 & 0x1f0u) | (((s.hmap4 & 0xfu) * 2u + u32(y)) & 0xfu);
  }
  mark(s, P_TAIL);
}

// One coded bit of the lane, whose phase (a) has run: the combine
// (``Combine``) and coder step on thread 0 (``coder(pr)`` returns the bit
// and may set s.status), phase (c) (``ph``), the tail, and phase (a) of the
// next bit, which overlaps other threads' phase (c): the predictions swap
// buffers every bit, and each thread reads back only the table entries and
// row copies it wrote itself. Returns the bit; s.status is the group's.
template <class Combine, class Step, class Phases, class Coder>
__device__ __forceinline__ int code_bit(Lane& s, const Model& m, Step& step,
                                        Phases& ph, Coder&& coder) {
  gsync(s);
  mark(s, P_WAIT_A);
  if (s.k == 0) {
    const u32 pr = u32(Combine::run(s, m)) * 2u + 1u;
    const int y = s.status == ST_OK ? coder(pr) : 0;
    s.misc[0] = u32(y);
    s.misc[1] = u32(s.status);
  }
  mark(s, P_B);
  gsync(s);
  mark(s, P_WAIT_B);
  const int y = int(s.misc[0]);
  s.status = int(s.misc[1]);
  if (s.status != ST_OK) return y;
  if (s.prof) ++s.acc[P_BITS];
  ph.c(s, m, y);
  mark(s, P_C);
  tail(s, m, step, y);
  i32* p = s.p;
  s.p = s.pn;
  s.pn = p;
  ph.a(s, m);
  mark(s, P_A);
  return y;
}

// The lane kernels' common arguments: the model (component table, its
// placement, u8 and u32 table offsets, HCOMP bytecode, H and M sizes, the
// interpreter's step limit), the group size and lanes per block, the lane
// region's geometry, the LUT, the lanes' input spans, their state (u8 and
// u32 arenas with per-lane strides, H, M: unused by FastStep) and their
// output spans, lengths and status codes.
#define CM_LANE_PARAMS                                                       \
  const i32 *__restrict__ comps, const i32 *__restrict__ cplan,              \
      const i64 *__restrict__ off8, const i64 *__restrict__ off32, int n,    \
      const u8 *__restrict__ hcomp, int hlen, int hh, int hm,                \
      u64 max_steps, int G, int lpb, int lane_words,                         \
      const i32 *__restrict__ geo,                                           \
      const i32 *__restrict__ lut, const u8 *__restrict__ in,                \
      const i64 *__restrict__ in_off, const i64 *__restrict__ in_len,        \
      u8 *a8, i64 s8, u32 *a32, i64 s32, u32 *hmem, u8 *mmem, u32 *rmem,     \
      u8 *out,                                                               \
      const i64 *__restrict__ out_off, const i64 *__restrict__ out_cap,      \
      i64 *out_len, i32 *status, long long *prof, long long *stamps, int L

// Copies the LUTs and the model into the block's header in shared memory
// and returns it. Every thread of the block calls it (it ends in
// __syncthreads).
__device__ __forceinline__ Model load_model(unsigned char* smem,
                                            const i32* comps,
                                            const i32* cplan,
                                            const i64* off8,
                                            const i64* off32, int n,
                                            const u8* hcomp, int hlen,
                                            int hh, int hm, u64 max_steps,
                                            const i32* lut) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  short* s_sq = reinterpret_cast<short*>(smem);
  u8* s_sns = reinterpret_cast<u8*>(s_sq + 4096);
  short* s_st = reinterpret_cast<short*>(s_sns + 1024);
  u32* s_dt = reinterpret_cast<u32*>(s_st + 16384);
  short* s_dt2k = reinterpret_cast<short*>(s_dt + 1024);
  int4* s_comb = reinterpret_cast<int4*>(s_dt2k + 256);
  i64* s_off8 = reinterpret_cast<i64*>(s_comb + n);
  i64* s_off32 = s_off8 + n;
  i32* s_cp = reinterpret_cast<i32*>(s_off32 + n);
  i32* s_plan = s_cp + n * NPAR;
  i32* s_rows = s_plan + n * NPLAN;
  i32* s_match = s_rows + n;
  i32* s_count = s_match + n;
  u8* s_code = reinterpret_cast<u8*>(s_count + 3);
  for (int k = t; k < 4096; k += T) s_sq[k] = short(lut[SQ_OFF + k]);
  for (int k = t; k < 1024; k += T) s_sns[k] = u8(lut[SNS_OFF + k]);
  for (int k = t; k < 16384; k += T) s_st[k] = short(lut[STR_OFF + k]);
  for (int k = t; k < 1024; k += T)
    s_dt[k] = ((1u << 17) / (2u * u32(k) + 3u)) * 2u;
  for (int k = t; k < 256; k += T) s_dt2k[k] = short(k ? 2048 / k : 0);
  for (int k = t; k < n; k += T) {
    s_off8[k] = off8[k];
    s_off32[k] = off32[k];
  }
  for (int k = t; k < n * NPAR; k += T) s_cp[k] = comps[k];
  for (int k = t; k < n * NPLAN; k += T) s_plan[k] = cplan[k];
  for (int k = t; k <= hlen; k += T) s_code[k] = k < hlen ? hcomp[k] : 0;
  if (t == 0) {
    int nr = 0, nm = 0, nc = 0;
    for (int i = 0; i < n; ++i) {
      const int ty = comps[i * NPAR];
      if (ty == MIX || ty == SSE) s_rows[nr++] = i;
      if (ty == MATCH) s_match[nm++] = i;
      const i32* cp = comps + i * NPAR;
      if (ty != CONS && ty != CM && ty != ICM && ty != MATCH)
        s_comb[nc++] = make_int4(
            i | ty << 16, ty == AVG ? cp[1] : cp[2],
            ty == AVG ? cp[2] : cp[3],
            ty == AVG ? cp[3] : cplan[i * NPLAN + CP_RS]);
    }
    s_count[0] = nr;
    s_count[1] = nm;
    s_count[2] = nc;
  }
  __syncthreads();
  Model m;
  m.sq = s_sq;
  m.sns = s_sns;
  m.st = s_st;
  m.dt = s_dt;
  m.dt2k = s_dt2k;
  m.off8 = s_off8;
  m.off32 = s_off32;
  m.cp = s_cp;
  m.plan = s_plan;
  m.rows = s_rows;
  m.matches = s_match;
  m.combine = s_comb;
  m.nrows = s_count[0];
  m.nmatch = s_count[1];
  m.ncombine = s_count[2];
  m.code = s_code;
  m.n = n;
  m.hlen = hlen;
  m.hmask = (1u << hh) - 1u;
  m.mmask = (1u << hm) - 1u;
  m.max_steps = max_steps;
  return m;
}

// Binds this thread to its lane's group and shared region; the group zeroes
// the region and copies its shared tables' initial contents from the
// lane's device arena, then sets up the phases (``ph``) and runs phase (a)
// of the first bit. Returns false for a thread past the last lane.
// prof (or null) receives NPROF clock counters per lane, stamps (or null)
// each lane's start here and end (save_stamp) on the global timer.
template <class Phases>
__device__ __forceinline__ bool init_lane(Lane& s, Phases& ph,
                                          const Model& m,
                                          unsigned char* smem, int G,
                                          int lpb, int lane_words,
                                          const i32* geo, int L, u8* a8,
                                          i64 s8, u32* a32, i64 s32,
                                          u32* hmem, u8* mmem, u32* rmem,
                                          int hh, int hm, long long* prof,
                                          long long* stamps, int* lane_out) {
  const int gi = threadIdx.x / G;
  const int lane = blockIdx.x * lpb + gi;
  if (lane >= L) return false;
  s.k = threadIdx.x % G;
  s.G = G;
  s.gbase = (threadIdx.x & 31) / G * G;
  s.gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << s.gbase;
  u32* sw = reinterpret_cast<u32*>(smem + header_bytes(m.n, m.hlen))
            + i64(gi) * lane_words;
  s.sw = sw;
  s.h = sw + geo[G_H];
  s.p = reinterpret_cast<i32*>(sw + geo[G_P]);
  s.pn = s.p + m.n;
  s.cxt = sw + geo[G_CXT];
  s.wa = sw + geo[G_WA];
  s.wb = sw + geo[G_WB];
  s.rowat = sw + geo[G_ROWAT];
  s.row = reinterpret_cast<uint4*>(sw + geo[G_ROW]);
  s.R = rmem + i64(lane) * 256;
  s.misc = sw + geo[G_MISC];
  s.A8 = a8 + i64(lane) * s8;
  s.A32 = a32 + i64(lane) * s32;
  s.H = geo[G_HT] >= 0 ? sw + geo[G_HT] : hmem + (i64(lane) << hh);
  s.M = mmem + (i64(lane) << hm);
  for (int w = s.k; w < lane_words; w += G) sw[w] = 0;
  gsync(s);
  for (int i = 0; i < m.n; ++i) {
    const int sh = m.plan[i * NPLAN + CP_SH32];
    if (sh < 0) continue;
    const int sz = m.plan[i * NPLAN + CP_SZ32];
    const u32* src = s.A32 + m.off32[i];
    for (int w = s.k; w < sz; w += G) sw[sh + w] = src[w];
  }
  gsync(s);
  s.status = ST_OK;
  s.c8 = 1;
  s.hmap4 = 1;
  s.bit = 0;
  s.b = s.c = s.d = s.f = 0;
  s.prof = prof && s.k == 0 ? prof + i64(lane) * NPROF : nullptr;
  for (int k = 0; k < NPROF; ++k) s.acc[k] = 0;
  s.t = clock64();
  s.stamp = stamps && s.k == 0 ? stamps + 2 * i64(lane) : nullptr;
  if (s.stamp) s.stamp[0] = globaltimer();
  *lane_out = lane;
  ph.init(s, m);
  ph.a(s, m);
  mark(s, P_A);
  return true;
}

// writes a profiled lane's counters
__device__ __forceinline__ void save_profile(const Lane& s) {
  if (s.prof)
    for (int k = 0; k < NPROF; ++k) s.prof[k] = s.acc[k];
}

// writes a stamped lane's end
__device__ __forceinline__ void save_stamp(const Lane& s) {
  if (s.stamp) s.stamp[1] = globaltimer();
}

typedef void (*LaneKernel)(CM_LANE_PARAMS);

// Launches a lane kernel over L lanes on the stream, lpb lanes of G threads
// in each of ``blocks`` blocks (ops/cm_model.py Placement); returns a CUDA
// error code (0 when the launch was accepted).
inline int launch_lanes(LaneKernel kernel, const void* comps,
                        const void* cplan, const void* off8,
                        const void* off32, int n, const void* hcomp, int hlen,
                        int hh, int hm, u64 max_steps, int G, int lpb,
                        int blocks,
                        int lane_words, const void* geo, const void* lut,
                        const void* in,
                        const void* in_off, const void* in_len, void* a8,
                        long long s8, void* a32, long long s32, void* hmem,
                        void* mmem, void* rmem, void* out, const void* out_off,
                        const void* out_cap, void* out_len, void* status,
                        void* prof, void* stamps, int L, void* stream) {
  const long long smem =
      header_bytes(n, hlen) + (long long)lpb * lane_words * 4;
  if (n < 1 || n > MAXC || G < 1 || G > 32 || (G & (G - 1)) || lpb < 1
      || lpb * G > MAX_BLOCK_THREADS || lane_words < 1 || lane_words % 4
      || L < 1
      || (long long)blocks * lpb < L || (long long)(blocks - 1) * lpb >= L
      || smem > SMEM_LIMIT || s8 % 16)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, lpb * G, size_t(smem), (cudaStream_t)stream>>>(
      (const i32*)comps, (const i32*)cplan, (const i64*)off8,
      (const i64*)off32, n, (const u8*)hcomp, hlen, hh, hm, max_steps, G,
      lpb,
      lane_words, (const i32*)geo, (const i32*)lut, (const u8*)in,
      (const i64*)in_off, (const i64*)in_len, (u8*)a8, s8, (u32*)a32, s32,
      (u32*)hmem, (u8*)mmem, (u32*)rmem, (u8*)out, (const i64*)out_off,
      (const i64*)out_cap, (i64*)out_len, (i32*)status, (long long*)prof,
      (long long*)stamps, L);
  return (int)cudaGetLastError();
}

}  // namespace
