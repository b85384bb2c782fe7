// ZPAQ context-mixing model shared by the CM lane decoder (cm_decode.cu) and
// encoder (cm_encode.cu) for Hopper (sm_90a): the predictor, its update and
// HCOMP's ZPAQL interpreter, with the lane kernels' common set-up and launch.
//
// Replaces the model half of zpaqfranz_tpu/ops/codec_arena.py (ArenaCoder:
// byte_step's _probe_all, _bit and _byte_end) together with its HCOMP step
// (ops/hcomp_fast.py FastHcomp.run, fallback ops/vm_batched.py
// BatchedVM.run). Only the range coder differs between the two kernels.
//
// Design: one lane (one ZPAQ d block) per thread, the whole block in one
// launch. Per-lane model state lives in device memory in the arena layout of
// codec_arena._Layout: a u8 arena (ICM/ISSE hash rows, MATCH history) and a
// u32 arena (CM/ICM/SSE counters, ISSE/MIX/MIX2 weights, MATCH pointers),
// plus HCOMP's H (2^hh u32) and M (2^hm u8). The model's component list,
// arena offsets and HCOMP bytecode are copied into shared memory at launch,
// next to each lane's small arrays (context hashes, predictions, match
// registers, ZPAQL R). HCOMP runs through a full ZPAQL interpreter (every
// opcode, jumps and LJ included).
//
// Component semantics follow the scalar engine native/src/tzpaq.cpp
// (Predictor::find, predict_generic, train, update_generic, update_tail),
// which is byte-identical to the arena engine.
//
// Bound: each coded bit is a chain of dependent loads (hash row, counter,
// stretch/squash LUT) in one thread, so a lane runs at memory latency, far
// below the card's 3.35 TB/s. Parallelism comes only from lanes (d blocks in
// flight). Redesigning for one lane per warp with components across threads
// is later work.

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
constexpr int NPAR = 6;   // comp params: type p1..p5
// A HCOMP run that executes more instructions than this for one byte is
// taken as a runaway program: the lane fails instead of holding the card.
constexpr u32 MAX_HCOMP_STEPS = 1u << 24;

// Per-lane arrays live in shared memory, interleaved across the block's
// threads (element k of thread t at [k * T + t]) so that the lanes of one
// warp touch distinct banks. The pointers are already offset by t.
struct Arr {
  u32* h_;      // context hashes from HCOMP
  i32* p_;      // component predictions (stretched)
  u32* cxt_;    // per-component context / table index
  u32* row_;    // ICM/ISSE: byte offset of the selected hash row
  u32* ma_;     // MATCH: match length
  u32* mb_;     // MATCH: match offset
  u32* ml_;     // MATCH: history position
  u32* mbit_;   // MATCH: bit count inside the byte
  u32* mc_;     // MATCH: predicted bit
  u32* r_;      // ZPAQL R registers (256)
  int T;
  __device__ __forceinline__ u32& h(int i) const { return h_[i * T]; }
  __device__ __forceinline__ i32& p(int i) const { return p_[i * T]; }
  __device__ __forceinline__ u32& cxt(int i) const { return cxt_[i * T]; }
  __device__ __forceinline__ u32& row(int i) const { return row_[i * T]; }
  __device__ __forceinline__ u32& ma(int i) const { return ma_[i * T]; }
  __device__ __forceinline__ u32& mb(int i) const { return mb_[i * T]; }
  __device__ __forceinline__ u32& ml(int i) const { return ml_[i * T]; }
  __device__ __forceinline__ u32& mbit(int i) const { return mbit_[i * T]; }
  __device__ __forceinline__ u32& mc(int i) const { return mc_[i * T]; }
  __device__ __forceinline__ u32& r(int i) const { return r_[i * T]; }
};

// words of per-lane shared memory for a model with n components
__host__ __device__ constexpr int lane_words(int n) { return 9 * n + 256; }

// One lane's predictor and ZPAQL registers; the coder keeps its own state.
struct Pred {
  int status;
  u32 c8, hmap4;
  u32 a, b, c, d, f;
  Arr x;
};

struct Shared {
  const i32* cp;      // n * NPAR
  const i64* off8;    // n
  const i64* off32;   // n
  const u8* code;     // hcomp bytecode
  int n, hlen;
  u32 hmask, mmask;
};

// One lane's model state in device memory.
struct Mem {
  u8* A8;
  u32* A32;
  u32* H;
  u8* M;
};

__device__ __forceinline__ int clamp2k(int x) {
  return x < -2048 ? -2048 : (x > 2047 ? 2047 : x);
}
__device__ __forceinline__ int clamp512k(int x) {
  return x < -(1 << 19) ? -(1 << 19) : (x > (1 << 19) - 1 ? (1 << 19) - 1 : x);
}

// ICM/ISSE hash probe: 16-byte rows, candidates h0, h0^16, h0^32, check
// byte at row+0, priority = state byte at row+1, replace the lowest.
__device__ __forceinline__ u32 find(u8* ht, int sizebits, u64 size, u32 cx) {
  u32 chk = (cx >> sizebits) & 255u;
  u64 h0 = u64(cx * 16u) & (size - 16);
  if (ht[h0] == chk) return u32(h0);
  u64 h1 = h0 ^ 16;
  if (ht[h1] == chk) return u32(h1);
  u64 h2 = h0 ^ 32;
  if (ht[h2] == chk) return u32(h2);
  u64 hx;
  if (ht[h0 + 1] <= ht[h1 + 1] && ht[h0 + 1] <= ht[h2 + 1]) hx = h0;
  else if (ht[h1 + 1] < ht[h2 + 1]) hx = h1;
  else hx = h2;
  // byte stores: a lane's arena stride need not be a multiple of 16
  ht[hx] = u8(chk);
#pragma unroll
  for (int k = 1; k < 16; ++k) ht[hx + k] = 0;
  return u32(hx);
}

__device__ __forceinline__ void train(u32* slot, int y, u32 limit) {
  u32 pn = *slot;
  u32 count = pn & 1023u;
  int error = y * 32767 - int(pn >> 17);
  u32 dt = ((1u << 17) / (count * 2u + 3u)) * 2u;
  pn += (u32(error) * dt) & 0xFFFFFC00u;
  pn += count < limit;
  *slot = pn;
}

// P(next bit = 1) in 1/4096 units; the coders split at predict() * 2 + 1.
__device__ __forceinline__ int predict(Pred& s, const Shared& m,
                                       const i32* lut, const Mem& g) {
  const int n = m.n;
  u8* A8 = g.A8;
  u32* A32 = g.A32;
  for (int i = 0; i < n; ++i) {
    const i32* cp = m.cp + i * NPAR;
    const int t = cp[0];
    switch (t) {
      case CONS:
        s.x.p(i) = (cp[1] - 128) * 4;
        break;
      case CM: {
        u32* cm = A32 + m.off32[i];
        s.x.cxt(i) = (s.x.h(i) ^ s.hmap4) & ((1u << cp[1]) - 1u);
        s.x.p(i) = lut[STR_OFF + (cm[s.x.cxt(i)] >> 17)];
        break;
      }
      case ICM: {
        u8* ht = A8 + m.off8[i];
        if (s.c8 == 1 || (s.c8 & 0xf0) == 16)
          s.x.row(i) = find(ht, cp[1] + 2, u64(64) << cp[1], s.x.h(i) + 16u * s.c8);
        s.x.cxt(i) = ht[s.x.row(i) + (s.hmap4 & 15)];
        s.x.p(i) = lut[STR_OFF + (A32[m.off32[i] + s.x.cxt(i)] >> 8)];
        break;
      }
      case MATCH: {
        if (s.x.ma(i) == 0) {
          s.x.p(i) = 0;
        } else {
          u8* ht = A8 + m.off8[i];
          u32 mask = (1u << cp[2]) - 1u;
          s.x.mc(i) = (ht[(s.x.ml(i) - s.x.mb(i)) & mask] >> (7 - s.x.mbit(i))) & 1u;
          int dt2k = 2048 / int(s.x.ma(i));
          s.x.p(i) = lut[STR_OFF + ((dt2k * (int(s.x.mc(i)) * -2 + 1)) & 32767)];
        }
        break;
      }
      case AVG:
        s.x.p(i) = (s.x.p(cp[1]) * cp[3] + s.x.p(cp[2]) * (256 - cp[3])) >> 8;
        break;
      case MIX2: {
        s.x.cxt(i) = (s.x.h(i) + (s.c8 & u32(cp[5]))) & ((1u << cp[1]) - 1u);
        int w = int(A32[m.off32[i] + s.x.cxt(i)]);
        s.x.p(i) = (w * s.x.p(cp[2]) + (65536 - w) * s.x.p(cp[3])) >> 16;
        break;
      }
      case MIX: {
        const int mm = cp[3];
        s.x.cxt(i) = ((s.x.h(i) + (s.c8 & u32(cp[5]))) & ((1u << cp[1]) - 1u))
                   * u32(mm);
        const u32* wt = A32 + m.off32[i] + s.x.cxt(i);
        int sum = 0;
        for (int j = 0; j < mm; ++j)
          sum += (i32(wt[j]) >> 8) * s.x.p(cp[2] + j);
        s.x.p(i) = clamp2k(sum >> 8);
        break;
      }
      case ISSE: {
        u8* ht = A8 + m.off8[i];
        if (s.c8 == 1 || (s.c8 & 0xf0) == 16)
          s.x.row(i) = find(ht, cp[1] + 2, u64(64) << cp[1], s.x.h(i) + 16u * s.c8);
        s.x.cxt(i) = ht[s.x.row(i) + (s.hmap4 & 15)];
        const u32* wt = A32 + m.off32[i] + s.x.cxt(i) * 2;
        s.x.p(i) = clamp2k((i32(wt[0]) * s.x.p(cp[2]) + i32(wt[1]) * 64) >> 16);
        break;
      }
      case SSE: {
        const u32* cm = A32 + m.off32[i];
        const u32 mask = (32u << cp[1]) - 1u;
        u32 cx = (s.x.h(i) + s.c8) * 32u;
        int pq = s.x.p(cp[2]) + 992;
        if (pq < 0) pq = 0;
        if (pq > 1983) pq = 1983;
        int wt = pq & 63;
        pq >>= 6;
        cx += u32(pq);
        int v = (int(cm[cx & mask] >> 10) * (64 - wt)
                 + int(cm[(cx + 1) & mask] >> 10) * wt) >> 13;
        s.x.p(i) = lut[STR_OFF + v];
        s.x.cxt(i) = cx + u32(wt >> 5);
        break;
      }
      default:
        s.status = ST_CORRUPT;
        return 0;
    }
  }
  return lut[SQ_OFF + s.x.p(n - 1) + 2048];
}

// ZPAQL interpreter: libzpaq semantics (tzpaq.cpp VM::run, zpaql/vm.py)
__device__ __forceinline__ void run_hcomp(Pred& s, const Shared& m, u32* H,
                                          u8* M, u32 input) {
  const u8* code = m.code;
  const int n = m.hlen;
  s.a = input;
  int pc = 0;
  for (u32 steps = 0;; ++steps) {
    if (pc >= n || steps >= MAX_HCOMP_STEPS) { s.status = ST_ZPAQL; return; }
    const int op = code[pc++];
    switch (op) {
      case 56: return;                                     // HALT
      case 0: s.status = ST_ZPAQL; return;                 // ERROR
      case 255:                                            // LJ
        if (pc + 1 >= n) { s.status = ST_ZPAQL; return; }
        pc = code[pc] + 256 * code[pc + 1];
        if (pc >= n) { s.status = ST_ZPAQL; return; }
        continue;
      case 39:                                             // JT
        if (pc >= n) { s.status = ST_ZPAQL; return; }
        pc += s.f ? ((code[pc] + 128) & 255) - 127 : 1;
        continue;
      case 47:                                             // JF
        if (pc >= n) { s.status = ST_ZPAQL; return; }
        pc += s.f ? 1 : ((code[pc] + 128) & 255) - 127;
        continue;
      case 63:                                             // JMP
        if (pc >= n) { s.status = ST_ZPAQL; return; }
        pc += ((code[pc] + 128) & 255) - 127;
        continue;
      case 55:                                             // R=A n
        if (pc >= n) { s.status = ST_ZPAQL; return; }
        s.x.r(code[pc++]) = s.a;
        continue;
      case 57: continue;                                   // OUT (no-op)
      case 59:                                             // HASH
        s.a = (s.a + M[s.b & m.mmask] + 512u) * 773u;
        continue;
      case 60: {                                           // HASHD
        u32& hd = H[s.d & m.hmask];
        hd = (hd + s.a + 512u) * 773u;
        continue;
      }
      default: break;
    }
    u32 imm = 0;
    const int sss = op & 7;
    if (op >= 64 && sss == 7) {
      if (pc >= n) { s.status = ST_ZPAQL; return; }
      imm = code[pc++];
    }
    auto get = [&](int k) -> u32 {
      switch (k) {
        case 0: return s.a;
        case 1: return s.b;
        case 2: return s.c;
        case 3: return s.d;
        case 4: return M[s.b & m.mmask];
        case 5: return M[s.c & m.mmask];
        case 6: return H[s.d & m.hmask];
        default: return imm;
      }
    };
    auto set = [&](int k, u32 v) {
      switch (k) {
        case 0: s.a = v; break;
        case 1: s.b = v; break;
        case 2: s.c = v; break;
        case 3: s.d = v; break;
        case 4: M[s.b & m.mmask] = u8(v); break;
        case 5: M[s.c & m.mmask] = u8(v); break;
        case 6: H[s.d & m.hmask] = v; break;
        default: break;
      }
    };
    if (op < 64) {                                         // 00dddxxx
      const int ddd = op >> 3, xxx = op & 7;
      switch (xxx) {
        case 0: {                                          // swap with A
          u32 v = get(ddd);
          if (ddd == 4 || ddd == 5) {
            set(ddd, s.a);
            s.a = (s.a & ~0xFFu) | (v & 0xFFu);
          } else {
            set(ddd, s.a);
            s.a = v;
          }
          break;
        }
        case 1: set(ddd, get(ddd) + 1u); break;
        case 2: set(ddd, get(ddd) - 1u); break;
        case 3: set(ddd, ~get(ddd)); break;
        case 4: set(ddd, 0u); break;
        case 7:                                            // ddd = R n
          if (pc >= n) { s.status = ST_ZPAQL; return; }
          set(ddd, s.x.r(code[pc++]));
          break;
        default: s.status = ST_ZPAQL; return;
      }
    } else if (op < 128) {                                 // 01dddsss
      set((op >> 3) & 7, get(sss));                        // ddd 7: no-op
    } else {                                               // 1xxxxsss
      const u32 v = get(sss);
      switch ((op >> 3) & 15) {
        case 0: s.a += v; break;
        case 1: s.a -= v; break;
        case 2: s.a *= v; break;
        case 3: s.a = v ? s.a / v : 0u; break;
        case 4: s.a = v ? s.a % v : 0u; break;
        case 5: s.a &= v; break;
        case 6: s.a &= ~v; break;
        case 7: s.a |= v; break;
        case 8: s.a ^= v; break;
        case 9: s.a <<= (v & 31u); break;
        case 10: s.a >>= (v & 31u); break;
        case 11: s.f = (s.a == v); break;
        case 12: s.f = (s.a < v); break;
        case 13: s.f = (s.a > v); break;
        default: s.status = ST_ZPAQL; return;
      }
    }
  }
}

__device__ __forceinline__ void update(Pred& s, const Shared& m,
                                       const i32* lut, const Mem& g, int y) {
  const int n = m.n;
  u8* A8 = g.A8;
  u32* A32 = g.A32;
  for (int i = 0; i < n; ++i) {
    const i32* cp = m.cp + i * NPAR;
    switch (cp[0]) {
      case CM:
        train(A32 + m.off32[i] + s.x.cxt(i), y, u32(cp[2]) * 4u);
        break;
      case ICM: {
        u8* ht = A8 + m.off8[i];
        u64 idx = s.x.row(i) + (s.hmap4 & 15);
        ht[idx] = u8(lut[SNS_OFF + ht[idx] * 4 + y]);
        u32* pn = A32 + m.off32[i] + s.x.cxt(i);
        *pn += u32((y * 32767 - int(*pn >> 8)) >> 2);
        break;
      }
      case MATCH: {
        u8* ht = A8 + m.off8[i];
        u32* cm = A32 + m.off32[i];
        const u32 mask = (1u << cp[2]) - 1u;
        const u32 cmmask = (1u << cp[1]) - 1u;
        if (int(s.x.mc(i)) != y) s.x.ma(i) = 0;
        u8& cur = ht[s.x.ml(i) & mask];
        cur = u8(cur * 2 + y);
        if (++s.x.mbit(i) == 8) {
          s.x.mbit(i) = 0;
          s.x.ml(i) = (s.x.ml(i) + 1) & mask;
          if (s.x.ma(i) == 0) {
            s.x.mb(i) = s.x.ml(i) - cm[s.x.h(i) & cmmask];
            if (s.x.mb(i) & mask)
              while (s.x.ma(i) < 255 &&
                     ht[(s.x.ml(i) - s.x.ma(i) - 1) & mask] ==
                         ht[(s.x.ml(i) - s.x.ma(i) - s.x.mb(i) - 1) & mask])
                ++s.x.ma(i);
          } else if (s.x.ma(i) < 255) {
            ++s.x.ma(i);
          }
          cm[s.x.h(i) & cmmask] = s.x.ml(i);
        }
        break;
      }
      case MIX2: {
        int err = ((y * 32767 - lut[SQ_OFF + s.x.p(i) + 2048]) * cp[4]) >> 5;
        u32* slot = A32 + m.off32[i] + s.x.cxt(i);
        int w = int(*slot) + ((err * (s.x.p(cp[2]) - s.x.p(cp[3])) + (1 << 12))
                              >> 13);
        if (w < 0) w = 0;
        if (w > 65535) w = 65535;
        *slot = u32(w);
        break;
      }
      case MIX: {
        const int mm = cp[3];
        int err = ((y * 32767 - lut[SQ_OFF + s.x.p(i) + 2048]) * cp[4]) >> 4;
        u32* wt = A32 + m.off32[i] + s.x.cxt(i);
        for (int j = 0; j < mm; ++j)
          wt[j] = u32(clamp512k(i32(wt[j])
                                + ((err * s.x.p(cp[2] + j) + (1 << 12)) >> 13)));
        break;
      }
      case ISSE: {
        int err = y * 32767 - lut[SQ_OFF + s.x.p(i) + 2048];
        u32* wt = A32 + m.off32[i] + s.x.cxt(i) * 2;
        wt[0] = u32(clamp512k(i32(wt[0])
                              + ((err * s.x.p(cp[2]) + (1 << 12)) >> 13)));
        wt[1] = u32(clamp512k(i32(wt[1]) + ((err + 16) >> 5)));
        u8* ht = A8 + m.off8[i];
        ht[s.x.row(i) + (s.hmap4 & 15)] = u8(lut[SNS_OFF + s.x.cxt(i) * 4 + y]);
        break;
      }
      case SSE:
        train(A32 + m.off32[i] + (s.x.cxt(i) & ((32u << cp[1]) - 1u)), y,
              u32(cp[4]) * 4u);
        break;
      default:
        break;
    }
  }
  // update_tail
  s.c8 += s.c8 + u32(y);
  if (s.c8 >= 256) {
    run_hcomp(s, m, g.H, g.M, s.c8 - 256);
    s.hmap4 = 1;
    s.c8 = 1;
    for (int i = 0; i < n; ++i) s.x.h(i) = g.H[i & m.hmask];
  } else if (s.c8 >= 16 && s.c8 < 32) {
    s.hmap4 = (s.hmap4 & 0xfu) << 5 | u32(y) << 4 | 1u;
  } else {
    s.hmap4 = (s.hmap4 & 0x1f0u) | (((s.hmap4 & 0xfu) * 2u + u32(y)) & 0xfu);
  }
}

// The lane kernels' common arguments: the model (component table, arena
// offsets, HCOMP bytecode, H and M sizes), the LUT, the lanes' input spans,
// their state (u8 and u32 arenas with per-lane strides, H, M) and their
// output spans, lengths and status codes.
#define CM_LANE_PARAMS                                                       \
  const i32 *__restrict__ comps, const i64 *__restrict__ off8,               \
      const i64 *__restrict__ off32, int n, const u8 *__restrict__ hcomp,    \
      int hlen, int hh, int hm, const i32 *__restrict__ lut,                 \
      const u8 *__restrict__ in, const i64 *__restrict__ in_off,             \
      const i64 *__restrict__ in_len, u8 *a8, i64 s8, u32 *a32, i64 s32,     \
      u32 *hmem, u8 *mmem, u8 *out, const i64 *__restrict__ out_off,         \
      const i64 *__restrict__ out_cap, i64 *out_len, i32 *status, int L

// Copies the model into shared memory and returns it. Every thread of the
// block calls it (it ends in __syncthreads); *lanes is set to the block's
// interleaved per-lane arrays.
__device__ __forceinline__ Shared load_shared(unsigned char* smem,
                                              const i32* comps,
                                              const i64* off8,
                                              const i64* off32, int n,
                                              const u8* hcomp, int hlen,
                                              int hh, int hm, u32** lanes) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  i64* s_off8 = reinterpret_cast<i64*>(smem);
  i64* s_off32 = s_off8 + n;
  i32* s_cp = reinterpret_cast<i32*>(s_off32 + n);
  u32* s_lane = reinterpret_cast<u32*>(s_cp + n * NPAR);
  u8* s_code = reinterpret_cast<u8*>(s_lane + lane_words(n) * T);
  for (int k = t; k < n; k += T) {
    s_off8[k] = off8[k];
    s_off32[k] = off32[k];
  }
  for (int k = t; k < n * NPAR; k += T) s_cp[k] = comps[k];
  for (int k = t; k < hlen; k += T) s_code[k] = hcomp[k];
  __syncthreads();
  *lanes = s_lane;
  Shared m;
  m.cp = s_cp;
  m.off8 = s_off8;
  m.off32 = s_off32;
  m.code = s_code;
  m.n = n;
  m.hlen = hlen;
  m.hmask = (1u << hh) - 1u;
  m.mmask = (1u << hm) - 1u;
  return m;
}

// Fresh predictor state of this thread's lane: its interleaved arrays bound
// and zeroed, registers reset.
__device__ __forceinline__ void init_pred(Pred& s, u32* lanes, int n) {
  const int T = blockDim.x;
  u32* base = lanes + threadIdx.x;
  s.x.T = T;
  s.x.h_ = base;
  s.x.p_ = reinterpret_cast<i32*>(base + 1 * n * T);
  s.x.cxt_ = base + 2 * n * T;
  s.x.row_ = base + 3 * n * T;
  s.x.ma_ = base + 4 * n * T;
  s.x.mb_ = base + 5 * n * T;
  s.x.ml_ = base + 6 * n * T;
  s.x.mbit_ = base + 7 * n * T;
  s.x.mc_ = base + 8 * n * T;
  s.x.r_ = base + 9 * n * T;
  for (int k = 0; k < lane_words(n); ++k) base[k * T] = 0;
  s.status = ST_OK;
  s.c8 = 1;
  s.hmap4 = 1;
  s.a = s.b = s.c = s.d = s.f = 0;
}

__device__ __forceinline__ Mem lane_mem(int lane, u8* a8, i64 s8, u32* a32,
                                        i64 s32, u32* hmem, u8* mmem, int hh,
                                        int hm) {
  Mem g;
  g.A8 = a8 + i64(lane) * s8;
  g.A32 = a32 + i64(lane) * s32;
  g.H = hmem + (i64(lane) << hh);
  g.M = mmem + (i64(lane) << hm);
  return g;
}

inline size_t smem_bytes(int n, int hlen, int threads) {
  return size_t(n) * (16 + NPAR * 4) + size_t(lane_words(n)) * 4 * threads
         + size_t(hlen);
}

// Largest block (threads = lanes per block, at most 32) whose shared memory
// fits the card's per-block limit for a model with n components.
inline int lane_threads(int n, int hlen) {
  if (n < 1 || n > MAXC) return 0;
  for (int t = 32; t >= 1; --t)
    if (smem_bytes(n, hlen, t) <= 227 * 1024) return t;
  return 0;
}

typedef void (*LaneKernel)(CM_LANE_PARAMS);

// Launches a lane kernel over L lanes on the stream; returns a CUDA error
// code (0 when the launch was accepted).
inline int launch_lanes(LaneKernel kernel, const void* comps,
                        const void* off8, const void* off32, int n,
                        const void* hcomp, int hlen, int hh, int hm,
                        const void* lut, const void* in, const void* in_off,
                        const void* in_len, void* a8, long long s8, void* a32,
                        long long s32, void* hmem, void* mmem, void* out,
                        const void* out_off, const void* out_cap,
                        void* out_len, void* status, int L, int threads,
                        void* stream) {
  if (n < 1 || n > MAXC || threads < 1 || threads > 32 || L < 1)
    return (int)cudaErrorInvalidValue;
  size_t smem = smem_bytes(n, hlen, threads);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return (int)e;
  int blocks = (L + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const i32*)comps, (const i64*)off8, (const i64*)off32, n,
      (const u8*)hcomp, hlen, hh, hm, (const i32*)lut, (const u8*)in,
      (const i64*)in_off, (const i64*)in_len, (u8*)a8, s8, (u32*)a32, s32,
      (u32*)hmem, (u8*)mmem, (u8*)out, (const i64*)out_off,
      (const i64*)out_cap, (i64*)out_len, (i32*)status, L);
  return (int)cudaGetLastError();
}

}  // namespace
