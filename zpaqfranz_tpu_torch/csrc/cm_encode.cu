// ZPAQ context-mixing lane encoder for Hopper (sm_90a).
//
// Replaces the TPU device program zpaqfranz_tpu/ops/codec_arena.py
// (ArenaEncoder.init_state/run over ArenaCoder.byte_step). The model
// (predictor phases, update, HCOMP step, the shared-memory placement
// and the design note on what bounds it) is shared with the decoder in
// cm_model.cuh; this file holds the range encoder and the kernel.
//
// One lane (one d block's payload, selector prefix included) per group of
// G threads: the group codes its whole payload in one launch and its
// thread 0 writes through the lane's own output cursor, so there is no
// emit buffer and no scatter. The range coder follows libzpaq's Encoder:
// each byte starts with the end-of-segment bit 0 at p = 0, the byte's bits
// go at predict() * 2 + 1, and after the last byte one end-of-segment bit 1
// at p = 0 flushes low. A lane whose coded bytes would pass its capacity
// fails with ST_OVERRUN; nothing is truncated.

#include "cm_model.cuh"

namespace {

// The HCOMP step: the interpreter, or the program that ops/build.py
// compiles in from a header generated by ops/hcomp_fast.py (struct
// HcompFast, defined with CM_HCOMP_FAST before this file is included).
#ifdef CM_HCOMP_FAST
typedef FastStep<HcompFast> Step;
#else
typedef Interp Step;
#endif

// The combine: the generic walk, or the model's combine that ops/build.py
// compiles in from the same generated header (struct CombineFast, from
// ops/combine_fast.py, defined with CM_COMBINE_FAST).
#ifdef CM_COMBINE_FAST
typedef FastCombine<CombineFast> Combine;
#else
typedef GenericCombine Combine;
#endif

// The phases (a) and (c): the generic ones, or the model's that
// ops/build.py compiles in from the same generated header (struct
// PhasesFast, from ops/phases_fast.py, defined with CM_PHASES_FAST).
#ifdef CM_PHASES_FAST
typedef FastPhases<PhasesFast> Phases;
#else
typedef GenericPhases Phases;
#endif

struct Enc {
  u32 low, high;
  u8* dst;
  i64 n, cap;
};

__device__ __forceinline__ void encode_bit(Enc& e, int& status, int y,
                                           u32 p) {
  u32 mid = e.low + u32((u64(e.high - e.low) * p) >> 16);
  if (y) e.high = mid;
  else e.low = mid + 1;
  while ((e.high ^ e.low) < 0x1000000u) {
    if (e.n >= e.cap) { status = ST_OVERRUN; return; }
    e.dst[e.n++] = u8(e.high >> 24);
    e.high = (e.high << 8) | 255u;
    e.low <<= 8;
    e.low += (e.low == 0);
  }
}

__global__ void __launch_bounds__(MAX_BLOCK_THREADS, 1)
    cm_encode_kernel(CM_LANE_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Model m = load_model(smem, comps, cplan, off8, off32, n, hcomp,
                             hlen, hh, hm, max_steps, lut);
  Lane s;
  Phases ph;
  int lane;
  if (!init_lane(s, ph, m, smem, G, lpb, lane_words, geo, L, a8, s8, a32,
                 s32, hmem, mmem, rmem, hh, hm, prof, stamps, &lane))
    return;
  Step step;
  step.init();
  const bool lead = s.k == 0;
  const u8* src = in + in_off[lane];
  const i64 len = in_len[lane];
  Enc e;
  e.low = 1;
  e.high = 0xFFFFFFFFu;
  e.dst = out + out_off[lane];
  e.cap = out_cap[lane];
  e.n = 0;
  for (i64 j = 0; j < len && s.status == ST_OK; ++j) {
    // the end-of-segment bit 0 goes out with the byte's first bit
    bool first = true;
    const u32 c = src[j];
    for (int k = 7; k >= 0 && s.status == ST_OK; --k) {
      const int y = (c >> k) & 1;
      code_bit<Combine>(s, m, step, ph, [&](u32 pr) {
        if (first) encode_bit(e, s.status, 0, 0);   // not the end of segment
        if (s.status == ST_OK) encode_bit(e, s.status, y, pr);
        return y;
      });
      first = false;
    }
  }
  if (lead) {
    if (s.status == ST_OK) encode_bit(e, s.status, 1, 0);  // flush
    out_len[lane] = e.n;
    status[lane] = s.status;
  }
  save_profile(s);
  save_stamp(s);
}

}  // namespace

extern "C" {

int cm_encode_launch(const void* comps, const void* cplan, const void* off8,
                     const void* off32, long long n, const void* hcomp,
                     long long hlen, long long hh, long long hm,
                     long long max_steps, long long G,
                     long long lpb, long long blocks, long long lane_words,
                     const void* geo, const void* lut, const void* in,
                     const void* in_off, const void* in_len, void* a8,
                     long long s8, void* a32, long long s32, void* hmem,
                     void* mmem, void* rmem, void* out, const void* out_off,
                     const void* out_cap, void* out_len, void* status,
                     void* prof, void* stamps, long long L,
                     void* stream) {
  return launch_lanes(cm_encode_kernel, comps, cplan, off8, off32, int(n),
                      hcomp, int(hlen), int(hh), int(hm), u64(max_steps),
                      int(G), int(lpb),
                      int(blocks), int(lane_words), geo, lut, in, in_off,
                      in_len, a8, s8, a32, s32, hmem, mmem, rmem, out,
                      out_off, out_cap, out_len, status, prof, stamps,
                      int(L), stream);
}

}  // extern "C"
