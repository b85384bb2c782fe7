// ZPAQ context-mixing lane decoder for Hopper (sm_90a).
//
// Replaces the TPU device program zpaqfranz_tpu/ops/codec_arena.py
// (ArenaDecoder.init_state/run over ArenaCoder.byte_step) together with its
// HCOMP step. The model (predictor phases, update, ZPAQL interpreter, the
// shared-memory placement and the design note on what bounds it) is shared
// with the encoder in cm_model.cuh; this file holds the range decoder and
// the kernel.
//
// One lane (one d block's coded segment) per group of G threads: the group
// decodes its whole block in one launch and stops at its own
// end-of-segment bit, so there are no frozen lanes and no size buckets.
// The range decoder runs on the group's thread 0 and follows the scalar
// engine native/src/tzpaq.cpp (Decoder::decode).

#include "cm_model.cuh"

namespace {

struct Dec {
  u32 low, high, curr;
  i64 pos, len;
  const u8* src;
};

__device__ __forceinline__ int decode_bit(Dec& d, int& status, u32 p) {
  if (d.curr < d.low || d.curr > d.high) { status = ST_CORRUPT; return 0; }
  u32 mid = d.low + u32((u64(d.high - d.low) * p) >> 16);
  int y;
  if (d.curr <= mid) { y = 1; d.high = mid; }
  else { y = 0; d.low = mid + 1; }
  while ((d.high ^ d.low) < 0x1000000u) {
    d.high = (d.high << 8) | 255u;
    d.low <<= 8;
    d.low += (d.low == 0);
    if (d.pos >= d.len) { status = ST_EOF; return y; }
    d.curr = (d.curr << 8) | u32(d.src[d.pos++]);
  }
  return y;
}

__global__ void cm_decode_kernel(CM_LANE_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Model m = load_model(smem, comps, cplan, off8, off32, n, hcomp,
                             hlen, hh, hm, lut);
  Lane s;
  int lane;
  if (!init_lane(s, m, smem, G, lpb, lane_words, geo, L, a8, s8, a32, s32,
                 hmem, mmem, rmem, hh, hm, prof, &lane))
    return;
  const bool lead = s.k == 0;
  u8* dst = out + out_off[lane];
  const i64 cap = out_cap[lane];
  Dec d;
  i64 nout = 0;
  if (lead) {
    d.src = in + in_off[lane];
    d.len = in_len[lane];
    d.low = 1;
    d.high = 0xFFFFFFFFu;
    d.curr = 0;
    d.pos = 0;
    if (d.len < 4) {
      s.status = ST_EOF;
    } else {
      for (int k = 0; k < 4; ++k) d.curr = (d.curr << 8) | u32(d.src[k]);
      d.pos = 4;
    }
  }
  for (;;) {
    // thread 0: the end-of-segment bit, then room for one more byte;
    // misc[3] = 0 go on, 1 end of segment, 2 failed (status in misc[1])
    if (lead) {
      u32 go = 2;
      if (s.status == ST_OK) {
        if (decode_bit(d, s.status, 0)) {
          if (s.status == ST_OK && d.curr != 0) s.status = ST_CORRUPT;
          go = 1;
        } else if (s.status == ST_OK) {
          if (nout >= cap) s.status = ST_OVERRUN;
          else go = 0;
        }
      }
      s.misc[1] = u32(s.status);
      s.misc[3] = go;
    }
    gsync(s);
    const u32 go = s.misc[3];
    s.status = int(s.misc[1]);
    if (go != 0) break;
    u32 c = 1;
    while (c < 256) {
      const int y = code_bit(s, m, [&](u32 pr) {
        return decode_bit(d, s.status, pr);
      });
      if (s.status != ST_OK) break;
      c = c * 2 + u32(y);
    }
    if (s.status != ST_OK) break;
    if (lead) dst[nout++] = u8(c - 256);
  }
  if (lead) {
    out_len[lane] = nout;
    status[lane] = s.status;
  }
  save_profile(s);
}

}  // namespace

extern "C" {

int cm_decode_launch(const void* comps, const void* cplan, const void* off8,
                     const void* off32, long long n, const void* hcomp,
                     long long hlen, long long hh, long long hm, long long G,
                     long long lpb, long long blocks, long long lane_words,
                     const void* geo, const void* lut, const void* in,
                     const void* in_off, const void* in_len, void* a8,
                     long long s8, void* a32, long long s32, void* hmem,
                     void* mmem, void* rmem, void* out, const void* out_off,
                     const void* out_cap, void* out_len, void* status,
                     void* prof, long long L, void* stream) {
  return launch_lanes(cm_decode_kernel, comps, cplan, off8, off32, int(n),
                      hcomp, int(hlen), int(hh), int(hm), int(G), int(lpb),
                      int(blocks), int(lane_words), geo, lut, in, in_off,
                      in_len, a8, s8, a32, s32, hmem, mmem, rmem, out,
                      out_off, out_cap, out_len, status, prof, int(L),
                      stream);
}

}  // extern "C"
