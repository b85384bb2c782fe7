// ZPAQ context-mixing lane decoder for Hopper (sm_90a).
//
// Replaces the TPU device program zpaqfranz_tpu/ops/codec_arena.py
// (ArenaDecoder.init_state/run over ArenaCoder.byte_step) together with its
// HCOMP step. The model (predictor, update, ZPAQL interpreter, arena layout
// and the design note on its bound) is shared with the encoder in
// cm_model.cuh; this file holds the range decoder and the kernel.
//
// One lane (one d block's coded segment) per thread: the thread decodes its
// whole block in one launch and stops at its own end-of-segment bit, so
// there are no frozen lanes and no size buckets. The range decoder follows
// the scalar engine native/src/tzpaq.cpp (Decoder::decode).

#include "cm_model.cuh"

namespace {

struct Dec {
  u32 low, high, curr;
  i64 pos, len;
  const u8* src;
};

__device__ __forceinline__ int decode_bit(Dec& d, Pred& s, u32 p) {
  if (d.curr < d.low || d.curr > d.high) { s.status = ST_CORRUPT; return 0; }
  u32 mid = d.low + u32((u64(d.high - d.low) * p) >> 16);
  int y;
  if (d.curr <= mid) { y = 1; d.high = mid; }
  else { y = 0; d.low = mid + 1; }
  while ((d.high ^ d.low) < 0x1000000u) {
    d.high = (d.high << 8) | 255u;
    d.low <<= 8;
    d.low += (d.low == 0);
    if (d.pos >= d.len) { s.status = ST_EOF; return y; }
    d.curr = (d.curr << 8) | u32(d.src[d.pos++]);
  }
  return y;
}

__global__ void cm_decode_kernel(CM_LANE_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  u32* lanes;
  const Shared m = load_shared(smem, comps, off8, off32, n, hcomp, hlen, hh,
                               hm, &lanes);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;

  const Mem g = lane_mem(lane, a8, s8, a32, s32, hmem, mmem, hh, hm);
  u8* dst = out + out_off[lane];
  const i64 cap = out_cap[lane];

  Pred s;
  init_pred(s, lanes, n);
  Dec d;
  d.src = in + in_off[lane];
  d.len = in_len[lane];
  d.low = 1;
  d.high = 0xFFFFFFFFu;
  d.curr = 0;
  d.pos = 0;
  i64 nout = 0;
  if (d.len < 4) {
    s.status = ST_EOF;
  } else {
    for (int k = 0; k < 4; ++k) d.curr = (d.curr << 8) | u32(d.src[k]);
    d.pos = 4;
  }
  while (s.status == ST_OK) {
    if (decode_bit(d, s, 0)) {                  // end of segment
      if (s.status == ST_OK && d.curr != 0) s.status = ST_CORRUPT;
      break;
    }
    if (s.status != ST_OK) break;
    if (nout >= cap) { s.status = ST_OVERRUN; break; }
    u32 c = 1;
    while (c < 256) {
      u32 pr = u32(predict(s, m, lut, g)) * 2u + 1u;
      if (s.status != ST_OK) break;
      int y = decode_bit(d, s, pr);
      if (s.status != ST_OK) break;
      c = c * 2 + u32(y);
      update(s, m, lut, g, y);
      if (s.status != ST_OK) break;
    }
    if (s.status != ST_OK) break;
    dst[nout++] = u8(c - 256);
  }
  out_len[lane] = nout;
  status[lane] = s.status;
}

}  // namespace

extern "C" {

int cm_decode_threads(int n, int hlen) { return lane_threads(n, hlen); }

int cm_decode_launch(const void* comps, const void* off8, const void* off32,
                     long long n, const void* hcomp, long long hlen,
                     long long hh, long long hm, const void* lut,
                     const void* in, const void* in_off, const void* in_len,
                     void* a8, long long s8, void* a32, long long s32,
                     void* hmem, void* mmem, void* out, const void* out_off,
                     const void* out_cap, void* out_len, void* status,
                     long long L, long long threads, void* stream) {
  return launch_lanes(cm_decode_kernel, comps, off8, off32, n, hcomp, hlen,
                      hh, hm, lut, in, in_off, in_len, a8, s8, a32, s32, hmem,
                      mmem, out, out_off, out_cap, out_len, status, L,
                      threads, stream);
}

}  // extern "C"
