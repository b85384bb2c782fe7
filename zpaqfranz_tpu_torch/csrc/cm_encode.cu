// ZPAQ context-mixing lane encoder for Hopper (sm_90a).
//
// Replaces the TPU device program zpaqfranz_tpu/ops/codec_arena.py
// (ArenaEncoder.init_state/run over ArenaCoder.byte_step). The model
// (predictor, update, ZPAQL interpreter, arena layout and the design note on
// its bound) is shared with the decoder in cm_model.cuh; this file holds the
// range encoder and the kernel.
//
// One lane (one d block's payload, selector prefix included) per thread: the
// thread codes its whole payload in one launch and writes through its own
// output cursor, so there is no emit buffer and no scatter. The range coder
// follows libzpaq's Encoder: each byte starts with the end-of-segment bit 0
// at p = 0, the byte's bits go at predict() * 2 + 1, and after the last byte
// one end-of-segment bit 1 at p = 0 flushes low. A lane whose coded bytes
// would pass its capacity fails with ST_OVERRUN; nothing is truncated.

#include "cm_model.cuh"

namespace {

struct Enc {
  u32 low, high;
  u8* dst;
  i64 n, cap;
};

__device__ __forceinline__ void encode_bit(Enc& e, Pred& s, int y, u32 p) {
  u32 mid = e.low + u32((u64(e.high - e.low) * p) >> 16);
  if (y) e.high = mid;
  else e.low = mid + 1;
  while ((e.high ^ e.low) < 0x1000000u) {
    if (e.n >= e.cap) { s.status = ST_OVERRUN; return; }
    e.dst[e.n++] = u8(e.high >> 24);
    e.high = (e.high << 8) | 255u;
    e.low <<= 8;
    e.low += (e.low == 0);
  }
}

__global__ void cm_encode_kernel(CM_LANE_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem[];
  u32* lanes;
  const Shared m = load_shared(smem, comps, off8, off32, n, hcomp, hlen, hh,
                               hm, &lanes);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= L) return;

  const Mem g = lane_mem(lane, a8, s8, a32, s32, hmem, mmem, hh, hm);
  const u8* src = in + in_off[lane];
  const i64 len = in_len[lane];

  Pred s;
  init_pred(s, lanes, n);
  Enc e;
  e.low = 1;
  e.high = 0xFFFFFFFFu;
  e.dst = out + out_off[lane];
  e.cap = out_cap[lane];
  e.n = 0;
  for (i64 j = 0; j < len && s.status == ST_OK; ++j) {
    encode_bit(e, s, 0, 0);                     // not the end of segment
    const u32 c = src[j];
    for (int k = 7; k >= 0 && s.status == ST_OK; --k) {
      const u32 pr = u32(predict(s, m, lut, g)) * 2u + 1u;
      if (s.status != ST_OK) break;
      const int y = (c >> k) & 1;
      encode_bit(e, s, y, pr);
      update(s, m, lut, g, y);
    }
  }
  if (s.status == ST_OK) encode_bit(e, s, 1, 0);  // end of segment: flush
  out_len[lane] = e.n;
  status[lane] = s.status;
}

}  // namespace

extern "C" {

int cm_encode_threads(int n, int hlen) { return lane_threads(n, hlen); }

int cm_encode_launch(const void* comps, const void* off8, const void* off32,
                     long long n, const void* hcomp, long long hlen,
                     long long hh, long long hm, const void* lut,
                     const void* in, const void* in_off, const void* in_len,
                     void* a8, long long s8, void* a32, long long s32,
                     void* hmem, void* mmem, void* out, const void* out_off,
                     const void* out_cap, void* out_len, void* status,
                     long long L, long long threads, void* stream) {
  return launch_lanes(cm_encode_kernel, comps, off8, off32, n, hcomp, hlen,
                      hh, hm, lut, in, in_off, in_len, a8, s8, a32, s32, hmem,
                      mmem, out, out_off, out_cap, out_len, status, L,
                      threads, stream);
}

}  // extern "C"
