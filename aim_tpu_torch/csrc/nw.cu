// K2: banded NW edit distance, short-read tier, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel aim_tpu/ops/nw_pallas.py::_nw_kernel (launched
// by nw_forward_pallas, with its XLA mismatch-bitplane prologues).  Same
// function, same output: per pair the banded min-plus DP over text rows
// h = 1..tlen (lane b = v - h + C), the truncated deletion chain of depth
// DS, 2-bit direction codes (priority D, I, X, else M) and an is-match bit
// a cell, the exactness flags, and the event-driven walk that writes
// packed_runs[n, NRL] int16 byte-equal to the reference kernel.  The plain
// version of the same arithmetic is ops/nw.py::nw_reference.
//
// Mapping and planes: csrc/band.cuh.  Substitution costs compare the staged
// pattern and text bytes directly (only cells with 1 <= v <= plen and
// h <= tlen read them); the TPU's mismatch bitplanes are not built.  Each
// pair stops at its own tlen: rows past it are never read by the walk.
//
// What bounds it on this card: neither bytes nor tensor math.  A pair reads
// 2 x 30 packed bytes and writes 32 record bytes at the 100 bp config; the
// work is 112 dependent rows of a few shuffles each, then one walk step a
// CIGAR run, so the kernel is latency bound and relies on many warps in
// flight (a 16384-pair chunk is 4096 blocks of 4 warps).

#include "band.cuh"

namespace {

using namespace aimband;

constexpr int kCD = 0, kCI = 1, kCM = 2, kCX = 3;
constexpr int kPlanes = 3;  // code bit 0, code bit 1, is-match

template <int LPT>
__global__ void __launch_bounds__(32 * kWarps) nw_kernel(const BandParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long pair = (long)blockIdx.x * kWarps + warp;
  if (pair >= P.n) return;  // warp-uniform

  unsigned char *base = smem + (size_t)warp * P.warp_bytes;
  uint8_t *sp = base;
  uint8_t *st = base + P.seq_bytes;
  const int stride = kPlanes * P.words;  // plane words a row
  uint32_t *planes = P.planes_smem
      ? reinterpret_cast<uint32_t *>(base + 2 * P.seq_bytes)
      : P.scratch + pair * (long)P.R * stride;
  stage_seqs(P, pair, sp, st, lane);

  const int R = P.R, C = P.C, L = P.L, B = 2 * C + 1, DS = P.DS;
  const int gi = P.gi, gd = P.gd, x = P.x;
  const int plen = P.plens[pair], tlen = P.tlens[pair];
  const int kend = plen - tlen;
  const bool aliased = plen == tlen + 1;
  const int upper = min(plen, tlen + C);
  const int kc = kend + C;  // band lane of the end cell

  // ---- row 0: v = b - C, cell v*gd; the aliased slot v == plen holds gi
  int prev[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int b = lane + 32 * j, v0 = b - C;
    const bool inb = b < B;
    prev[j] = (v0 >= 0 && v0 <= plen && inb) ? v0 * gd : kInf;
    if (aliased && v0 == plen && inb && v0 >= 0) prev[j] = gi;
  }
  __syncwarp();  // staged sequences visible to the warp

  int score = 0;
  bool ovf = false;
  const int hmax = min(tlen, R);
  for (int h = 1; h <= hmax; ++h) {
    int sh[LPT], insv[LPT], z[LPT], cur[LPT];
    bool valid[LPT], col0[LPT];
    lane_shift(prev, sh, 1, kInf, L, lane);
    const uint8_t tch = st[h - 1];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int b = lane + 32 * j, v = b + h - C;
      valid[j] = v >= 1 && v <= upper && b < B;
      col0[j] = v == 0 && b < B;
      insv[j] = sh[j] + gi;
      const int sub = (valid[j] && sp[min(v - 1, R - 1)] != tch) ? x : 0;
      z[j] = valid[j] ? min(insv[j], prev[j] + sub) : kInf;
      if (col0[j]) z[j] = h * gi;
      z[j] -= b * gd;
    }
    trunc_min(z, DS, L, lane);  // the deletion chain
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int b = lane + 32 * j;
      cur[j] = (valid[j] || col0[j]) ? z[j] + b * gd : kInf;
    }
    if (P.check_ovf) {
      bool o = false;
#pragma unroll
      for (int j = 0; j < LPT; ++j) o = o || (valid[j] && abs(cur[j]) > 32767);
      ovf = ovf || __any_sync(kFull, o);
    }
    if (P.backtrace) {
      lane_shift(cur, sh, -1, kInf, L, lane);
      int code[LPT];
      bool ism[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        // dead lanes read INF and fall through to M, as in the reference
        code[j] = cur[j] == sh[j] + gd ? kCD
                : cur[j] == insv[j]    ? kCI
                : cur[j] == prev[j] + x ? kCX : kCM;
        ism[j] = code[j] == kCM;
      }
      store_planes(planes + (long)(h - 1) * stride, code, ism, 2, P.words, L,
                   lane);
    }
    if (h == tlen && kc >= 0 && kc < B) score = lane_value(cur, kc);
#pragma unroll
    for (int j = 0; j < LPT; ++j) prev[j] = cur[j];
  }

  // ---- exactness flags (nw_pallas.py:289-302) ----
  if (plen == 0 || tlen == 0) score = 0;
  const int dmax = floordiv(score, gi + gd);
  const int hs = C + dmax + 3;
  bool flag = plen > tlen + 1 || abs(kend) + dmax + 1 > C ||
              (aliased && hs * gi > (plen - hs) * gd) || ovf ||
              floordiv(score, gd) > DS || plen > tlen + C || tlen > plen + C;

  int16_t *rec = P.rec + pair * (long)P.NRL;
  for (int j = lane; j < P.NRL; j += 32) rec[j] = 0;
  Runs out{rec, P.NRL, P.NRL - 1, 0, 0, lane == 0};
  __syncwarp();  // planes and the zeroed record visible to the warp
  if (P.backtrace) {
    // ---- event-driven walk (nw_pallas.py:352-414) ----
    int hcur = tlen, vcur = plen;
    for (int it = 0; it < 2 * R + 2 && hcur > 0 && vcur > 0; ++it) {
      const int hm1 = min(hcur - 1, R - 1);
      const uint32_t *row = planes + (long)hm1 * stride;
      auto code_at = [&](int b) {
        return plane_bit(row, 0, P.words, b) |
               (plane_bit(row, 1, P.words, b) << 1);
      };
      // D-run: back to the last non-D lane within DS lanes of the position
      const int bb = vcur - hcur + C;
      const int cb = max(0, min(bb, L - 1));
      int pm = -1;
      for (int q = cb; q >= 0 && q >= cb - DS; --q)
        if (code_at(q) != kCD) {
          pm = q;
          break;
        }
      const int dlen = min(bb - pm, vcur);
      out.emit(true, kOpD, dlen);
      vcur -= dlen;
      // one row-exit event: I, X, or a whole match run
      const int b2 = vcur - hcur + C;
      const int cb2 = max(0, min(b2, L - 1));
      const int code2 = code_at(cb2);
      const bool act2 = vcur > 0;
      const bool is_i = act2 && code2 == kCI;
      const bool is_x = act2 && code2 == kCX;
      const bool is_m = act2 && code2 == kCM;
      int mrun = match_run(planes, stride, 2, P.words, hm1, cb2, lane);
      mrun = is_m ? min(mrun, min(vcur, hcur)) : 0;
      out.emit(is_i || is_m || is_x, is_i ? kOpI : is_m ? kOpM : kOpX,
               is_m ? mrun : 1);
      hcur -= (is_i || is_x) ? 1 : mrun;
      vcur -= is_x ? 1 : mrun;
    }
    // tails (ref nw.c:100-106); the iteration cap flags stragglers
    flag = flag || (hcur > 0 && vcur > 0);
    out.emit(hcur > 0, kOpI, hcur);
    out.emit(vcur > 0, kOpD, vcur);
    out.flush();
    flag = flag || out.rc < 1;
  }
  finish_record(rec, out.rc, flag, score, lane);
}

}  // namespace

extern "C" {

// Launches K2 on `stream`.  Returns cudaGetLastError() after the launch (0
// on success); the caller raises on anything else.
int aim_nw_forward(const void *pats, const void *txts, const void *plens,
                   const void *tlens, void *rec, void *scratch, long n,
                   int width, int packed, int R, int C, int L, int NRL,
                   int DS, int gi, int gd, int x, int check_ovf,
                   int backtrace, int planes_smem, void *stream) {
  BandParams P{};
  P.pats = static_cast<const uint8_t *>(pats);
  P.txts = static_cast<const uint8_t *>(txts);
  P.plens = static_cast<const int32_t *>(plens);
  P.tlens = static_cast<const int32_t *>(tlens);
  P.rec = static_cast<int16_t *>(rec);
  P.scratch = static_cast<uint32_t *>(scratch);
  P.n = n;
  P.width = width;
  P.packed = packed;
  P.R = R;
  P.C = C;
  P.L = L;
  P.NRL = NRL;
  P.DS = DS;
  P.planes = kPlanes;
  P.gi = gi;
  P.gd = gd;
  P.x = x;
  P.check_ovf = check_ovf;
  P.backtrace = backtrace;
  P.planes_smem = planes_smem;
  return launch(P, nw_kernel<1>, nw_kernel<2>, nw_kernel<4>, stream);
}

}  // extern "C"
