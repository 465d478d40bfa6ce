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
// Substitution costs compare the staged pattern and text bytes directly
// (only cells with 1 <= v <= plen and h <= tlen read them); the TPU's
// mismatch bitplanes are not built.  Each pair stops at its own tlen: rows
// past it are never read by the walk.
//
// What bounds it on this card: neither bytes nor tensor math.  A pair reads
// 2 x 30 packed bytes and writes 32 record bytes at the 100 bp config; the
// work is 112 dependent rows of a few shuffles each, then one walk step a
// CIGAR run, so the kernel is latency bound: the design keeps lanes busy,
// shifts in single shuffles, shared memory a pair small (occupancy) and
// the walk's steps O(1).
//
// Segmented path (L <= 32, every config at the 100 bp width; segment.cuh):
// 32/L pairs a warp, one band lane a thread (2 pairs at the canonical
// L = 16, 4 at 8, 1 at 32).  Each of a row's shifts (the insertion source,
// the rounds of the truncated deletion scan, and D's left neighbour for the
// codes) is one __shfl_up/down_sync of width L; the row's 3 ballots (code
// bits 0 and 1, is-match) serve every pair of the warp and lane p of a
// segment stores plane p; the planes are L-bit words (uint16 at L = 16: 672
// B a pair at the 100 bp config against 1,344 B as 32-bit words), in
// shared memory while a block's share fits in 48 KB.  The score is one
// width-L shuffle at lane kc once the pair's rows are done.  The walk's
// D-run search is one masked word (code bits 0 | 1 over lanes [cb - DS,
// cb]) and a __clz; a match run reads 32/L rows a round with one ballot.
// The pairs of a warp step together to its longest text; the walk loops
// while __any_sync says some segment still walks, and a finished, empty or
// past-the-end segment idles through the warp's collectives.  4 warps a
// block, __launch_bounds__ with 8 blocks an SM (<= 64 registers a thread).
//
// Wide path (L = 64, 128, the configs with the larger MAX_SCORE): one warp a
// pair, L/32 band lanes a thread, shifts as shuffle pairs (band.cuh, shared
// with K3's wide path); the D-run search reads at most DS/32 + 2 words.

#include "band.cuh"
#include "segment.cuh"

namespace {

using namespace aimband;

constexpr int kCD = 0, kCI = 1, kCM = 2, kCX = 3;
constexpr int kPlanes = 3;  // code bit 0, code bit 1, is-match

// ---------------------------------------------------------------------------
// wide path: one warp a pair, LPT = L/32 band lanes a thread
// ---------------------------------------------------------------------------

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
      // D-run: back to the last non-D lane (code bits 0 | 1 set) within DS
      // lanes of the position, or -1
      const int bb = vcur - hcur + C;
      const int cb = max(0, min(bb, L - 1));
      const int lo = max(0, cb - DS);
      int pm = -1;
      for (int q = cb >> 5; q >= lo >> 5 && pm < 0; --q) {
        const int top = q == cb >> 5 ? cb & 31 : 31;
        const int bot = q == lo >> 5 ? lo & 31 : 0;
        const int at = last_set_in(row[q] | row[P.words + q], bot, top);
        if (at >= 0) pm = 32 * q + at;
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

// ---------------------------------------------------------------------------
// segmented path: 32/L pairs a warp, one band lane a thread
// ---------------------------------------------------------------------------

template <int L>
__global__ void __launch_bounds__(32 * kWarps, 8)
    nw_seg_kernel(const SegParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef typename PlaneWord<L>::T W;
  constexpr int kPairs = 32 / L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = lane & (L - 1);  // band lane
  const int seg0 = lane - b;
  const long first = ((long)blockIdx.x * kWarps + warp) * kPairs;
  if (first >= P.n) return;  // warp-uniform
  const long pair = first + lane / L;
  const bool live = pair < P.n;  // a segment past the batch's end idles

  unsigned char *wbase = smem + (size_t)warp * kPairs * P.pair_bytes;
  stage_warp_seqs(P, first, kPairs, wbase, lane);
  const uint8_t *sp = wbase + (size_t)(lane / L) * P.pair_bytes;
  const uint8_t *st = sp + P.seq_bytes;
  W *planes = P.planes_smem
      ? reinterpret_cast<W *>(const_cast<uint8_t *>(sp) + 2 * P.seq_bytes)
      : reinterpret_cast<W *>(P.scratch) + (live ? pair : 0) * (long)P.R *
            kPlanes;

  const int R = P.R, C = P.C, B = 2 * C + 1, DS = P.DS;
  const int gi = P.gi, gd = P.gd, x = P.x;
  const int plen = live ? P.plens[pair] : 0;
  const int tlen = live ? P.tlens[pair] : 0;
  const int kend = plen - tlen;
  const bool aliased = plen == tlen + 1;
  const int upper = min(plen, tlen + C);
  const int kc = kend + C;  // band lane of the end cell

  // ---- row 0: v = b - C, cell v*gd; the aliased slot v == plen holds gi
  int prev;
  {
    const int v0 = b - C;
    const bool inb = b < B;
    prev = (v0 >= 0 && v0 <= plen && inb) ? v0 * gd : kInf;
    if (aliased && v0 == plen && inb && v0 >= 0) prev = gi;
  }
  __syncwarp();  // staged sequences visible to the warp

  bool ovf = false;
  const int hmax = min(tlen, R);
  const int hall = __reduce_max_sync(kFull, hmax);
  for (int h = 1; h <= hall; ++h) {
    const bool act = h <= hmax;
    const int sh = seg_next<L>(prev, b, kInf);  // prev at lane b+1
    const uint8_t tch = st[min(h - 1, P.seq_bytes - 1)];
    const int v = b + h - C;
    const bool valid = v >= 1 && v <= upper && b < B;
    const bool col0 = v == 0 && b < B;
    const int insv = sh + gi;
    const int sub = (valid && sp[min(v - 1, R - 1)] != tch) ? x : 0;
    int z = valid ? min(insv, prev + sub) : kInf;
    if (col0) z = h * gi;
    z = seg_trunc_min<L>(z - b * gd, DS, b);  // the deletion chain
    const int cur = (valid || col0) ? z + b * gd : kInf;
    if (P.check_ovf) {
      const bool o = act && valid && abs(cur) > 32767;
      ovf = ovf || seg_bits<L>(__ballot_sync(kFull, o), seg0) != 0u;
    }
    if (P.backtrace) {
      const int left = seg_prev<L>(cur, 1, b, kInf);  // cur at lane b-1
      // dead lanes read INF and fall through to M, as in the reference
      const int code = cur == left + gd  ? kCD
                     : cur == insv       ? kCI
                     : cur == prev + x   ? kCX : kCM;
      // plane p of the row: code bit p (p < 2), is-match (p = 2); lane p
      // of the segment stores it
      unsigned word = 0;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const bool bit = p < 2 ? ((code >> p) & 1) : code == kCM;
        const unsigned u = seg_bits<L>(__ballot_sync(kFull, bit), seg0);
        if (b == p) word = u;
      }
      if (act && b < kPlanes) planes[(long)(h - 1) * kPlanes + b] = (W)word;
    }
    if (act) prev = cur;
  }
  // score: the cell at band lane kc of row tlen, which prev holds once the
  // pair's rows are done
  const int at_kc = __shfl_sync(kFull, prev, max(0, min(kc, L - 1)), L);
  int score = (tlen >= 1 && tlen <= R && kc >= 0 && kc < B) ? at_kc : 0;

  // ---- exactness flags (nw_pallas.py:289-302) ----
  if (plen == 0 || tlen == 0) score = 0;
  const int dmax = floordiv(score, gi + gd);
  const int hs = C + dmax + 3;
  bool flag = plen > tlen + 1 || abs(kend) + dmax + 1 > C ||
              (aliased && hs * gi > (plen - hs) * gd) || ovf ||
              floordiv(score, gd) > DS || plen > tlen + C || tlen > plen + C;

  int16_t *rec = P.rec + (live ? pair : 0) * (long)P.NRL;
  if (live)
    for (int j = b; j < P.NRL; j += L) rec[j] = 0;
  Runs out{rec, P.NRL, P.NRL - 1, 0, 0, live && b == 0};
  __syncwarp();  // planes and the zeroed records visible to the warp
  if (P.backtrace) {
    // ---- event-driven walk (nw_pallas.py:352-414) ----
    int hcur = tlen, vcur = plen, it = 0;
    bool walking = live && hcur > 0 && vcur > 0;
    while (__any_sync(kFull, walking)) {
      const int hm1 = max(0, min(hcur - 1, R - 1));
      const W *row = planes + (long)hm1 * kPlanes;
      // D-run: back to the last non-D lane (code bits 0 | 1 set) within DS
      // lanes of the position, or -1
      const int bb = vcur - hcur + C;
      const int cb = max(0, min(bb, L - 1));
      const int pm = last_set_in(row[0] | row[1], max(0, cb - DS), cb);
      const int dlen = min(bb - pm, vcur);
      const int v2 = vcur - dlen;  // the row-exit event's column
      const int cb2 = max(0, min(v2 - hcur + C, L - 1));
      const int mr = seg_match_run<L>(planes, kPlanes, 2, hm1, cb2, b, seg0);
      if (walking) {
        out.emit(true, kOpD, dlen);
        vcur = v2;
        // one row-exit event: I, X, or a whole match run
        const int code2 = ((row[0] >> cb2) & 1) | (((row[1] >> cb2) & 1) << 1);
        const bool act2 = vcur > 0;
        const bool is_i = act2 && code2 == kCI;
        const bool is_x = act2 && code2 == kCX;
        const bool is_m = act2 && code2 == kCM;
        const int mrun = is_m ? min(mr, min(vcur, hcur)) : 0;
        out.emit(is_i || is_m || is_x, is_i ? kOpI : is_m ? kOpM : kOpX,
                 is_m ? mrun : 1);
        hcur -= (is_i || is_x) ? 1 : mrun;
        vcur -= is_x ? 1 : mrun;
        ++it;
        walking = it < 2 * R + 2 && hcur > 0 && vcur > 0;
      }
    }
    // tails (ref nw.c:100-106); the iteration cap flags stragglers
    flag = flag || (hcur > 0 && vcur > 0);
    out.emit(hcur > 0, kOpI, hcur);
    out.emit(vcur > 0, kOpD, vcur);
    out.flush();
    flag = flag || out.rc < 1;
  }
  if (live) finish_record(rec, out.rc, flag, score, b);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef void (*SegKernel)(const SegParams);

SegKernel seg_kernel(int L) {
  return L == 8 ? nw_seg_kernel<8> : L == 16 ? nw_seg_kernel<16>
                                             : nw_seg_kernel<32>;
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
  SegParams P{};
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
  if (L <= 32) return launch_seg(P, seg_kernel(L), stream);
  return launch_wide(P, nw_kernel<2>, nw_kernel<4>, stream);
}

// What K2 runs at (R, L): out = {registers a thread, local (spill) bytes a
// thread, dynamic shared memory a block, resident blocks an SM, pairs a
// warp, 0}.  Returns a cudaError_t (0 on success).
int aim_nw_info(int R, int L, int backtrace, int planes_smem, int *out) {
  SegParams P{};
  P.R = R;
  P.L = L;
  P.planes = kPlanes;
  P.backtrace = backtrace;
  P.planes_smem = planes_smem;
  if (L <= 32) return band_info(seg_kernel(L), seg_plan(P), 32 / L, out);
  if (L != 64 && L != 128) return (int)cudaErrorInvalidValue;
  P.words = L / 32;
  return band_info(L == 64 ? nw_kernel<2> : nw_kernel<4>,
                   (size_t)warp_bytes(P, planes_smem != 0) * kWarps, 1, out);
}

}  // extern "C"
