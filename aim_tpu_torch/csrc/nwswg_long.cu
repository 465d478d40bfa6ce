// K6 and K7: the streamed banded NW/SWG long-read tier, for NVIDIA Hopper
// (sm_90a).
//
// Replace the TPU kernels of aim_tpu/ops/nwswg_pallas_long.py launched by
// _nwswg_long_jit: _fwd_kernel (K6, with its XLA prologue _mm_blocks, whose
// mismatch bits are computed here from the sequences) and _walk_kernel
// (K7).  Same function, same records, byte for byte; the plain versions of
// the same arithmetic are ops/nwswg_long.py::nwswg_long_fwd_reference and
// nwswg_long_walk_reference.
//
// Mapping.  One warp owns one pair.  The band has P = 128 * planes
// positions b = v - h + C (C = 64 * planes - 1, in band where b < 2C + 1;
// the last position is outside the band and computed anyway, as on the
// TPU).  Thread t holds the E = 4 * planes consecutive positions
// t*E .. t*E + E - 1 in registers.  A text row is one step: the +-1 band
// shifts are one shuffle each (a value crossing a multiple of 128 is capped
// at 2^24, as the TPU's plane-seam broadcasts cap it), and the deletion
// chain is a full-depth min-plus prefix scan over the whole band --
// ramp-subtract, a serial scan of the thread's E values, a 5-step warp
// scan of the thread totals, add back -- capped at INF everywhere but
// position 127, as the TPU's masked log-step rolls leave it.  The TPU's
// row blocks, 128-lane planes and the rotation all-reduces at the seams
// (nwswg_pallas_long.py:256-311) are Mosaic's and do not carry over.
//
// Symbols.  Band position b at row h compares pattern symbol
// j = b + h - C - 1 with text symbol h - 1, read as the reference reads its
// padded rows: j < weff from the input (2-bit codes unpacked, or raw
// bytes), weff <= j < lpad reads 0 (its padding to whole row blocks), any
// other j reads -1, which no symbol equals.  Each thread keeps its E
// pattern symbols of the current row in registers and slides them by one
// position a row (one shuffle, one byte load on the last thread).
//
// Code rows (the port's layout, global scratch the wrapper allocates):
//   codes [n][R][P*bits/8]  row h-1: position b's code at bits bits*b..,
//                           little-endian; NW 2 bits (D=0 I=1 M=2 X=3),
//                           SWG 4 bits (choice | d_open << 2 | i_open << 3,
//                           CH_M where the cell is not valid)
//   ism   [n][R][P/8]       position b's is-match bit at bit b (NW: code M;
//                           SWG: valid and choice M)
//   meta  [n][2] int32      score, forward flag
// A thread's E codes are contiguous bits; rows are written as whole 32-bit
// words (threads whose bits share a word OR them together by shuffles).
// Without backtrace no rows are written and K6 writes the record itself.
//
// K7 walks one pair a warp from (tlen, plen) down, every thread on the
// same scalars.  The nearest band position <= bb whose NW code is not D
// (or whose SWG d_open bit is set) is one ballot over the row's words and
// two __clz; a match run is 32 rows of is-match bits at one position read
// by the 32 threads and one ballot.  The step budget (2R+2 NW, 3R+4 SWG)
// starts afresh at each row block of the reference (block_rows), and a row
// outside the current block reads as zero words there, as on the TPU.
// Records: packed_runs [n][NRL] int16, lane 0 = cursor_lo8 | flag << 8 |
// forward flag << 9 | cursor_hi << 10, lane 1 = score clipped to int16,
// runs op << 12 | length from lane cursor+1 (band.cuh's Runs; the short
// tiers' finish_record writes another lane-0 grammar and is not used).
//
// What bounds it on this card: neither bytes nor tensor math.  A 4 kbp
// pair reads ~8 KB of sequence and writes 48 bytes of code rows a text row
// (~200 KB a pair for NW at one plane); the work is R dependent rows of a
// few dozen integer operations and ~10 shuffles a thread, so K6 is latency
// bound and relies on many warps in flight (a 4096-pair chunk is 1024
// blocks of 4 warps).  K7 is a short sequential walk a pair.

#include <climits>

#include "band.cuh"

namespace {

using namespace aimband;

constexpr int kSeamCap = 1 << 24;
constexpr int kPairs = 4;  // warps (pairs) a block
constexpr int kCD = 0, kCI = 1, kCM = 2, kCX = 3;
constexpr int kLM = 0, kLI = 1, kLD = 2;

struct LongParams {
  const uint8_t *pats, *txts;
  const int32_t *plens, *tlens;
  int32_t *meta;   // [n][2]
  uint8_t *codes;  // [n][R][cbytes]
  uint8_t *ism;    // [n][R][ibytes]
  int16_t *rec;    // [n][NRL]
  long n;
  int width, packed, weff, lpad;
  int R, C, NP, NRL, RB, NBK, it_cap, backtrace, cbytes, ibytes;
  int gi, gd, x;             // NW costs (x: the mismatch cost of both)
  int mat, go, ge, ms;       // SWG costs
};

// Pattern or text symbol j of a pair as the reference reads its padded
// rows.
__device__ __forceinline__ int sym_at(const uint8_t *row, const LongParams &P,
                                      int j) {
  if (j < 0 || j >= P.lpad) return -1;
  if (j >= P.weff) return 0;
  if (P.packed) return (row[j >> 2] >> (2 * (j & 3))) & 3;
  return row[j];
}

__device__ __forceinline__ int16_t lane0(int rc, bool flag, bool mflag,
                                         int NRL) {
  const int r = max(0, min(rc, NRL - 1));
  return (int16_t)((r & 255) | ((int)flag << 8) | ((int)mflag << 9) |
                   ((r >> 8) << 10));
}

// In-place prefix min over the band: thread t's E values are positions
// t*E.., then the warp scan of the thread totals; every position is capped
// at INF except position 127.
template <int E>
__device__ __forceinline__ void band_min_scan(int (&z)[E], int lane) {
#pragma unroll
  for (int e = 1; e < E; ++e) z[e] = min(z[e], z[e - 1]);
  int tot = z[E - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_sync(kFull, tot, lane - o);
    if (lane >= o) tot = min(tot, t);
  }
  int excl = __shfl_sync(kFull, tot, lane - 1);
  if (lane == 0) excl = INT_MAX;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int m = min(z[e], excl);
    z[e] = lane * E + e == 127 ? m : min(m, kInf);
  }
}

// The value at the position after this thread's last one (from thread
// lane + 1), INF past the band, capped where it crosses a plane seam.
__device__ __forceinline__ int from_right(int first, int lane, bool seam) {
  int v = __shfl_sync(kFull, first, lane + 1);
  if (lane == 31) return kInf;
  return seam ? min(v, kSeamCap) : v;
}

// The value at the position before this thread's first one.
__device__ __forceinline__ int from_left(int last, int lane, bool seam) {
  int v = __shfl_sync(kFull, last, lane - 1);
  if (lane == 0) return kInf;
  return seam ? min(v, kSeamCap) : v;
}

// Store a row of NB bits a thread (thread t's bits at t*NB of the row).
template <int NB>
__device__ __forceinline__ void store_bits(
    uint8_t *row, const uint32_t (&w)[NB >= 32 ? NB / 32 : 1], int lane) {
  uint32_t *r32 = reinterpret_cast<uint32_t *>(row);
  if constexpr (NB >= 32) {
#pragma unroll
    for (int k = 0; k < NB / 32; ++k) r32[lane * (NB / 32) + k] = w[k];
  } else {
    constexpr int G = 32 / NB;
    uint32_t v = w[0] << ((lane % G) * NB);
#pragma unroll
    for (int o = 1; o < G; o <<= 1) v |= __shfl_sync(kFull, v, lane ^ o);
    if (lane % G == 0) r32[lane / G] = v;
  }
}

// ---------------------------------------------------------------- K6 ----

template <int E, bool kSwg>
__global__ void __launch_bounds__(32 * kPairs) fwd_kernel(const LongParams P) {
  constexpr int CB = kSwg ? 4 : 2;                 // code bits a position
  constexpr int CW = (E * CB) >= 32 ? E * CB / 32 : 1;
  constexpr int IW = E >= 32 ? E / 32 : 1;
  const int lane = threadIdx.x & 31;
  const long pair = (long)blockIdx.x * kPairs + (threadIdx.x >> 5);
  if (pair >= P.n) return;  // warp-uniform
  const uint8_t *prow = P.pats + pair * P.width;
  const uint8_t *trow = P.txts + pair * P.width;
  const int R = P.R, C = P.C, B = 2 * C + 1, NP = P.NP;
  const int plen = P.plens[pair], tlen = P.tlens[pair];
  const int kend = plen - tlen;
  const bool aliased = plen == tlen + 1;
  const int p0 = lane * E;
  const bool seam_r = ((p0 + E) & 127) == 0;
  const bool seam_l = p0 > 0 && (p0 & 127) == 0;
  const int kc = kend + C;
  const bool hit_in = kc >= 0 && kc < B;
  const int hmax = min(tlen, R);
  uint8_t *crows = P.codes + pair * (long)R * P.cbytes;
  uint8_t *irows = P.ism + pair * (long)R * P.ibytes;

  int win[E];  // pattern symbol of position p0 + e at the current row
#pragma unroll
  for (int e = 0; e < E; ++e) win[e] = sym_at(prow, P, p0 + e - C);

  // row 0
  int pm[E], pi[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = p0 + e, v0 = p - C;
    const bool inb = p < B;
    if (!kSwg) {
      int r = (v0 >= 0 && v0 <= plen && inb) ? v0 * P.gd : kInf;
      if (aliased && v0 == plen && inb && v0 >= 0) r = P.gi;
      pm[e] = r;
      pi[e] = 0;
    } else {
      const bool ok = v0 >= 0 && v0 <= plen && inb;
      int d0 = v0 == 0 ? P.ms : P.go + v0 * P.ge;
      int i0 = P.ms;
      int m0 = v0 == 0 ? 0 : d0;
      if (aliased && v0 == plen && v0 > 0) {
        i0 = P.go + P.ge;
        m0 = P.go + P.ge;
      }
      pm[e] = ok ? m0 : kInf;
      pi[e] = ok ? i0 : kInf;
    }
  }

  int score = 0;
  bool ovf = false;
  const int upper = min(plen, tlen + C);
  const int margin = P.go + P.ge + max(P.x, max(abs(P.mat), P.ge));
  for (int h = 1; h <= hmax; ++h) {
    if (h > 1) {  // slide the pattern window by one position
      const int nxt = __shfl_sync(kFull, win[0], lane + 1);
#pragma unroll
      for (int e = 0; e + 1 < E; ++e) win[e] = win[e + 1];
      win[E - 1] = lane == 31 ? sym_at(prow, P, NP + h - C - 2) : nxt;
    }
    const int tsym = sym_at(trow, P, h - 1);
    uint32_t vmask = 0, cmask = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = p0 + e, v = p + h - C;
      const bool inb = p < B;
      const bool ok = v >= 1 && (kSwg ? v <= plen : v <= upper) && inb;
      vmask |= (uint32_t)ok << e;
      cmask |= (uint32_t)(v == 0 && inb) << e;
    }
    int cur[E];
    uint32_t cw[CW] = {}, iw[IW] = {};
    if (!kSwg) {
      const int gi = P.gi, gd = P.gd, x = P.x;
      const int rn = from_right(pm[0], lane, seam_r);
      int insv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        insv[e] = (e + 1 < E ? pm[e + 1] : rn) + gi;
        const bool valid = (vmask >> e) & 1;
        int z = valid ? min(insv[e], pm[e] + (win[e] != tsym ? x : 0))
                      : kInf;
        if ((cmask >> e) & 1) z = h * gi;
        cur[e] = z - (p0 + e) * gd;
      }
      band_min_scan(cur, lane);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool live = ((vmask | cmask) >> e) & 1;
        cur[e] = live ? cur[e] + (p0 + e) * gd : kInf;
        if (((vmask >> e) & 1) && abs(cur[e]) > 32767) ovf = true;
      }
      if (P.backtrace) {
        const int ln = from_left(cur[E - 1], lane, seam_l);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int left = e > 0 ? cur[e - 1] : ln;
          const int code = cur[e] == left + gd  ? kCD
                         : cur[e] == insv[e]    ? kCI
                         : cur[e] == pm[e] + x  ? kCX : kCM;
          cw[(2 * e) / 32] |= (uint32_t)code << ((2 * e) % 32);
          iw[e / 32] |= (uint32_t)(code == kCM) << (e % 32);
        }
      }
    } else {
      const int go = P.go, ge = P.ge, mat = P.mat, mis = P.x;
      const int mb = go + h * ge;
      const int db = (aliased && h >= 2) ? kInf : P.ms;
      const int rnm = from_right(pm[0], lane, seam_r);
      const int rni = from_right(pi[0], lane, seam_r);
      uint32_t iopen = 0;
      int c[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {  // ascending: pi[e+1] is still old
        const bool valid = (vmask >> e) & 1;
        const int iov = (e + 1 < E ? pm[e + 1] : rnm) + go + ge;
        int ic = min(iov, (e + 1 < E ? pi[e + 1] : rni) + ge);
        ic = valid ? ic : kInf;
        if ((cmask >> e) & 1) ic = mb;
        iopen |= (uint32_t)(ic == iov) << e;
        pi[e] = ic;
        c[e] = valid ? min(pm[e] + (win[e] != tsym ? mis : mat), ic) : kInf;
      }
      const int lnc = from_left(c[E - 1], lane, seam_l);
      int d[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int p = p0 + e, v = p + h - C;
        const bool live = ((vmask | cmask) >> e) & 1;
        // M at p - 1 where that cell is column 0, else INF
        int ml = (p >= 1 && p - 1 + h - C == 0 && p - 1 < B) ? mb : kInf;
        if (e == 0 && seam_l) ml = min(ml, kSeamCap);
        const int left = e > 0 ? c[e - 1] : lnc;
        int z = ((cmask >> e) & 1) ? db
              : v == 1 ? ml + go + ge : left + go + ge;
        z = live ? z : kInf;
        d[e] = z - p * ge;
      }
      band_min_scan(d, lane);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool live = ((vmask | cmask) >> e) & 1;
        d[e] = live ? d[e] + (p0 + e) * ge : kInf;
        int m = min(c[e], d[e]);
        if ((cmask >> e) & 1) m = mb;
        cur[e] = live ? m : kInf;
        if ((vmask >> e) & 1) {
          const int mx = max(abs(cur[e]), max(abs(pi[e]), abs(d[e])));
          if (mx > 32767 - margin && mx < kInf / 2) ovf = true;
        }
      }
      if (P.backtrace) {
        const int lnm = from_left(cur[E - 1], lane, seam_l);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const bool valid = (vmask >> e) & 1;
          const int m = cur[e];
          const int choice = m == d[e] ? kCD
                           : m == pi[e] ? kCI
                           : m == pm[e] + mat ? kCM : kCX;
          const int dop = d[e] == (e > 0 ? cur[e - 1] : lnm) + go + ge;
          const int code =
              valid ? choice | (dop << 2) | (int)(((iopen >> e) & 1) << 3)
                    : kCM;
          cw[(4 * e) / 32] |= (uint32_t)code << ((4 * e) % 32);
          iw[e / 32] |= (uint32_t)(valid && (code & 3) == kCM) << (e % 32);
        }
      }
    }
    if (P.backtrace) {
      store_bits<E * CB>(crows + (long)(h - 1) * P.cbytes, cw, lane);
      store_bits<E>(irows + (long)(h - 1) * P.ibytes, iw, lane);
    }
    if (h == tlen && hit_in) {  // warp-uniform
      int val = 0;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (p0 + e == kc) val = cur[e];
      score = __shfl_sync(kFull, val, kc / E);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) pm[e] = cur[e];
  }
  ovf = __any_sync(kFull, ovf);

  // ---- per-pair score and flag (nwswg_pallas_long.py:541-580) ----
  if (plen == 0 || tlen == 0) score = 0;
  bool flag;
  if (!kSwg) {
    const int dmax = floordiv(score, P.gi + P.gd);
    const int hs = C + dmax + 3;
    flag = plen > tlen + 1 || abs(kend) + dmax + 1 > C ||
           (aliased && hs * P.gi > (plen - hs) * P.gd) || ovf ||
           plen > tlen + C || tlen > plen + C;
  } else {
    const int go = P.go, ge = P.ge;
    const int dmax = floordiv(max(0, score - 2 * go), 2 * ge) + 1;
    const bool bad_sentinel = floordiv(score - P.ms, ge) + dmax > C;
    const int hs = C + dmax + 3;
    const bool bad_alias =
        aliased && ((2 * go + (hs + 1) * ge) > (plen - hs - 1) * ge ||
                    P.mat < 0);
    const bool bad_wrap = go + max(plen, tlen) * ge + margin > 32767 ||
                          P.ms + margin > 32767;
    flag = plen > tlen + 1 || abs(kend) + dmax + 1 > C || bad_sentinel ||
           bad_alias || ovf || bad_wrap || plen > tlen + C ||
           tlen > plen + C || score < 0;
  }
  if (lane == 0) {
    P.meta[2 * pair] = score;
    P.meta[2 * pair + 1] = flag;
  }
  if (!P.backtrace) {  // the score-only record (reference :1019-1028)
    int16_t *rec = P.rec + pair * (long)P.NRL;
    for (int j = lane; j < P.NRL; j += 32)
      rec[j] = j == 0   ? lane0(P.NRL - 1, flag, flag, P.NRL)
             : j == 1   ? (int16_t)max(-32768, min(score, 32767))
                        : (int16_t)0;
  }
}

// ---------------------------------------------------------------- K7 ----

// Nearest position <= q (0 <= q < NP) whose NW code is not D (kSwg: whose
// d_open bit is set) in a code row, or -1.
template <bool kSwg>
__device__ __forceinline__ int last_marked(const uint32_t *row, int q,
                                           int lane) {
  constexpr int FB = kSwg ? 4 : 2;  // bits a position
  constexpr int PW = 32 / FB;       // positions a word
  const int wq = q / PW, fq = q % PW;
  for (int base = wq & ~31; base >= 0; base -= 32) {
    const int w = base + lane;
    uint32_t m = 0;
    if (w <= wq) {
      const uint32_t word = row[w];
      m = kSwg ? (word >> 2) & 0x11111111u : (word | (word >> 1)) & 0x55555555u;
      if (w == wq && fq < PW - 1) m &= (1u << (FB * (fq + 1))) - 1u;
    }
    const unsigned bal = __ballot_sync(kFull, m != 0);
    if (bal) {
      const int top = 31 - __clz((int)bal);
      const uint32_t mt = __shfl_sync(kFull, m, top);
      return (base + top) * PW + (31 - __clz((int)mt)) / FB;
    }
  }
  return -1;
}

// Consecutive is-match rows at position q from global row `row` down to the
// first row of its 32-row word (pos = its row within the word); zero
// outside the current block.  Thread t reads row - t.
__device__ __forceinline__ int long_match_run(const uint8_t *irows,
                                              int ibytes, int row, int pos,
                                              bool inblk, int q, int lane) {
  bool ok = false;
  if (inblk && lane <= pos)
    ok = (irows[(long)(row - lane) * ibytes + (q >> 3)] >> (q & 7)) & 1;
  const unsigned bits = __ballot_sync(kFull, ok);
  const unsigned u = ~bits & (pos == 31 ? kFull : ((1u << (pos + 1)) - 1u));
  return u == 0 ? pos + 1 : __ffs((int)u) - 1;
}

template <bool kSwg>
__global__ void __launch_bounds__(32 * kPairs)
    walk_kernel(const LongParams P) {
  const int lane = threadIdx.x & 31;
  const long pair = (long)blockIdx.x * kPairs + (threadIdx.x >> 5);
  if (pair >= P.n) return;  // warp-uniform
  const int C = P.C, NP = P.NP, RB = P.RB;
  const int score = P.meta[2 * pair];
  const bool mflag = P.meta[2 * pair + 1] != 0;
  int16_t *rec = P.rec + pair * (long)P.NRL;
  for (int j = lane; j < P.NRL; j += 32) rec[j] = 0;
  __syncwarp();  // the zeroed record visible to the writing thread
  Runs out{rec, P.NRL, P.NRL - 1, 0, 0, lane == 0};
  const uint8_t *crows = P.codes + pair * (long)P.R * P.cbytes;
  const uint8_t *irows = P.ism + pair * (long)P.R * P.ibytes;
  // forward-flagged pairs do not walk (reference :608-623)
  int hcur = mflag ? 0 : P.tlens[pair];
  int vcur = mflag ? 0 : P.plens[pair];
  int layer = kLM;
  for (int blk = P.NBK - 1; blk >= 0; --blk) {
    const int blk_lo = blk * RB;
    for (int it = 0; it < P.it_cap; ++it) {
      if (!(hcur > 0 && vcur > 0 && hcur > blk_lo)) break;
      const int hm1 = hcur - 1 - blk_lo;
      const bool inblk = hm1 < RB;
      const int row = blk_lo + hm1;
      const uint8_t *crow = crows + (long)row * P.cbytes;
      const int bb = vcur - hcur + C;
      const int q = max(0, min(bb, NP - 1));
      if (!kSwg) {
        const int pmb = inblk ? last_marked<false>(
            reinterpret_cast<const uint32_t *>(crow), q, lane) : -1;
        const int dlen = min(bb - pmb, vcur);
        out.emit(true, kOpD, dlen);
        vcur -= dlen;
        const bool act2 = vcur > 0;
        const int q2 = max(0, min(vcur - hcur + C, NP - 1));
        const int code2 = inblk ? (crow[q2 >> 2] >> (2 * (q2 & 3))) & 3 : 0;
        const bool is_i = act2 && code2 == kCI;
        const bool is_x = act2 && code2 == kCX;
        const bool is_m = act2 && code2 == kCM;
        int mrun = long_match_run(irows, P.ibytes, row, hm1 & 31, inblk, q2,
                                  lane);
        mrun = is_m ? min(mrun, min(vcur, hcur)) : 0;
        out.emit(is_i || is_m || is_x, is_i ? kOpI : is_m ? kOpM : kOpX,
                 is_m ? mrun : 1);
        hcur -= (is_i || is_x) ? 1 : mrun;
        vcur -= is_x ? 1 : mrun;
        continue;
      }
      // SWG: the M / I / D layer machine (reference :765-822)
      const int nib = inblk ? (crow[q >> 1] >> (4 * (q & 1))) & 15 : 0;
      const bool io = (nib >> 3) & 1;
      const bool in_i = layer == kLI;
      out.emit(in_i, kOpI, 1);
      if (in_i && io) layer = kLM;
      const bool in_m = layer == kLM && !in_i;
      const int ch = nib & 3;
      const bool is_d = in_m && ch == kCD;
      int dlen = 0;
      if (is_d) {
        const int pmd = inblk ? last_marked<true>(
            reinterpret_cast<const uint32_t *>(crow), q, lane) : -1;
        dlen = bb - pmd + 1;
      }
      const bool capped = is_d && dlen >= vcur;
      dlen = min(dlen, vcur);
      out.emit(is_d, kOpD, dlen);
      if (capped) layer = kLD;
      const bool is_i = in_m && ch == kCI;
      const bool is_x = in_m && ch == kCX;
      const bool is_m = in_m && ch == kCM;
      int mrun = long_match_run(irows, P.ibytes, row, hm1 & 31, inblk, q,
                                lane);
      mrun = is_m ? min(mrun, min(vcur, hcur)) : 0;
      out.emit(is_i || is_m || is_x, is_i ? kOpI : is_m ? kOpM : kOpX,
               is_m ? mrun : 1);
      if (is_i) layer = io ? kLM : kLI;
      hcur -= (in_i || is_i || is_x) ? 1 : mrun;
      vcur -= is_x ? 1 : dlen + mrun;
    }
  }
  bool flag = mflag || (hcur > 0 && vcur > 0);
  // tails in runs of at most 4095 (reference :856-866)
  for (int k = 0; k < 4; ++k) {
    const int hc = max(0, min(hcur, 4095));
    out.emit(hc > 0, kOpI, hc);
    hcur -= hc;
  }
  for (int k = 0; k < 4; ++k) {
    const int vc = max(0, min(vcur, 4095));
    out.emit(vc > 0, kOpD, vc);
    vcur -= vc;
  }
  out.flush();
  flag = flag || out.rc < 1;
  if (lane == 0) {
    rec[0] = lane0(out.rc, flag, mflag, P.NRL);
    rec[1] = (int16_t)max(-32768, min(score, 32767));
  }
}

using Kern = void (*)(const LongParams);

int launch_long(Kern k, const LongParams &P, void *stream) {
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const long blocks = (P.n + kPairs - 1) / kPairs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k<<<(unsigned)blocks, 32 * kPairs, 0, s>>>(P);
  return (int)cudaGetLastError();
}

bool planes_ok(int planes) {
  return planes == 1 || planes == 2 || planes == 4 || planes == 8;
}

bool nrl_ok(int NRL) { return NRL == 256 || NRL == 512 || NRL == 1024; }

}  // namespace

extern "C" {

// Launches K6 on `stream`: meta [n][2] always, the code rows with
// backtrace, the score-only record without.  Returns cudaGetLastError()
// after the launch (0 on success); the caller raises on anything else.
int aim_nwswg_long_forward(const void *pats, const void *txts,
                           const void *plens, const void *tlens, void *meta,
                           void *codes, void *ism, void *rec, long n,
                           int width, int packed, int weff, int lpad, int R,
                           int planes, int NRL, int swg, int backtrace,
                           int gi, int gd, int x, int mat, int go, int ge,
                           int ms, void *stream) {
  if (n <= 0) return 0;
  if (!planes_ok(planes) || !nrl_ok(NRL) || R <= 0 || width <= 0 ||
      weff < 0 || lpad < R || (backtrace && (!codes || !ism)) ||
      (!backtrace && !rec))
    return (int)cudaErrorInvalidValue;
  LongParams P{};
  P.pats = static_cast<const uint8_t *>(pats);
  P.txts = static_cast<const uint8_t *>(txts);
  P.plens = static_cast<const int32_t *>(plens);
  P.tlens = static_cast<const int32_t *>(tlens);
  P.meta = static_cast<int32_t *>(meta);
  P.codes = static_cast<uint8_t *>(codes);
  P.ism = static_cast<uint8_t *>(ism);
  P.rec = static_cast<int16_t *>(rec);
  P.n = n;
  P.width = width;
  P.packed = packed;
  P.weff = weff;
  P.lpad = lpad;
  P.R = R;
  P.C = 64 * planes - 1;
  P.NP = 128 * planes;
  P.NRL = NRL;
  P.backtrace = backtrace;
  P.cbytes = P.NP * (swg ? 4 : 2) / 8;
  P.ibytes = P.NP / 8;
  P.gi = gi;
  P.gd = gd;
  P.x = x;
  P.mat = mat;
  P.go = go;
  P.ge = ge;
  P.ms = ms;
  Kern k = nullptr;
  switch (planes) {
    case 1: k = swg ? fwd_kernel<4, true> : fwd_kernel<4, false>; break;
    case 2: k = swg ? fwd_kernel<8, true> : fwd_kernel<8, false>; break;
    case 4: k = swg ? fwd_kernel<16, true> : fwd_kernel<16, false>; break;
    case 8: k = swg ? fwd_kernel<32, true> : fwd_kernel<32, false>; break;
  }
  return launch_long(k, P, stream);
}

// Launches K7 on `stream`: the records from K6's code rows and meta.
int aim_nwswg_long_walk(const void *codes, const void *ism, const void *meta,
                        const void *plens, const void *tlens, void *rec,
                        long n, int R, int planes, int NRL, int RB, int swg,
                        void *stream) {
  if (n <= 0) return 0;
  if (!planes_ok(planes) || !nrl_ok(NRL) || R <= 0 || RB <= 0 ||
      RB % 32 != 0 || !codes || !ism)
    return (int)cudaErrorInvalidValue;
  LongParams P{};
  P.codes = static_cast<uint8_t *>(const_cast<void *>(codes));
  P.ism = static_cast<uint8_t *>(const_cast<void *>(ism));
  P.meta = static_cast<int32_t *>(const_cast<void *>(meta));
  P.plens = static_cast<const int32_t *>(plens);
  P.tlens = static_cast<const int32_t *>(tlens);
  P.rec = static_cast<int16_t *>(rec);
  P.n = n;
  P.R = R;
  P.C = 64 * planes - 1;
  P.NP = 128 * planes;
  P.NRL = NRL;
  P.RB = RB;
  P.NBK = (R + RB - 1) / RB;
  P.it_cap = swg ? 3 * R + 4 : 2 * R + 2;
  P.cbytes = P.NP * (swg ? 4 : 2) / 8;
  P.ibytes = P.NP / 8;
  return launch_long(swg ? walk_kernel<true> : walk_kernel<false>, P,
                     stream);
}

}  // extern "C"
