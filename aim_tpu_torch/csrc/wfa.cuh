// The WFA recursion shared by K1 (wfa2.cu, short reads) and K5 (wfa_long.cu,
// long reads) for NVIDIA Hopper (sm_90a).
//
// Both kernels compute one function: per pair, the gap-affine wavefront
// forward (extend, optional adaptive reduce, next-score compute) up to smax,
// then a level-walk backtrace writing one step record per score level into
// records[n, smax+4] int32, byte-equal to the reference kernels
// (aim_tpu/ops/wfa_pallas2.py::_wfa2_kernel and
// aim_tpu/ops/wfa_pallas_long.py::_wfa_long_kernel compute the same records).
// The scalar reading of the same semantics is aim_tpu/native/oracle.cpp
// (wfa_forward_dense, wfa_backtrace_dense).  The two kernels differ in where
// they keep the history and in how many pairs a warp holds.
//
// Mapping: a pair takes a segment of W lanes (W = 32: one pair a warp; W =
// 16: two, where all 2*smax+1 diagonals fit in 16 lanes).  A level's passes
// run over its live band only: lane b takes diagonals kb + b, kb + b + W,
// ... of the band [kb, khi] the compute wrote, so at the adaptive configs a
// level is one step a lane however large smax is.  The compute leaves each
// lane's first offset in a register, where the next level's extend, the
// adaptive reduce and the end test find it; the reduce is one pass over
// those values and three segment reductions.  The band's klo/khi/flags are
// one word a level in shared memory; the m/i/d offset history [3][smax+1][K]
// int16 lives where the kernel puts it, and only each level's band [lo, hi]
// is written.  Every read of the history is bounded by the band and flags
// of the level it reads, so cells outside them are never read and the
// history needs no initialisation.  The backtrace is sequential per pair and
// runs on lane 0 of its segment.
//
// Collectives stay warp-uniform: a warp steps its segments through the
// levels together until every segment's pair has ended (__any_sync), a
// finished or empty segment idling, and the reductions and shuffles are
// executed by every lane.
//
// NULL = -16384 is stored as int16; "+1" applies to raw NULL values; -10
// marks a null component; a diagonal outside K reads NULL.  Flag bits: 0
// exists, 1 m-null, 2 i-null, 3 d-null.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "band.cuh"  // kFull, kWarps and band_info

namespace aimwfa {

constexpr int kNull = -16384;
constexpr int kBig = 1 << 20;
constexpr int kOpX = 1, kOpI = 2, kOpD = 3;
using aimband::kFull;

struct Costs {
  int smax, K;
  int x, go, ge;
  int adaptive;
};

// A level's band: klo and khi biased by 2048 in 12 bits each (|k| <= 1024
// at smax <= 1023), the flags above them.
__device__ __forceinline__ int pack_level(int kl, int kh, int fl) {
  return (kl + 2048) | ((kh + 2048) << 12) | (fl << 24);
}
struct Level {
  int kl, kh, fl;
};
__device__ __forceinline__ Level unpack_level(int v) {
  return Level{(v & 0xFFF) - 2048, ((v >> 12) & 0xFFF) - 2048, v >> 24};
}
// A level below score 0 does not exist.
__device__ __forceinline__ Level level_at(const int *LV, int s) {
  return s >= 0 ? unpack_level(LV[s]) : Level{1, -1, 0};
}

// One pair's levels: the packed band per score, and the offset history.
struct Levels {
  int *LV;                // [smax+1]
  int16_t *Hm, *Hi, *Hd;  // [smax+1][K] each
};

// Minimum and maximum over the lane's segment of W lanes.
template <int W>
__device__ __forceinline__ int seg_min(int v) {
  static_assert(W == 16 || W == 32, "segments of 16 or 32 lanes");
  if (W == 32) return __reduce_min_sync(kFull, v);
  const bool lo = (threadIdx.x & 31) < 16;
  const int a = __reduce_min_sync(kFull, lo ? v : kBig);
  const int b = __reduce_min_sync(kFull, lo ? kBig : v);
  return lo ? a : b;
}
template <int W>
__device__ __forceinline__ int seg_max(int v) {
  return -seg_min<W>(-v);
}

// 64 bits of a staged sequence from base `pos` on (bits of later bases
// above); w holds at least two words past the one with base pos.
__device__ __forceinline__ uint64_t window(const uint32_t *w, int pos,
                                           int bsh) {
  const int bit = pos << bsh;
  const int i = bit >> 5, s = bit & 31;
  const uint64_t lo = (uint64_t)w[i] | ((uint64_t)w[i + 1] << 32);
  if (s == 0) return lo;
  return (lo >> s) | ((uint64_t)w[i + 2] << (64 - s));
}

// The extend of both kernels: offset m of diagonal k advanced to its first
// mismatch, comparing a 64-bit window at a time (32 bases of 2-bit codes,
// bsh = 1, or 8 bytes, bsh = 3): XOR, then __ffsll for the first differing
// base.  Both rows are staged as they arrive, zero past the input.  Bounds
// come from the lengths, never from the data: a mismatch is forced at h =
// min(tlen, plen + k), and offsets below max(k, 0) stay as they are.
// Records do not depend on the word layout (the reference's packed and
// byte layouts give equal records).
struct WindowExtend {
  const uint32_t *sp, *st;
  int plen, tlen, bsh;
  __device__ int operator()(int k, int m) const {
    const int lo_b = k > 0 ? k : 0;
    const int hi_b = max(min(tlen, plen + k), 0);
    if (m < lo_b || m >= hi_b) return m;
    const int step = 64 >> bsh;  // bases a window
    int h = m;
    for (;;) {
      const uint64_t d = window(st, h, bsh) ^ window(sp, h - k, bsh);
      if (d) {
        h += (__ffsll((long long)d) - 1) >> bsh;
        break;
      }
      h += step;
      if (h >= hi_b) break;
    }
    return min(h, hi_b);
  }
};

// Stage a pair's `width` bytes as they are into `words` 32-bit words of
// shared memory, zero past the input; lane b of a segment of W lanes.
template <int W>
__device__ __forceinline__ void stage_row(uint32_t *dst, const uint8_t *src,
                                          int width, int words, int b) {
  uint8_t *d = reinterpret_cast<uint8_t *>(dst);
  for (int j = b; j < 4 * words; j += W) d[j] = j < width ? src[j] : 0;
}

// The wavefront forward of one pair on the calling segment of W lanes (lane
// b of it; `live` false for a segment past the batch, which idles).  The
// staged rows the extend reads are visible after the first __syncwarp.
// Returns the score, smax + 1 on overflow.
template <int W, class Extend>
__device__ int forward(const Costs &C, const Levels &S, int plen, int tlen,
                       bool live, int b, const Extend &extend) {
  const int smax = C.smax, K = C.K;
  const int ak = tlen - plen;  // alignment diagonal
  int *LV = S.LV;
  // history rows indexed by the diagonal k in [-smax, smax]
  int16_t *Hm = S.Hm + smax, *Hi = S.Hi + smax, *Hd = S.Hd + smax;

  // ---- score 0: the one diagonal k = 0 at offset 0 ----
  int kl = 0, kh = 0, fl = 1 | (1 << 2) | (1 << 3);
  int mreg = 0;  // this lane's m at diagonal kl + b of the current level
  if (live && b == 0) {
    Hm[0] = 0;
    LV[0] = pack_level(kl, kh, fl);
  }
  __syncwarp();

  bool done = !live;
  int score = smax + 1;  // overflow unless the end is reached
  for (int s = 0;; ++s) {
    int16_t *mrow = Hm + s * K;
    bool m_null = !(fl & 1) || ((fl >> 1) & 1);
    const int kb = kl;  // the band the compute wrote: lane b holds kb + b

    // ---- extend (ref wfa.c:193-215), over [kl, kh] ----
    int h0 = mreg, lmin = kBig;
    if (!done && !m_null) {
      for (int c = 0, k = kb + b; k <= kh; ++c, k += W) {
        const int m = c ? mrow[k] : mreg;
        int h = m;
        if (m >= 0) {
          h = extend(k, m);
          if (h != m) mrow[k] = (int16_t)h;
        }
        if (!c) h0 = h;
        lmin = min(lmin, max(plen - (h - k), tlen - h));
      }
    }

    // ---- adaptive reduce (ref wfa.c:70-141), one pass ----
    const bool red = !done && C.adaptive && !m_null && kh - kl + 1 >= 10;
    if (__any_sync(kFull, red)) {
      const int mind = min(seg_min<W>(red ? lmin : kBig), max(plen, tlen));
      const int top_limit = min(ak - 1, kh);
      // the first kept diagonal below top_limit, and the last kept one
      // above ak + 1 (the one above max(ak + 1, klo_new), if it exceeds
      // klo_new, since every candidate already exceeds ak + 1)
      int lfk = kBig, llk = -kBig;
      if (red) {
        for (int c = 0, k = kb + b; k <= kh; ++c, k += W) {
          const int off = c ? mrow[k] : h0;
          const int dist = max(plen - (off - k), tlen - off);
          if (dist - mind <= 50) {
            if (k < top_limit) lfk = min(lfk, k);
            if (k > ak + 1) llk = max(llk, k);
          }
        }
      }
      const int fk = seg_min<W>(lfk);
      const int lk_all = seg_max<W>(llk);
      if (red) {
        const int klo_new = max(kl, min(fk, top_limit));
        const int bottom_limit = max(ak + 1, klo_new);
        const int lk = lk_all > klo_new ? lk_all : -kBig;
        const int khi_new = min(kh, max(lk, bottom_limit));
        if (klo_new > khi_new) {
          fl |= 0xE;  // nullify; the extents stay
          m_null = true;
        } else {
          kl = klo_new;
          kh = khi_new;
        }
        if (b == 0) LV[s] = pack_level(kl, kh, fl);
      }
    }
    __syncwarp();

    // ---- end reached (ref wfa.c:217-237) ----
    const int dk = ak - kb;
    int m_ak = __shfl_sync(kFull, h0, dk & (W - 1), W);
    if (!done && !m_null && kl <= ak && ak <= kh) {
      if (dk >= W) m_ak = mrow[ak];
      if (m_ak >= tlen) {
        score = s;
        done = true;
      }
    }
    if (s == smax) done = true;  // overflow: smax+1, no backtrace
    if (!__any_sync(kFull, !done)) break;

    // ---- compute score s+1 (ref wfa.c:275-354), over [lo, hi] ----
    if (!done) {
      const int s2 = s + 1;
      const int ss = s2 - C.x, so = s2 - C.go - C.ge, se = s2 - C.ge;
      const Level Lsub = level_at(LV, ss), Lo = level_at(LV, so),
                  Le = level_at(LV, se);
      const bool m_sub_null = !(Lsub.fl & 1) || ((Lsub.fl >> 1) & 1);
      const bool m_o_null = !(Lo.fl & 1) || ((Lo.fl >> 1) & 1);
      const bool i_e_null = !(Le.fl & 1) || ((Le.fl >> 2) & 1);
      const bool d_e_null = !(Le.fl & 1) || ((Le.fl >> 3) & 1);
      const bool i_out_null = m_o_null && i_e_null;
      const bool d_out_null = m_o_null && d_e_null;
      const bool allnull = m_sub_null && i_out_null && d_out_null;
      const int sub_lo = m_sub_null ? 1 : Lsub.kl;
      const int sub_hi = m_sub_null ? -1 : Lsub.kh;
      const int o_lo = m_o_null ? 1 : Lo.kl;
      const int o_hi = m_o_null ? -1 : Lo.kh;
      const bool e_both = i_e_null && d_e_null;
      const int e_lo = e_both ? 1 : Le.kl;
      const int e_hi = e_both ? -1 : Le.kh;
      const int lo = min(min(sub_lo, o_lo), e_lo) - 1;
      const int hi = max(max(sub_hi, o_hi), e_hi) + 1;
      const int16_t *mw_sub = Hm + max(ss, 0) * K;
      const int16_t *mw_o = Hm + max(so, 0) * K;
      const int16_t *iw_e = Hi + max(se, 0) * K;
      const int16_t *dw_e = Hd + max(se, 0) * K;
      int16_t *m_out = Hm + s2 * K, *i_out = Hi + s2 * K, *d_out = Hd + s2 * K;
      for (int c = 0, k = lo + b; !allnull && k <= hi; ++c, k += W) {
        const int km1 = k - 1, kp1 = k + 1;
        const int ins_g = (!m_o_null && o_lo <= km1 && km1 <= o_hi)
                              ? mw_o[km1] : kNull;
        const int ins_i = (!i_e_null && e_lo <= km1 && km1 <= e_hi)
                              ? iw_e[km1] : kNull;
        const int ins = (ins_g == kNull && ins_i == kNull)
                            ? kNull : max(ins_g, ins_i) + 1;
        const int del_g = (!m_o_null && o_lo <= kp1 && kp1 <= o_hi)
                              ? mw_o[kp1] : kNull;
        const int del_d = (!d_e_null && e_lo <= kp1 && kp1 <= e_hi)
                              ? dw_e[kp1] : kNull;
        const int dl = max(del_g, del_d);
        const int sub = (sub_lo <= k && k <= sub_hi) ? mw_sub[k] + 1 : kNull;
        const int ins_m = i_out_null ? -10 : ins;
        const int del_m = d_out_null ? -10 : dl;
        const int sub_m = m_sub_null ? -10 : sub;
        const int m_new = max(del_m, max(sub_m, ins_m));
        m_out[k] = (int16_t)m_new;
        i_out[k] = (int16_t)(i_out_null ? kNull : ins);
        d_out[k] = (int16_t)(d_out_null ? kNull : dl);
        if (!c) mreg = m_new;
      }
      kl = allnull ? 1 : lo;
      kh = allnull ? -1 : hi;
      fl = allnull ? 0 : (1 | ((int)i_out_null << 2) | ((int)d_out_null << 3));
      if (b == 0) LV[s2] = pack_level(kl, kh, fl);
    }
    __syncwarp();
  }
  return score;
}

// The pair's record row rec[smax+4]: zero rows and the score row, then (with
// `backtrace`, within smax) the level walk on lane 0 of the segment.  Called
// by every lane of the warp.
template <int W>
__device__ inline void write_records(const Costs &C, const Levels &S,
                                     int plen, int tlen, int score,
                                     bool backtrace, bool live, int32_t *rec,
                                     int b) {
  const int smax = C.smax, K = C.K;
  for (int j = b; live && j < smax + 4; j += W)
    rec[j] = (j == smax + 3) ? score : 0;
  __syncwarp();
  if (!live || !backtrace || score > smax || b != 0) return;

  // ---- backtrace over score levels (ref wfa_backtracing.c:219-375) ----
  // Walks the levels a pair visits; the levels it skips keep record 0.
  const int *LV = S.LV;
  const int16_t *Hm = S.Hm + smax, *Hi = S.Hi + smax, *Hd = S.Hd + smax;
  const int ak = tlen - plen;
  int cur = score;  // the walk's current score
  int k = ak;
  int offset = Hm[score * K + ak];
  int btype = 0;    // 0 M, 1 I, 2 D
  bool valid;
  {
    const int v = offset - k, h = offset;
    valid = v > 0 && v <= plen && h > 0 && h <= tlen;
  }
  auto in_band = [](const Level &L, int kx) {
    return (L.fl & 1) && L.kl <= kx && kx <= L.kh;
  };
  for (int s = score; s > 0 && cur == s; s = cur) {
    const int v = offset - k, h = offset;
    if (!(v > 0 && h > 0)) break;  // the walk ends here; record stays 0
    const bool now_valid = v <= plen && h <= tlen;
    const bool newly = !valid && now_valid;
    const int gap_len = (newly && k != ak) ? abs(ak - k) : 0;
    const int gap_d = (newly && k > ak) ? 1 : 0;
    valid = valid || newly;

    const int s_o = s - C.go - C.ge, s_e = s - C.ge, s_x = s - C.x;
    const Level Lo = level_at(LV, s_o), Le = level_at(LV, s_e),
                Lx = level_at(LV, s_x);
    const bool not_i = btype != 1, not_d = btype != 2, is_m = btype == 0;
    const int del_ext = (not_i && in_band(Le, k + 1) && !((Le.fl >> 3) & 1))
                            ? Hd[s_e * K + k + 1] : kNull;
    const int del_open = (not_i && in_band(Lo, k + 1))
                             ? Hm[s_o * K + k + 1] : kNull;
    const int ins_ext = (not_d && in_band(Le, k - 1) && !((Le.fl >> 2) & 1))
                            ? Hi[s_e * K + k - 1] + 1 : kNull;
    const int ins_open = (not_d && in_band(Lo, k - 1))
                             ? Hm[s_o * K + k - 1] + 1 : kNull;
    const int misms = (is_m && in_band(Lx, k)) ? Hm[s_x * K + k] + 1 : kNull;
    const int max_all = max(misms, max(max(ins_ext, ins_open),
                                       max(del_ext, del_open)));
    int nmatch = 0;
    bool brk = false;
    if (is_m) {  // match stroke (ref wfa_backtracing.c:198-201)
      nmatch = max(offset - max_all, 0);
      offset = max_all;
      brk = (offset - k <= 0) || (offset <= 0);
    }
    int bb = -1;  // priority del_ext > del_open > ins_ext > ins_open > mismatch
    if (!brk) {
      if (max_all == del_ext) bb = 0;
      else if (max_all == del_open) bb = 1;
      else if (max_all == ins_ext) bb = 2;
      else if (max_all == ins_open) bb = 3;
      else if (max_all == misms) bb = 4;
    }
    int opv = 0;
    if (valid) opv = (bb == 0 || bb == 1) ? kOpD : (bb == 2 || bb == 3) ? kOpI
                   : (bb == 4) ? kOpX : 0;
    rec[s] = min(nmatch, 0x3FFF) | (opv << 14) | (min(gap_len, 0x7FF) << 16) |
             (gap_d << 27);
    if (bb < 0) break;
    cur = (bb == 0 || bb == 2) ? s_e : (bb == 1 || bb == 3) ? s_o : s_x;
    if (bb == 0 || bb == 1) ++k;
    if (bb == 2 || bb == 3) --k;
    if (bb >= 2) --offset;
    btype = (bb == 0) ? 2 : (bb == 2) ? 1 : (bb == 1 || bb == 3) ? 0 : btype;
  }
  // ---- final strokes (ref wfa_backtracing.c:354-373): D(v) before I(h) ----
  const int v = offset - k, h = offset;
  if (cur == 0) {
    rec[smax + 1] = min(max(offset, 0), 0x3FFF);
  } else {
    rec[smax + 1] = min(max(v, 0), 0x3FFF) | (kOpD << 14);
    rec[smax + 2] = min(max(h, 0), 0x3FFF) | (kOpI << 14);
  }
}

}  // namespace aimwfa
