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
// (wfa_forward_dense, wfa_backtrace_dense).  The two kernels differ only in
// where they keep the history and in their extend, which each passes in.
//
// Mapping: one warp per pair, lanes over the K = 2*smax+1 diagonals (a loop
// when K > 32).  Warp reductions (__reduce_min/max_sync) take the adaptive
// reduce's min and max; neighbouring diagonals k+-1 are read from the level
// rows in memory after a __syncwarp.  klo/khi/flags per level live in
// shared memory; the m/i/d offset history [3][smax+1][K] int16 lives where
// the kernel puts it.  The backtrace is sequential per pair and runs on
// lane 0.
//
// NULL = -16384 is stored as int16; "+1" applies to raw NULL values; -10
// marks a null component; a diagonal outside K reads NULL.  Flag bits: 0
// exists, 1 m-null, 2 i-null, 3 d-null.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace aimwfa {

constexpr int kNull = -16384;
constexpr int kBig = 1 << 20;
constexpr int kOpX = 1, kOpI = 2, kOpD = 3;

struct Costs {
  int smax, K;
  int x, go, ge;
  int adaptive;
};

// One pair's levels: klo/khi/flags per score, and the offset history.
struct Levels {
  int *KL, *KH, *FL;      // [smax+1] each
  int16_t *Hm, *Hi, *Hd;  // [smax+1][K] each
};

__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(0xffffffffu, v);
}
__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(0xffffffffu, v);
}

// The wavefront forward of one pair on the calling warp.  `extend(k, m)`
// returns offset m of diagonal k advanced to its first mismatch (m >= 0,
// k inside the level's band); the bounds are the extend's own.  Returns the
// score, smax + 1 on overflow.
template <class Extend>
__device__ int forward(const Costs &C, const Levels &S, int plen, int tlen,
                       int lane, Extend &&extend) {
  const int smax = C.smax, K = C.K;
  const int ak = tlen - plen;  // alignment diagonal
  int *KL = S.KL, *KH = S.KH, *FL = S.FL;
  int16_t *Hm = S.Hm, *Hi = S.Hi, *Hd = S.Hd;

  // ---- score 0 ----
  for (int j = lane; j < K; j += 32) {
    Hm[j] = (int16_t)(j == smax ? 0 : kNull);
    Hi[j] = (int16_t)kNull;
    Hd[j] = (int16_t)kNull;
  }
  if (lane == 0) {
    KL[0] = 0;
    KH[0] = 0;
    FL[0] = 1 | (1 << 2) | (1 << 3);
  }
  __syncwarp();

  int score = smax + 1;  // overflow unless the end is reached
  for (int s = 0; s <= smax; ++s) {
    int kl = KL[s], kh = KH[s], fl = FL[s];
    bool m_null = !(fl & 1) || ((fl >> 1) & 1);
    int16_t *mrow = Hm + s * K;

    // ---- extend (ref wfa.c:193-215) ----
    if (!m_null) {
      for (int j = lane; j < K; j += 32) {
        const int k = j - smax;
        const int m = mrow[j];
        if (k < kl || k > kh || m < 0) continue;
        const int h = extend(k, m);
        if (h != m) mrow[j] = (int16_t)h;
      }
    }
    __syncwarp();

    // ---- adaptive reduce (ref wfa.c:70-141) ----
    if (C.adaptive && !m_null && kh - kl + 1 >= 10) {
      int lmin = kBig;
      for (int j = lane; j < K; j += 32) {
        const int k = j - smax;
        if (k < kl || k > kh) continue;
        const int off = mrow[j];
        lmin = min(lmin, max(plen - (off - k), tlen - off));
      }
      const int mind = min(warp_min(lmin), max(plen, tlen));
      const int top_limit = min(ak - 1, kh);
      int lfk = kBig;
      for (int j = lane; j < K; j += 32) {
        const int k = j - smax;
        const int off = mrow[j];
        const int dist = max(plen - (off - k), tlen - off);
        if (k >= kl && k < top_limit && dist - mind <= 50) lfk = min(lfk, k);
      }
      const int fk = warp_min(lfk);
      const int klo_new = max(kl, min(fk, top_limit));
      const int bottom_limit = max(ak + 1, klo_new);
      int llk = -kBig;
      for (int j = lane; j < K; j += 32) {
        const int k = j - smax;
        const int off = mrow[j];
        const int dist = max(plen - (off - k), tlen - off);
        if (k <= kh && k > bottom_limit && dist - mind <= 50) llk = max(llk, k);
      }
      const int lk = warp_max(llk);
      const int khi_new = min(kh, max(lk, bottom_limit));
      if (klo_new > khi_new) {
        fl |= 0xE;  // nullify; the extents stay
        m_null = true;
      } else {
        kl = klo_new;
        kh = khi_new;
      }
      if (lane == 0) {
        KL[s] = kl;
        KH[s] = kh;
        FL[s] = fl;
      }
      __syncwarp();
    }

    // ---- end reached (ref wfa.c:217-237) ----
    const int m_at_ak = (ak >= -smax && ak <= smax) ? mrow[ak + smax] : 0;
    if (!m_null && kl <= ak && ak <= kh && m_at_ak >= tlen) {
      score = s;
      break;
    }
    if (s == smax) break;  // overflow: smax+1, no backtrace

    // ---- compute score s+1 (ref wfa.c:275-354) ----
    const int s2 = s + 1;
    const int ss = s2 - C.x, so = s2 - C.go - C.ge, se = s2 - C.ge;
    const int f_sub = ss >= 0 ? FL[ss] : 0;
    const int f_o = so >= 0 ? FL[so] : 0;
    const int f_e = se >= 0 ? FL[se] : 0;
    const bool m_sub_null = !(f_sub & 1) || ((f_sub >> 1) & 1);
    const bool m_o_null = !(f_o & 1) || ((f_o >> 1) & 1);
    const bool i_e_null = !(f_e & 1) || ((f_e >> 2) & 1);
    const bool d_e_null = !(f_e & 1) || ((f_e >> 3) & 1);
    const bool i_out_null = m_o_null && i_e_null;
    const bool d_out_null = m_o_null && d_e_null;
    const bool allnull = m_sub_null && i_out_null && d_out_null;
    const int sub_lo = m_sub_null ? 1 : KL[ss];
    const int sub_hi = m_sub_null ? -1 : KH[ss];
    const int o_lo = m_o_null ? 1 : KL[so];
    const int o_hi = m_o_null ? -1 : KH[so];
    const bool e_both = i_e_null && d_e_null;
    const int e_lo = e_both ? 1 : KL[se];
    const int e_hi = e_both ? -1 : KH[se];
    const int lo = min(min(sub_lo, o_lo), e_lo) - 1;
    const int hi = max(max(sub_hi, o_hi), e_hi) + 1;
    const int16_t *mw_sub = Hm + max(ss, 0) * K;
    const int16_t *mw_o = Hm + max(so, 0) * K;
    const int16_t *iw_e = Hi + max(se, 0) * K;
    const int16_t *dw_e = Hd + max(se, 0) * K;
    for (int j = lane; j < K; j += 32) {
      const int k = j - smax;
      const int km1 = k - 1, kp1 = k + 1;
      const int ins_g = (!m_o_null && o_lo <= km1 && km1 <= o_hi && j >= 1)
                            ? mw_o[j - 1] : kNull;
      const int ins_i = (!i_e_null && e_lo <= km1 && km1 <= e_hi && j >= 1)
                            ? iw_e[j - 1] : kNull;
      const int ins = (ins_g == kNull && ins_i == kNull)
                          ? kNull : max(ins_g, ins_i) + 1;
      const int del_g = (!m_o_null && o_lo <= kp1 && kp1 <= o_hi && j + 1 < K)
                            ? mw_o[j + 1] : kNull;
      const int del_d = (!d_e_null && e_lo <= kp1 && kp1 <= e_hi && j + 1 < K)
                            ? dw_e[j + 1] : kNull;
      const int dl = max(del_g, del_d);
      const int sub = (sub_lo <= k && k <= sub_hi) ? mw_sub[j] + 1 : kNull;
      const int ins_m = i_out_null ? -10 : ins;
      const int del_m = d_out_null ? -10 : dl;
      const int sub_m = m_sub_null ? -10 : sub;
      const int m_new = max(del_m, max(sub_m, ins_m));
      const bool write = !allnull && lo <= k && k <= hi;
      Hm[s2 * K + j] = (int16_t)(write ? m_new : kNull);
      Hi[s2 * K + j] = (int16_t)(write && !i_out_null ? ins : kNull);
      Hd[s2 * K + j] = (int16_t)(write && !d_out_null ? dl : kNull);
    }
    if (lane == 0) {
      KL[s2] = allnull ? 1 : lo;
      KH[s2] = allnull ? -1 : hi;
      FL[s2] = allnull ? 0 : (1 | ((int)i_out_null << 2) | ((int)d_out_null << 3));
    }
    __syncwarp();
  }
  return score;
}

// The pair's record row rec[smax+4]: zero rows and the score row, then (with
// `backtrace`, within smax) the level walk.  Called by the whole warp.
__device__ inline void write_records(const Costs &C, const Levels &S, int plen,
                                     int tlen, int score, bool backtrace,
                                     int32_t *rec, int lane) {
  const int smax = C.smax, K = C.K;
  for (int j = lane; j < smax + 4; j += 32) rec[j] = (j == smax + 3) ? score : 0;
  __syncwarp();
  if (!backtrace || score > smax || lane != 0) return;

  // ---- backtrace over score levels (ref wfa_backtracing.c:219-375) ----
  // Walks the levels a pair visits; the levels it skips keep record 0.
  const int *KL = S.KL, *KH = S.KH, *FL = S.FL;
  const int16_t *Hm = S.Hm, *Hi = S.Hi, *Hd = S.Hd;
  const int ak = tlen - plen;
  int cur = score;  // the walk's current score
  int k = ak;
  int offset = Hm[score * K + ak + smax];
  int btype = 0;    // 0 M, 1 I, 2 D
  bool valid;
  {
    const int v = offset - k, h = offset;
    valid = v > 0 && v <= plen && h > 0 && h <= tlen;
  }
  auto in_band = [&](int sx, int kx) {
    return sx >= 0 && (FL[sx] & 1) && KL[sx] <= kx && kx <= KH[sx];
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
    const bool not_i = btype != 1, not_d = btype != 2, is_m = btype == 0;
    const int del_ext = (not_i && in_band(s_e, k + 1) && !((FL[s_e] >> 3) & 1))
                            ? Hd[s_e * K + k + 1 + smax] : kNull;
    const int del_open = (not_i && in_band(s_o, k + 1))
                             ? Hm[s_o * K + k + 1 + smax] : kNull;
    const int ins_ext = (not_d && in_band(s_e, k - 1) && !((FL[s_e] >> 2) & 1))
                            ? Hi[s_e * K + k - 1 + smax] + 1 : kNull;
    const int ins_open = (not_d && in_band(s_o, k - 1))
                             ? Hm[s_o * K + k - 1 + smax] + 1 : kNull;
    const int misms = (is_m && in_band(s_x, k))
                          ? Hm[s_x * K + k + smax] + 1 : kNull;
    const int max_all = max(misms, max(max(ins_ext, ins_open),
                                       max(del_ext, del_open)));
    int nmatch = 0;
    bool brk = false;
    if (is_m) {  // match stroke (ref wfa_backtracing.c:198-201)
      nmatch = max(offset - max_all, 0);
      offset = max_all;
      brk = (offset - k <= 0) || (offset <= 0);
    }
    int b = -1;  // priority del_ext > del_open > ins_ext > ins_open > mismatch
    if (!brk) {
      if (max_all == del_ext) b = 0;
      else if (max_all == del_open) b = 1;
      else if (max_all == ins_ext) b = 2;
      else if (max_all == ins_open) b = 3;
      else if (max_all == misms) b = 4;
    }
    int opv = 0;
    if (valid) opv = (b == 0 || b == 1) ? kOpD : (b == 2 || b == 3) ? kOpI
                   : (b == 4) ? kOpX : 0;
    rec[s] = min(nmatch, 0x3FFF) | (opv << 14) | (min(gap_len, 0x7FF) << 16) |
             (gap_d << 27);
    if (b < 0) break;
    cur = (b == 0 || b == 2) ? s_e : (b == 1 || b == 3) ? s_o : s_x;
    if (b == 0 || b == 1) ++k;
    if (b == 2 || b == 3) --k;
    if (b >= 2) --offset;
    btype = (b == 0) ? 2 : (b == 2) ? 1 : (b == 1 || b == 3) ? 0 : btype;
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
