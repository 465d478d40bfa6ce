// K3: banded SWG (Gotoh affine gap, global, minimising), short-read tier,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel aim_tpu/ops/swg_pallas.py::_swg_kernel (launched
// by swg_forward_pallas).  Same function, same output: per pair the banded
// M/I/D recurrence over text rows h = 1..tlen (I from lane b+1 of the
// previous row, the diagonal M term from lane b, the coupled M/D chain as
// one truncated min-plus scan of depth DS), 4-bit codes (M choice D, I,
// match, mismatch; D opened; I opened) and an is-match bit a cell, the
// exactness flags, and the layered event-driven walk that writes
// packed_runs[n, NRL] int16 byte-equal to the reference kernel.  The plain
// version of the same arithmetic is ops/swg.py::swg_reference.
//
// Cells are int32, as in the reference kernel: admission
// (ops/swg.py::swg_int8_sound) proves the reference's int8 tape cannot
// wrap on the configs this tier serves, and the overflow check (compiled in
// only where the static bound fails) flags pairs whose cells near the cell
// type's range.
//
// What bounds it on this card: neither bytes nor tensor math.  A pair reads
// two sequences and writes NRL int16 (32 B at the 100 bp config: C 7, L 16,
// DS 7); the work is tlen dependent rows of a few dozen integer operations
// and 7 lane shifts each, then a walk of dependent steps.  It is latency
// bound, so the design keeps lanes busy, shifts in single shuffles, shared
// memory a pair small (occupancy) and the walk's steps O(1).
//
// Segmented path (L <= 32, every config at the 100 bp width; segment.cuh):
// 32/L pairs a warp, one band lane a thread (2 pairs at L = 16, 4 at 8, 1 at
// 32).  Each of a row's 7 shifts (pm, pi and c; three rounds of the
// truncated D scan; mcur) is one __shfl_up/down_sync of width L; the row's
// 5 ballots serve every pair of the warp; the planes are L-bit words
// (uint16 at L = 16: 1,120 B a pair at the 100 bp config against 2,240 B
// as 32-bit words), in shared memory while a block's share fits in 48 KB.
// The walk's D-run search is one load of the D-opened plane word masked to
// lanes [cb - DS, cb] and one __clz; a match run reads 32/L rows a round
// with one ballot, 32 rows in all (the reference's word boundary).  The
// pairs of a warp step together to its longest text; the walk loops while
// __any_sync says some segment still walks.  4 warps a block,
// __launch_bounds__ with 8 blocks an SM (<= 64 registers a thread).
//
// Wide path (L = 64, 128: int16 cells at larger MAX_SCORE): one warp a
// pair, L/32 band lanes a thread, shifts as shuffle pairs (band.cuh, shared
// with K2); the D-run search reads at most DS/32 + 2 plane words.

#include "band.cuh"
#include "segment.cuh"

namespace {

using namespace aimband;

constexpr int kChD = 0, kChI = 1, kChM = 2, kChX = 3;
constexpr int kLayerM = 0, kLayerI = 1, kLayerD = 2;
constexpr int kPlanes = 5;  // code bits 0..3, is-match

// ---------------------------------------------------------------------------
// wide path: one warp a pair, LPT = L/32 band lanes a thread
// ---------------------------------------------------------------------------

template <int LPT>
__global__ void __launch_bounds__(32 * kWarps) swg_kernel(const BandParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long pair = (long)blockIdx.x * kWarps + warp;
  if (pair >= P.n) return;  // warp-uniform

  unsigned char *base = smem + (size_t)warp * P.warp_bytes;
  uint8_t *sp = base;
  uint8_t *st = base + P.seq_bytes;
  const int stride = kPlanes * P.words;
  uint32_t *planes = P.planes_smem
      ? reinterpret_cast<uint32_t *>(base + 2 * P.seq_bytes)
      : P.scratch + pair * (long)P.R * stride;
  stage_seqs(P, pair, sp, st, lane);

  const int R = P.R, C = P.C, L = P.L, B = 2 * C + 1, DS = P.DS;
  const int mat = P.match, mis = P.mis, go = P.go, ge = P.ge, ms = P.ms;
  const int plen = P.plens[pair], tlen = P.tlens[pair];
  const int kend = plen - tlen;
  const bool aliased = plen == tlen + 1;
  const int kc = kend + C;

  // ---- row-0 triples (ref swg.c:128-137; swg_pallas.py:111-123) ----
  int pm[LPT], pi[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int b = lane + 32 * j, v0 = b - C;
    const bool r0 = v0 >= 0 && v0 <= plen && b < B;
    const int d0 = v0 == 0 ? ms : go + v0 * ge;
    int i0 = ms, m0 = v0 == 0 ? 0 : d0;
    if (aliased && v0 == plen && v0 > 0) i0 = m0 = go + ge;
    pm[j] = r0 ? m0 : kInf;
    pi[j] = r0 ? i0 : kInf;
  }
  __syncwarp();  // staged sequences visible to the warp

  int score = 0;
  bool ovf = false;
  const int hmax = min(tlen, R);
  for (int h = 1; h <= hmax; ++h) {
    // column-0 triple: M = I = GO + h*GE; D = MS (INF from h >= 2 for
    // aliased pairs, swg_pallas.py:147-153)
    const int mb = go + h * ge;
    const int db = (aliased && h >= 2) ? kInf : ms;
    int s1[LPT], s2[LPT], iov[LPT], icur[LPT], c[LPT], z[LPT], dcur[LPT],
        mcur[LPT];
    bool valid[LPT], col0[LPT];
    lane_shift(pm, s1, 1, kInf, L, lane);
    lane_shift(pi, s2, 1, kInf, L, lane);
    const uint8_t tch = st[h - 1];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int b = lane + 32 * j, v = b + h - C;
      valid[j] = v >= 1 && v <= plen && b < B;
      col0[j] = v == 0 && b < B;
      iov[j] = s1[j] + go + ge;
      icur[j] = valid[j] ? min(iov[j], s2[j] + ge) : kInf;
      if (col0[j]) icur[j] = mb;
      const int sub =
          (valid[j] && sp[min(v - 1, R - 1)] != tch) ? mis : mat;
      c[j] = valid[j] ? min(pm[j] + sub, icur[j]) : kInf;
    }
    lane_shift(c, s1, -1, kInf, L, lane);  // c at lane b-1
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int b = lane + 32 * j, v = b + h - C;
      // M at lane b-1 when that lane is the column-0 cell (v == 1 here)
      const int m_left = (b >= 1 && v == 1 && b - 1 < B) ? mb : kInf;
      int zz = col0[j] ? db : (v == 1 ? m_left + go + ge : s1[j] + go + ge);
      zz = (valid[j] || col0[j]) ? zz : kInf;
      z[j] = zz - b * ge;
    }
    trunc_min(z, DS, L, lane);  // the D chain
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int b = lane + 32 * j;
      const bool live = valid[j] || col0[j];
      dcur[j] = live ? z[j] + b * ge : kInf;
      int m = min(c[j], dcur[j]);
      if (col0[j]) m = mb;
      mcur[j] = live ? m : kInf;
    }
    if (P.check_ovf) {
      bool o = false;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int mx = max(abs(mcur[j]), max(abs(icur[j]), abs(dcur[j])));
        o = o || (valid[j] && mx > P.cmax - P.margin && mx < kInf / 2);
      }
      ovf = ovf || __any_sync(kFull, o);
    }
    if (P.backtrace) {
      lane_shift(mcur, s2, -1, kInf, L, lane);  // M at lane b-1
      int code[LPT];
      bool ism[LPT];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        const int choice = mcur[j] == dcur[j]      ? kChD
                         : mcur[j] == icur[j]      ? kChI
                         : mcur[j] == pm[j] + mat  ? kChM : kChX;
        const int d_open = dcur[j] == s2[j] + go + ge;
        const int i_open = icur[j] == iov[j];
        code[j] = valid[j] ? (choice | (d_open << 2) | (i_open << 3)) : kChM;
        ism[j] = valid[j] && choice == kChM;
      }
      store_planes(planes + (long)(h - 1) * stride, code, ism, 4, P.words, L,
                   lane);
    }
    if (h == tlen && kc >= 0 && kc < B) score = lane_value(mcur, kc);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      pm[j] = mcur[j];
      pi[j] = icur[j];
    }
  }

  // ---- exactness flags (swg_pallas.py:232-261) ----
  if (plen == 0 || tlen == 0) score = 0;
  const int dmax = floordiv(max(0, score - 2 * go), 2 * ge) + 1;
  const int hs = C + dmax + 3;
  bool flag =
      plen > tlen + 1 || abs(kend) + dmax + 1 > C ||
      floordiv(score - ms, ge) + dmax > C ||
      (aliased &&
       ((2 * go + (hs + 1) * ge > (plen - hs - 1) * ge) || mat < 0)) ||
      ovf || go + max(plen, tlen) * ge + P.margin > P.cmax ||
      ms + P.margin > P.cmax || floordiv(score, ge) > DS ||
      plen > tlen + C || tlen > plen + C || score < 0;

  int16_t *rec = P.rec + pair * (long)P.NRL;
  for (int j = lane; j < P.NRL; j += 32) rec[j] = 0;
  Runs out{rec, P.NRL, P.NRL - 1, 0, 0, lane == 0};
  __syncwarp();  // planes and the zeroed record visible to the warp
  if (P.backtrace) {
    // ---- layered event-driven walk (swg_pallas.py:301-383) ----
    int hcur = tlen, vcur = plen, layer = kLayerM;
    for (int it = 0; it < 3 * R + 4 && hcur > 0 && vcur > 0; ++it) {
      const int hm1 = min(hcur - 1, R - 1);
      const uint32_t *row = planes + (long)hm1 * stride;
      const int bb = vcur - hcur + C;
      const int cb = max(0, min(bb, L - 1));
      const int choice = plane_bit(row, 0, P.words, cb) |
                         (plane_bit(row, 1, P.words, cb) << 1);
      const int io = plane_bit(row, 3, P.words, cb);
      // I layer: one 'I' a row; I opened at the cell returns the walk to M
      const bool in_i = layer == kLayerI;
      out.emit(in_i, kOpI, 1);
      if (in_i && io == 1) layer = kLayerM;
      // M layer: one chain link an iteration
      const bool in_m = layer == kLayerM && !in_i;
      const bool is_d = in_m && choice == kChD;
      int dlen = 0;
      if (is_d) {  // D-run: stops at the first opened D (inclusive)
        const int lo = max(0, cb - DS);
        int pmd = -1;
        for (int q = cb >> 5; q >= lo >> 5 && pmd < 0; --q) {
          const int top = q == cb >> 5 ? cb & 31 : 31;
          const int bot = q == lo >> 5 ? lo & 31 : 0;
          const int at = last_set_in(row[2 * P.words + q], bot, top);
          if (at >= 0) pmd = 32 * q + at;
        }
        dlen = bb - pmd + 1;
      }
      const bool capped = is_d && dlen >= vcur;
      dlen = min(dlen, vcur);
      out.emit(is_d, kOpD, dlen);
      if (capped) layer = kLayerD;  // exits through v == 0
      const bool is_i = in_m && choice == kChI;
      const bool is_x = in_m && choice == kChX;
      const bool is_m = in_m && choice == kChM;
      int mrun = match_run(planes, stride, 4, P.words, hm1, cb, lane);
      mrun = is_m ? min(mrun, min(vcur, hcur)) : 0;
      out.emit(is_i || is_m || is_x, is_i ? kOpI : is_m ? kOpM : kOpX,
               is_m ? mrun : 1);
      if (is_i) layer = io == 1 ? kLayerM : kLayerI;
      hcur -= (in_i || is_i || is_x) ? 1 : mrun;
      vcur -= is_x ? 1 : dlen + mrun;
    }
    // tails (ref swg.c:111-117); the iteration cap flags stragglers
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
    swg_seg_kernel(const SegParams P) {
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
  const int mat = P.match, mis = P.mis, go = P.go, ge = P.ge, ms = P.ms;
  const int plen = live ? P.plens[pair] : 0;
  const int tlen = live ? P.tlens[pair] : 0;
  const int kend = plen - tlen;
  const bool aliased = plen == tlen + 1;
  const int kc = kend + C;

  // ---- row-0 triples (ref swg.c:128-137; swg_pallas.py:111-123) ----
  int pm, pi;
  {
    const int v0 = b - C;
    const bool r0 = v0 >= 0 && v0 <= plen && b < B;
    const int d0 = v0 == 0 ? ms : go + v0 * ge;
    int i0 = ms, m0 = v0 == 0 ? 0 : d0;
    if (aliased && v0 == plen && v0 > 0) i0 = m0 = go + ge;
    pm = r0 ? m0 : kInf;
    pi = r0 ? i0 : kInf;
  }
  __syncwarp();  // staged sequences visible to the warp

  bool ovf = false;
  const int hmax = min(tlen, R);
  const int hall = __reduce_max_sync(kFull, hmax);
  for (int h = 1; h <= hall; ++h) {
    const bool act = h <= hmax;
    // column-0 triple: M = I = GO + h*GE; D = MS (INF from h >= 2 for
    // aliased pairs, swg_pallas.py:147-153)
    const int mb = go + h * ge;
    const int db = (aliased && h >= 2) ? kInf : ms;
    const int s1 = seg_next<L>(pm, b, kInf);
    const int s2 = seg_next<L>(pi, b, kInf);
    const uint8_t tch = st[min(h - 1, P.seq_bytes - 1)];
    const int v = b + h - C;
    const bool valid = v >= 1 && v <= plen && b < B;
    const bool col0 = v == 0 && b < B;
    const int iov = s1 + go + ge;
    int icur = valid ? min(iov, s2 + ge) : kInf;
    if (col0) icur = mb;
    const int sub = (valid && sp[min(v - 1, R - 1)] != tch) ? mis : mat;
    const int c = valid ? min(pm + sub, icur) : kInf;
    const int cl = seg_prev<L>(c, 1, b, kInf);  // c at lane b-1
    // M at lane b-1 when that lane is the column-0 cell (v == 1 here)
    const int m_left = (b >= 1 && v == 1 && b - 1 < B) ? mb : kInf;
    int zz = col0 ? db : (v == 1 ? m_left + go + ge : cl + go + ge);
    zz = (valid || col0) ? zz : kInf;
    const int z = seg_trunc_min<L>(zz - b * ge, DS, b);  // the D chain
    const bool livec = valid || col0;
    const int dcur = livec ? z + b * ge : kInf;
    int m = min(c, dcur);
    if (col0) m = mb;
    const int mcur = livec ? m : kInf;
    if (P.check_ovf) {
      const int mx = max(abs(mcur), max(abs(icur), abs(dcur)));
      const bool o = act && valid && mx > P.cmax - P.margin && mx < kInf / 2;
      ovf = ovf || seg_bits<L>(__ballot_sync(kFull, o), seg0) != 0u;
    }
    if (P.backtrace) {
      const int ml = seg_prev<L>(mcur, 1, b, kInf);  // M at lane b-1
      const int choice = mcur == dcur      ? kChD
                       : mcur == icur      ? kChI
                       : mcur == pm + mat  ? kChM : kChX;
      const int d_open = dcur == ml + go + ge;
      const int i_open = icur == iov;
      const int code = valid ? (choice | (d_open << 2) | (i_open << 3)) : kChM;
      const bool ism = valid && choice == kChM;
      // plane p of the row: code bit p (p < 4), is-match (p = 4); lane p
      // of the segment stores it
      unsigned word = 0;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const bool bit = p < 4 ? ((code >> p) & 1) : ism;
        const unsigned u = seg_bits<L>(__ballot_sync(kFull, bit), seg0);
        if (b == p) word = u;
      }
      if (act && b < kPlanes) planes[(long)(h - 1) * kPlanes + b] = (W)word;
    }
    if (act) {
      pm = mcur;
      pi = icur;
    }
  }
  // score: M at band lane kc of row tlen, which pm holds once the pair's
  // rows are done
  const int at_kc = __shfl_sync(kFull, pm, max(0, min(kc, L - 1)), L);
  int score = (tlen >= 1 && tlen <= R && kc >= 0 && kc < B) ? at_kc : 0;

  // ---- exactness flags (swg_pallas.py:232-261) ----
  if (plen == 0 || tlen == 0) score = 0;
  const int dmax = floordiv(max(0, score - 2 * go), 2 * ge) + 1;
  const int hs = C + dmax + 3;
  bool flag =
      plen > tlen + 1 || abs(kend) + dmax + 1 > C ||
      floordiv(score - ms, ge) + dmax > C ||
      (aliased &&
       ((2 * go + (hs + 1) * ge > (plen - hs - 1) * ge) || mat < 0)) ||
      ovf || go + max(plen, tlen) * ge + P.margin > P.cmax ||
      ms + P.margin > P.cmax || floordiv(score, ge) > DS ||
      plen > tlen + C || tlen > plen + C || score < 0;

  int16_t *rec = P.rec + (live ? pair : 0) * (long)P.NRL;
  if (live)
    for (int j = b; j < P.NRL; j += L) rec[j] = 0;
  Runs out{rec, P.NRL, P.NRL - 1, 0, 0, live && b == 0};
  __syncwarp();  // planes and the zeroed records visible to the warp
  if (P.backtrace) {
    // ---- layered event-driven walk (swg_pallas.py:301-383) ----
    int hcur = tlen, vcur = plen, layer = kLayerM, it = 0;
    bool walking = live && hcur > 0 && vcur > 0;
    while (__any_sync(kFull, walking)) {
      const int hm1 = max(0, min(hcur - 1, R - 1));
      const W *row = planes + (long)hm1 * kPlanes;
      const int bb = vcur - hcur + C;
      const int cb = max(0, min(bb, L - 1));
      const int mr = seg_match_run<L>(planes, kPlanes, 4, hm1, cb, b, seg0);
      if (walking) {
        const int choice = ((row[0] >> cb) & 1) | (((row[1] >> cb) & 1) << 1);
        const int io = (row[3] >> cb) & 1;
        // I layer: one 'I' a row; I opened at the cell returns the walk to M
        const bool in_i = layer == kLayerI;
        out.emit(in_i, kOpI, 1);
        if (in_i && io == 1) layer = kLayerM;
        // M layer: one chain link an iteration
        const bool in_m = layer == kLayerM && !in_i;
        const bool is_d = in_m && choice == kChD;
        // D-run: stops at the first opened D (inclusive), lanes [cb-DS, cb]
        int dlen = is_d ? bb - last_set_in(row[2], max(0, cb - DS), cb) + 1
                        : 0;
        const bool capped = is_d && dlen >= vcur;
        dlen = min(dlen, vcur);
        out.emit(is_d, kOpD, dlen);
        if (capped) layer = kLayerD;  // exits through v == 0
        const bool is_i = in_m && choice == kChI;
        const bool is_x = in_m && choice == kChX;
        const bool is_m = in_m && choice == kChM;
        const int mrun = is_m ? min(mr, min(vcur, hcur)) : 0;
        out.emit(is_i || is_m || is_x, is_i ? kOpI : is_m ? kOpM : kOpX,
                 is_m ? mrun : 1);
        if (is_i) layer = io == 1 ? kLayerM : kLayerI;
        hcur -= (in_i || is_i || is_x) ? 1 : mrun;
        vcur -= is_x ? 1 : dlen + mrun;
        ++it;
        walking = it < 3 * R + 4 && hcur > 0 && vcur > 0;
      }
    }
    // tails (ref swg.c:111-117); the iteration cap flags stragglers
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
  return L == 8 ? swg_seg_kernel<8> : L == 16 ? swg_seg_kernel<16>
                                              : swg_seg_kernel<32>;
}

}  // namespace

extern "C" {

// Launches K3 on `stream`.  Returns cudaGetLastError() after the launch (0
// on success); the caller raises on anything else.
int aim_swg_forward(const void *pats, const void *txts, const void *plens,
                    const void *tlens, void *rec, void *scratch, long n,
                    int width, int packed, int R, int C, int L, int NRL,
                    int DS, int match, int mismatch, int gap_o, int gap_e,
                    int max_score, int cmax, int margin, int check_ovf,
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
  P.match = match;
  P.mis = mismatch;
  P.go = gap_o;
  P.ge = gap_e;
  P.ms = max_score;
  P.cmax = cmax;
  P.margin = margin;
  P.check_ovf = check_ovf;
  P.backtrace = backtrace;
  P.planes_smem = planes_smem;
  if (L <= 32) return launch_seg(P, seg_kernel(L), stream);
  return launch_wide(P, swg_kernel<2>, swg_kernel<4>, stream);
}

// What K3 runs at (R, L): out = {registers a thread, local (spill) bytes a
// thread, dynamic shared memory a block, resident blocks an SM, pairs a
// warp, 0}.  Returns a cudaError_t (0 on success).
int aim_swg_info(int R, int L, int backtrace, int planes_smem, int *out) {
  SegParams P{};
  P.R = R;
  P.L = L;
  P.planes = kPlanes;
  P.backtrace = backtrace;
  P.planes_smem = planes_smem;
  if (L <= 32) return band_info(seg_kernel(L), seg_plan(P), 32 / L, out);
  if (L != 64 && L != 128) return (int)cudaErrorInvalidValue;
  P.words = L / 32;
  return band_info(L == 64 ? swg_kernel<2> : swg_kernel<4>,
                   (size_t)warp_bytes(P, planes_smem != 0) * kWarps, 1, out);
}

}  // extern "C"
