// K4: GenASM bitvector edit distance, short-read tier, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel aim_tpu/ops/genasm_pallas.py::_genasm_kernel
// (with its _sel_matrix prologue; launched by genasm_forward_pallas).  Same
// function, same output: per pair and text position i = 1..tlen, the
// bitvectors B_d (bit j set iff ed(pattern[:j], text[:i]) <= d, d = 0..k)
// from B^{i-1} and the pattern mask of text[i-1]; the deletion term, a
// prefix dependency along d, closed by log-doubling shifted ORs; the score,
// the lowest d with bit plen set in B^{tlen}; then the traceback over text
// levels i = tlen..1, writing genasm_records[n, R+4] int32 byte-equal to
// the reference kernel (rows 0..R levels, R+1/R+2 final strokes, R+3
// score).  The plain version is ops/genasm.py::genasm_reference.
//
// Words: the reference packs 28 bits a word (a TPU relay bound); here a
// d-group is Wg = ceil((R+2)/32) words of 32 bits, DW = (k+1)*Wg rows.
// Records cannot differ: shifts move bits only upward and the d-group
// alignment keeps a bit at its j, so the bits above R+1, where the two
// layouts differ, never reach the bits that are read.
//
// What bounds it on this card: neither bytes nor tensor math.  A pair reads
// 2 x 30 packed bytes and writes 464 record bytes at the 100 bp config
// (R 112, k 2, Wg 4, DW 12); the work is tlen dependent steps of a few
// word operations a row, then one walk step a text level.  It is latency
// bound: what counts is lanes kept busy, row exchanges that stay in
// registers, shared memory a pair (which sets the warps an SM holds) and
// the dependent chain of the walk.
//
// Segmented path (DW <= 32; every config up to k 7 at the 100 bp width):
// - A pair owns a segment of S lanes, S the smallest power of two >= DW, so
//   32/S pairs share a warp (2 at the 100 bp config).  Lane r of a segment
//   keeps row r of B in a register and its own word of the four pattern
//   masks; the text code of step i is a broadcast read of the staged codes.
// - The update and each doubling read rows r-1, r-Wg, r-Wg-1, r-s*Wg and
//   r-s*Wg-1 with __shfl_up_sync of width S (a read below the segment
//   returns the lane's own value, and the row guards mask it): no shared
//   row buffers and no __syncwarp in the forward loop.
// - The pairs of a warp step together to the warp's longest text; a pair
//   past its own tlen keeps B^{tlen} and writes nothing.
// - Windowed history (k <= 6).  A walk starts only if score <= k, so
//   |plen - tlen| <= score <= k (bit j of B_d^i means ed <= d, and ed >=
//   |j - i|).  Each D-run step and each I step spends one unit of the
//   budget dd and moves jj - i by one; diagonal steps keep it.  So jj - i
//   stays within [-2k, 2k] at every point of the walk.  At level l the walk
//   reads the anti bits jj-dd+g, g < dd, of B^l (within [l-3k, l+2k-1]) and,
//   one level up, the I-check bit jj of B^l (within [l+1-2k, l+1+2k]): only
//   bits [l-3k, l+2k+1], 5k+2 <= 32 of them.  A level keeps one 32-bit
//   window a group starting at bit l-3k, k+1 words, built by lane g <= k
//   from the two words of its group that straddle it (two shuffles and a
//   funnel shift); 113 x 3 x 4 = 1,356 B a pair at the 100 bp config
//   against 5,424 B for the full volume.  For k > 6 the full volume stays,
//   each lane writing its row a level.
// - The walk runs per segment: lane g <= k reads its group's bit, one
//   ballot shifted down to the segment's base lane gives the anti word,
//   __clz the D-run.  Collectives stay warp-uniform: the level loop runs
//   while __any_sync says some segment still walks, and finished segments
//   idle through it (pairs of a warp walk different lengths; one may
//   overflow or be empty, or be past the batch's end).
// - 4 warps a block, __launch_bounds__ with 8 blocks an SM (<= 64 registers
//   a thread); the history stays in shared memory while a block's share fits
//   in 48 KB, which every windowed config the gate admits does.
//
// Wide path (DW > 32: k >= 8 at R 112, up to 150 rows at the gate's edge):
// one warp a pair, its rows over the lanes (row r = lane + 32*t), each step
// a few phases over two row buffers in shared memory that swap at a
// __syncwarp; the full history in shared memory while a block's share fits
// in 48 KB, else in a global scratch the wrapper allocates.
//
// Score-only runs keep no history on either path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps a block (WARPS in ops/genasm.py)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOpM = 0, kOpX = 1, kOpI = 2, kOpD = 3;
constexpr int kWindowMaxK = 6;  // 5k + 2 <= 32 (WINDOW_MAX_K)
constexpr int kSmemHistLimit = 48 * 1024;

struct Params {
  const uint8_t *pats, *txts;  // [n][width] 2-bit codes, 4 a byte, low first
  const int32_t *plens, *tlens;
  int32_t *rec;                // [n][R+4]
  uint32_t *scratch;           // [n][hist_words] when the history is global
  long n;
  int width;                   // bytes per sequence row
  int R, k, Rp, Wg, DW;
  int windowed;                // segmented path with k <= 6
  int hist_words;              // history words a pair
  int backtrace, hist_smem;
  int pair_bytes;              // shared memory a pair (segmented path)
  int warp_bytes;              // shared memory a warp (wide path)
};

__device__ __forceinline__ int code_at(const uint8_t *row, int width, int j) {
  const int byte = j >> 2;
  return byte < width ? (row[byte] >> (2 * (j & 3))) & 3 : 0;
}

// Row r (word w of its group) of buf shifted up by one bit within its group.
__device__ __forceinline__ uint32_t shl1(const uint32_t *buf, int r, int w) {
  return (buf[r] << 1) | (w >= 1 ? buf[r - 1] >> 31 : 0u);
}

// ---------------------------------------------------------------------------
// segmented path: S lanes a pair, a row a lane
// ---------------------------------------------------------------------------

template <int S>
__global__ void __launch_bounds__(32 * kWarps, 8)
    genasm_seg_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPairs = 32 / S;
  constexpr unsigned kSegMask = S == 32 ? kFull : ((1u << S) - 1u);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sl = lane & (S - 1);  // the row this lane holds
  const int seg0 = lane - sl;
  const long first = ((long)blockIdx.x * kWarps + warp) * kPairs;
  if (first >= P.n) return;  // warp-uniform
  const long pair = first + lane / S;
  const bool live = pair < P.n;

  const int R = P.R, k = P.k, Rp = P.Rp, Wg = P.Wg, DW = P.DW;
  const bool keep = P.backtrace != 0;  // the walk needs the history
  unsigned char *wbase = smem + (size_t)warp * kPairs * P.pair_bytes;

  // ---- stage the warp's codes, zero past the input width ----
  for (int idx = lane; idx < kPairs * Rp; idx += 32) {
    const int q = idx / Rp, j = idx - q * Rp;
    if (first + q < P.n) {
      uint8_t *b = wbase + (size_t)q * P.pair_bytes;
      b[j] = (uint8_t)code_at(P.pats + (first + q) * P.width, P.width, j);
      b[Rp + j] = (uint8_t)code_at(P.txts + (first + q) * P.width, P.width, j);
    }
  }
  __syncwarp();
  const uint8_t *sp = wbase + (size_t)(lane / S) * P.pair_bytes;
  const uint8_t *st = sp + Rp;
  uint32_t *hist = nullptr;
  if (keep)
    hist = P.hist_smem
        ? reinterpret_cast<uint32_t *>(const_cast<uint8_t *>(sp) + 2 * Rp)
        : P.scratch + (live ? pair : 0) * (long)P.hist_words;

  // plen, tlen <= R by contract; the clamps keep a caller that breaks it
  // inside the history.  A segment past the batch's end has neither.
  const int plen = live ? min(P.plens[pair], R) : 0;
  const int tlen = live ? min(P.tlens[pair], R) : 0;
  const int g = sl / Wg, w = sl - g * Wg;
  const bool row_ok = sl < DW;

  // ---- this lane's word of the pattern masks: bit b of word w set iff
  // j = 32w + b lies in [1, Rp] and pattern[j-1] == sym ----
  uint32_t lo = 0, hi = 0, in = 0;
  for (int b = 0; b < 32; ++b) {
    const int j = 32 * w + b;
    if (j >= 1 && j <= Rp) {
      const int c = sp[j - 1];
      lo |= (uint32_t)(c & 1) << b;
      hi |= (uint32_t)((c >> 1) & 1) << b;
      in |= 1u << b;
    }
  }
  const uint32_t pm0 = in & ~lo & ~hi, pm1 = in & lo & ~hi,
                 pm2 = in & ~lo & hi, pm3 = in & lo & hi;

  // ---- B^0: bit j of group g set iff j <= g ----
  const int nb = min(max(g - 32 * w + 1, 0), 32);
  uint32_t cur = nb >= 32 ? kFull : ((1u << nb) - 1u);

  // one history level: the full rows, or lane g <= k's window of bits
  // [lvl - 3k, lvl - 3k + 31] of group g, zero outside the group's words
  auto store = [&](int lvl, bool act) {
    if (P.windowed) {
      const int base = lvl - 3 * k;
      const int wlo = base >> 5, sh = base & 31;  // floor, also below 0
      const int q = min(sl, k) * Wg + wlo;
      const uint32_t x0 = __shfl_sync(kFull, cur, min(max(q, 0), S - 1), S);
      const uint32_t x1 =
          __shfl_sync(kFull, cur, min(max(q + 1, 0), S - 1), S);
      const uint64_t both =
          ((uint64_t)(wlo + 1 >= 0 && wlo + 1 < Wg ? x1 : 0u) << 32) |
          (wlo >= 0 && wlo < Wg ? x0 : 0u);
      if (act && sl <= k) hist[(long)lvl * (k + 1) + sl] = (uint32_t)(both >> sh);
    } else if (act && row_ok) {
      hist[(long)lvl * DW + sl] = cur;
    }
  };
  if (keep) store(0, live);

  // ---- forward over text positions, the warp's pairs together ----
  const int tmax = __reduce_max_sync(kFull, tlen);
  for (int i = 1; i <= tmax; ++i) {
    const bool act = i <= tlen;
    const int sym = st[min(i - 1, Rp - 1)] & 3;
    const uint32_t pmw = sym == 0 ? pm0 : sym == 1 ? pm1 : sym == 2 ? pm2 : pm3;
    // B_d = (shl1(B_d) & PM) | shl1(B_{d-1}) | B_{d-1}, plus the
    // empty-pattern bit for d >= i
    const uint32_t a1 = __shfl_up_sync(kFull, cur, 1, S);
    const uint32_t aw = __shfl_up_sync(kFull, cur, Wg, S);
    const uint32_t aw1 = __shfl_up_sync(kFull, cur, Wg + 1, S);
    uint32_t u = ((cur << 1) | (w >= 1 ? a1 >> 31 : 0u)) & pmw;
    if (g >= 1) u |= (aw << 1) | (w >= 1 ? aw1 >> 31 : 0u) | aw;
    if (w == 0 && g >= i) u |= 1u;
    // the deletion term: B_d |= B_{d-s} << s, s = 1, 2, 4, ... <= k
    for (int s = 1; s <= k; s *= 2) {
      const uint32_t b0 = __shfl_up_sync(kFull, u, s * Wg, S);
      const uint32_t b1 = __shfl_up_sync(kFull, u, s * Wg + 1, S);
      if (g >= s) u |= (b0 << s) | (w >= 1 ? b1 >> (32 - s) : 0u);
    }
    if (act) cur = u;
    if (keep) store(i, act);
  }

  // ---- score: the lowest d with bit plen set in B^{tlen} ----
  const bool hit =
      row_ok && w == (plen >> 5) && ((cur >> (plen & 31)) & 1u);
  const unsigned hits = (__ballot_sync(kFull, hit) >> seg0) & kSegMask;
  const int score = hits ? (__ffs((int)hits) - 1) / Wg : k + 1;

  int32_t *rec = P.rec + (live ? pair : 0) * (long)(R + 4);
  if (live)
    for (int j = sl; j < R + 4; j += S) rec[j] = (j == R + 3) ? score : 0;
  __syncwarp();  // zeroed records and history visible to the warp
  if (live && score > k && sl == 0)
    rec[R + 1] = (kOpM << 14) | 1;  // the oracle's single-'M' record
  if (!keep) return;  // warp-uniform

  // bit pos of group grp in history level lvl
  auto hbit = [&](int lvl, int grp, int pos) -> bool {
    if (P.windowed) {
      const int o = pos - (lvl - 3 * k);
      return o >= 0 && o < 32 &&
             ((hist[(long)lvl * (k + 1) + grp] >> o) & 1u);
    }
    return (hist[(long)lvl * DW + grp * Wg + (pos >> 5)] >> (pos & 31)) & 1u;
  };

  // ---- traceback over text levels i = tlen..1, per segment ----
  // jj: pattern position, dd: edit budget left, ti: text position.  A level
  // writes one record: a D-run (anti-diagonal ones-run of B^i from
  // (dd-1, jj-1) down), then one text-consuming op, I before diagonal.
  int jj = plen, dd = score, ti = tlen, i = tlen;
  bool walking = live && score <= k && i >= 1 && jj > 0;
  while (__any_sync(kFull, walking)) {
    // anti bit g = bit (jj - dd + g) of group g, g = sl <= k
    bool bit = false;
    if (walking && sl <= k) {
      const int bpos = jj - dd + sl;
      bit = bpos >= 0 && bpos <= R + 1 && hbit(i, sl, bpos);
    }
    const unsigned anti = (__ballot_sync(kFull, bit) >> seg0) & kSegMask;
    if (walking) {
      // leading ones of anti from bit dd-1 down (zeros below bit 0)
      const unsigned y = dd >= 1 ? anti << (32 - dd) : 0u;
      const int L = min(min(__clz((int)~y), dd), jj);
      jj -= L;
      dd -= L;
      const bool act2 = jj > 0;
      // I-check: bit jj of group dd-1 in B^{i-1}
      const bool i_ok = act2 && dd >= 1 && hbit(i - 1, dd - 1, jj);
      const bool diag = act2 && !i_ok;
      const bool is_m = diag && sp[jj - 1] == st[i - 1];
      const bool is_x = diag && !is_m;
      const int opv = i_ok ? kOpI : is_x ? kOpX : 0;
      if (sl == 0)
        rec[i] = (int)is_m | (opv << 14) | (min(L, 0x7FF) << 16) |
                 ((int)(L > 0) << 27);
      if (act2) {
        if (diag) jj -= 1;
        if (i_ok || is_x) dd -= 1;
        ti -= 1;
        i -= 1;
      }
      walking = act2 && i >= 1 && jj > 0;  // else the walk ends here
    }
  }
  // ---- final strokes: leftover pattern (D), then text (I) ----
  if (live && score <= k && sl == 0) {
    if (jj > 0) rec[R + 1] = min(jj, 0x3FFF) | (kOpD << 14);
    if (ti > 0) rec[R + 2] = min(ti, 0x3FFF) | (kOpI << 14);
  }
}

// ---------------------------------------------------------------------------
// wide path: one warp a pair, rows in shared memory
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32 * kWarps)
    genasm_wide_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long pair = (long)blockIdx.x * kWarps + warp;
  if (pair >= P.n) return;  // warp-uniform

  const int R = P.R, k = P.k, Rp = P.Rp, Wg = P.Wg, DW = P.DW;
  const bool keep = P.backtrace != 0;  // the walk needs the history
  unsigned char *base = smem + (size_t)warp * P.warp_bytes;
  uint32_t *pm = reinterpret_cast<uint32_t *>(base);  // [4][Wg]
  uint32_t *cur = pm + 4 * Wg;                        // [DW] B^{i-1}
  uint32_t *nxt = cur + DW;                           // [DW]
  uint32_t *end = nxt + DW;
  uint32_t *hist = nullptr;                           // [R+1][DW]
  if (keep && P.hist_smem) {
    hist = end;
    end += (long)(R + 1) * DW;
  } else if (keep) {
    hist = P.scratch + pair * (long)P.hist_words;
  }
  uint8_t *sp = reinterpret_cast<uint8_t *>(end);
  uint8_t *st = sp + Rp;

  const int plen = min(P.plens[pair], R), tlen = min(P.tlens[pair], R);

  // ---- stage the codes, zero past the input width ----
  {
    const uint8_t *gp = P.pats + pair * P.width;
    const uint8_t *gt = P.txts + pair * P.width;
    for (int j = lane; j < Rp; j += 32) {
      sp[j] = (uint8_t)code_at(gp, P.width, j);
      st[j] = (uint8_t)code_at(gt, P.width, j);
    }
  }
  __syncwarp();
  // ---- pattern masks: bit j of group word w = j/32 set iff 1 <= j <= Rp
  // and pattern[j-1] == sym ----
  for (int w = 0; w < Wg; ++w) {
    const int j = 32 * w + lane;
    const int c = (j >= 1 && j <= Rp) ? sp[j - 1] : -1;
    for (int sym = 0; sym < 4; ++sym) {
      const unsigned bits = __ballot_sync(kFull, c == sym);
      if (lane == 0) pm[sym * Wg + w] = bits;
    }
  }
  // ---- B^0: bit j of group g set iff j <= g ----
  for (int r = lane; r < DW; r += 32) {
    const int g = r / Wg, w = r - g * Wg;
    const int nb = min(max(g - 32 * w + 1, 0), 32);
    const uint32_t v = nb >= 32 ? kFull : ((1u << nb) - 1u);
    cur[r] = v;
    if (keep) hist[r] = v;
  }
  __syncwarp();

  // ---- forward over text positions ----
  for (int i = 1; i <= tlen; ++i) {
    const uint32_t *pmw = pm + st[i - 1] * Wg;
    for (int r = lane; r < DW; r += 32) {
      const int g = r / Wg, w = r - g * Wg;
      uint32_t u = shl1(cur, r, w) & pmw[w];
      if (g >= 1) u |= shl1(cur, r - Wg, w) | cur[r - Wg];
      if (w == 0 && g >= i) u |= 1u;
      nxt[r] = u;
    }
    __syncwarp();
    uint32_t *t = cur;
    cur = nxt;
    nxt = t;
    for (int s = 1; s <= k; s *= 2) {
      for (int r = lane; r < DW; r += 32) {
        const int g = r / Wg, w = r - g * Wg;
        uint32_t u = cur[r];
        if (g >= s) {
          const int q = r - s * Wg;
          u |= cur[q] << s;
          if (w >= 1) u |= cur[q - 1] >> (32 - s);
        }
        nxt[r] = u;
      }
      __syncwarp();
      t = cur;
      cur = nxt;
      nxt = t;
    }
    if (keep)
      for (int r = lane; r < DW; r += 32) hist[(long)i * DW + r] = cur[r];
  }

  // ---- score: the lowest d with bit plen set in B^{tlen} ----
  int cand = k + 1;
  {
    const int wp = plen >> 5, bp = plen & 31;
    for (int r = lane; r < DW; r += 32) {
      const int g = r / Wg, w = r - g * Wg;
      if (w == wp && ((cur[r] >> bp) & 1)) cand = min(cand, g);
    }
  }
  const int score = __reduce_min_sync(kFull, cand);

  int32_t *rec = P.rec + pair * (long)(R + 4);
  for (int j = lane; j < R + 4; j += 32) rec[j] = (j == R + 3) ? score : 0;
  __syncwarp();  // zeroed record and history rows visible to the warp
  if (score > k) {
    if (lane == 0) rec[R + 1] = (kOpM << 14) | 1;
    return;
  }
  if (!keep) return;

  // ---- traceback over text levels i = tlen..1 (as the segmented path) ----
  int jj = plen, dd = score, ti = tlen;
  for (int i = tlen; i >= 1 && jj > 0; --i) {
    const uint32_t *Bi = hist + (long)i * DW;
    const uint32_t *Bp = hist + (long)(i - 1) * DW;
    const int bpos = jj - dd + lane;
    bool bit = false;
    if (lane <= k && bpos >= 0 && bpos <= R + 1)
      bit = (Bi[lane * Wg + (bpos >> 5)] >> (bpos & 31)) & 1;
    const unsigned anti = __ballot_sync(kFull, bit);
    const unsigned y = dd >= 1 ? anti << (32 - dd) : 0u;
    const int L = min(min(__clz((int)~y), dd), jj);
    jj -= L;
    dd -= L;
    const bool act2 = jj > 0;
    const bool i_ok = act2 && dd >= 1 &&
                      ((Bp[(dd - 1) * Wg + (jj >> 5)] >> (jj & 31)) & 1);
    const bool diag = act2 && !i_ok;
    const bool is_m = diag && sp[jj - 1] == st[i - 1];
    const bool is_x = diag && !is_m;
    const int opv = i_ok ? kOpI : is_x ? kOpX : 0;
    if (lane == 0)
      rec[i] = (int)is_m | (opv << 14) | (min(L, 0x7FF) << 16) |
               ((int)(L > 0) << 27);
    if (!act2) break;
    if (diag) jj -= 1;
    if (i_ok || is_x) dd -= 1;
    ti -= 1;
  }
  if (lane == 0) {
    if (jj > 0) rec[R + 1] = min(jj, 0x3FFF) | (kOpD << 14);
    if (ti > 0) rec[R + 2] = min(ti, 0x3FFF) | (kOpI << 14);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef void (*Kernel)(const Params);

// The launch geometry of (R, k): the path, its kernel, the history and the
// shared memory a block (ops/genasm.py mirrors it: seg_lanes,
// hist_windowed, hist_bytes_per_pair, warp_smem_bytes).
struct Plan {
  Kernel kern;
  int S;          // lanes a pair, 0 on the wide path
  int pairs;      // pairs a block
  size_t smem;    // dynamic shared memory a block
};

Plan plan(Params &P) {
  P.Wg = (P.R + 2 + 31) / 32;
  P.DW = (P.k + 1) * P.Wg;
  Plan pl{};
  if (P.DW <= 32) {
    int S = 1;
    while (S < P.DW) S *= 2;
    pl.S = S;
    P.windowed = P.k <= kWindowMaxK;
  } else {
    P.windowed = 0;
  }
  P.hist_words = (P.R + 1) * (P.windowed ? P.k + 1 : P.DW);
  const long hist = P.backtrace && P.hist_smem ? 4L * P.hist_words : 0;
  if (pl.S) {
    const long pb = (2L * P.Rp + hist + 15) / 16 * 16;
    P.pair_bytes = (int)pb;
    pl.pairs = kWarps * (32 / pl.S);
    pl.smem = (size_t)pb * pl.pairs;
    switch (pl.S) {
      case 1: pl.kern = genasm_seg_kernel<1>; break;
      case 2: pl.kern = genasm_seg_kernel<2>; break;
      case 4: pl.kern = genasm_seg_kernel<4>; break;
      case 8: pl.kern = genasm_seg_kernel<8>; break;
      case 16: pl.kern = genasm_seg_kernel<16>; break;
      default: pl.kern = genasm_seg_kernel<32>; break;
    }
  } else {
    const long wb = (4L * (4 * P.Wg + 2 * P.DW) + 2L * P.Rp + hist + 15) /
                    16 * 16;
    P.warp_bytes = (int)wb;
    pl.pairs = kWarps;
    pl.smem = (size_t)wb * kWarps;
    pl.kern = genasm_wide_kernel;
  }
  return pl;
}

bool bad_args(int R, int k, int width, int Rp) {
  return R <= 0 || k < 0 || k > 26 || width <= 0 || Rp < R + 2;
}

}  // namespace

extern "C" {

// Launches K4 on `stream`.  Returns cudaGetLastError() after the launch (0
// on success); the caller raises on anything else.
int aim_genasm_forward(const void *pats, const void *txts, const void *plens,
                       const void *tlens, void *rec, void *scratch, long n,
                       int width, int R, int k, int Rp, int backtrace,
                       int hist_smem, void *stream) {
  if (n <= 0) return 0;
  if (bad_args(R, k, width, Rp) ||
      (backtrace && !hist_smem && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Params P{};
  P.pats = static_cast<const uint8_t *>(pats);
  P.txts = static_cast<const uint8_t *>(txts);
  P.plens = static_cast<const int32_t *>(plens);
  P.tlens = static_cast<const int32_t *>(tlens);
  P.rec = static_cast<int32_t *>(rec);
  P.scratch = static_cast<uint32_t *>(scratch);
  P.n = n;
  P.width = width;
  P.R = R;
  P.k = k;
  P.Rp = Rp;
  P.backtrace = backtrace;
  P.hist_smem = hist_smem;
  const Plan pl = plan(P);
  if (backtrace && hist_smem && pl.smem > (size_t)kSmemHistLimit)
    return (int)cudaErrorInvalidValue;
  Kernel kern = pl.kern;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (n + pl.pairs - 1) / pl.pairs;
  kern<<<(unsigned)blocks, 32 * kWarps, pl.smem,
         static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

// What K4 runs at (R, k): out = {registers a thread, local (spill) bytes a
// thread, dynamic shared memory a block, resident blocks an SM, pairs a
// warp, windowed history}.  Returns a cudaError_t (0 on success).
int aim_genasm_info(int R, int k, int backtrace, int hist_smem, int *out) {
  if (bad_args(R, k, 1, (R + 2 + 7) / 8 * 8)) return (int)cudaErrorInvalidValue;
  Params P{};
  P.R = R;
  P.k = k;
  P.Rp = (R + 2 + 7) / 8 * 8;
  P.backtrace = backtrace;
  P.hist_smem = hist_smem;
  const Plan pl = plan(P);
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, pl.kern);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(pl.kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pl.kern,
                                                    32 * kWarps, pl.smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)pl.smem;
  out[3] = blocks;
  out[4] = pl.S ? 32 / pl.S : 1;
  out[5] = P.windowed;
  return 0;
}

}  // extern "C"
