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
// j = b + h - C - 1 with text symbol h - 1.  Only valid cells read them,
// and those have 0 <= j < plen and h - 1 < tlen, so of the reference's
// rules for its padded rows (j < weff from the input, 2-bit codes unpacked
// or raw bytes; weff <= j < lpad reads 0; anything else -1) the -1 is
// never reached.  The row loop reads no global memory: each warp keeps a
// ring of pattern bytes and one of text bytes in shared memory, refilled
// with 32 bytes of each every 32 rows from registers loaded one refill
// ahead.  Each thread keeps its E pattern bytes in E/4 words, slid one byte
// a row (one shuffle brings the next thread's first byte; the last thread
// reads the ring); a row's mismatches are the window XORed with the text
// byte in every byte, a nonzero byte's high bit set by one add.  A
// thread's valid positions of a row form one interval (1 <= v <= upper,
// p < B), so its E-bit masks come from two clamps and column 0 from one
// compare.
//
// Code rows (the port's layout, global scratch the wrapper allocates):
//   codes [n][R][P*bits/8]  row h-1: position b's code at bits bits*b..,
//                           little-endian; NW 2 bits (D=0 I=1 M=2 X=3),
//                           SWG 4 bits (choice | d_open << 2 | i_open << 3,
//                           CH_M where the cell is not valid)
//   ism   [n][R][P/8]       position b's is-match bit at bit b (NW: code M;
//                           SWG: valid and choice M)
//   meta  [n][2] int32      score, forward flag
// A thread's E codes are contiguous bits, stored straight from the thread
// as whole bytes; the is-match bits at one plane (4 a thread) take one
// shuffle to pair two threads into a byte.  Without backtrace no rows are
// written and K6 writes the record itself.
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
// pair reads ~2 KB of packed sequence and writes 48 bytes of code rows a
// text row (~200 KB a pair for NW at one plane); the work is R dependent
// rows of a few dozen integer operations and ~9 shuffles a thread.  One
// warp alone took ~1,800 cycles a row in the first design (global symbol
// reads, E-fold mask compares and 5 shuffles of stores in the chain), and
// at 80 registers a 4096-pair chunk needed two waves.  So the row is kept
// short (no global reads, interval masks, whole-byte stores) and planes 1
// and 2 are held to 64 registers (__launch_bounds__ with 8 blocks an SM),
// which fits a 4096-pair chunk (1,024 blocks) in one wave on 132 SMs (SWG
// keeps its I row in shared memory for that).  A lone warp's row now takes
// ~760 cycles; in one full wave the ~220 instructions of an NW row bound it
// (tools/row_profile.py reads both).  K7 is a short sequential walk a pair.

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

// Pattern or text symbol j of a pair as a valid cell reads it: j < weff
// from the input (2-bit codes unpacked, or raw bytes), anything else 0.  (The
// reference reads -1 below 0 and past lpad, but no valid cell reaches
// there: valid cells have 0 <= j < plen and text rows h - 1 < tlen.)
__device__ __forceinline__ int sym_in(const uint8_t *row, const LongParams &P,
                                      int j) {
  if (j < 0 || j >= P.weff) return 0;
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
  // a lane below o reads its own total, which min leaves unchanged
  int tot = z[E - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    tot = min(tot, __shfl_up_sync(kFull, tot, o));
  int excl = __shfl_up_sync(kFull, tot, 1);
  if (lane == 0) excl = INT_MAX;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int m = min(z[e], excl);
    // position 127 is the thread's last one on lane 128/E - 1
    z[e] = e == E - 1 && lane == 128 / E - 1 ? m : min(m, kInf);
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

// Where thread `lane` stores its NB bits of a row (thread t's bits sit at
// bit t*NB of the row): its whole bytes, or at NB = 4 the byte it shares
// with the next thread.
template <int NB>
__device__ __forceinline__ int row_offset(int lane) {
  return NB == 4 ? lane >> 1 : lane * (NB / 8);
}

// Store a thread's NB bits of a row at `at` (the row + row_offset): whole
// bytes straight from each thread; at NB = 4 one shuffle pairs two threads
// into a byte.
template <int NB>
__device__ __forceinline__ void store_row(
    uint8_t *at, const uint32_t (&w)[NB >= 32 ? NB / 32 : 1], int lane) {
  if constexpr (NB == 4) {
    const uint32_t v = w[0] | (__shfl_down_sync(kFull, w[0], 1) << 4);
    if ((lane & 1) == 0) *at = (uint8_t)v;
  } else if constexpr (NB == 8) {
    *at = (uint8_t)w[0];
  } else if constexpr (NB == 16) {
    *reinterpret_cast<uint16_t *>(at) = (uint16_t)w[0];
  } else {
#pragma unroll
    for (int k = 0; k < NB / 32; ++k)
      reinterpret_cast<uint32_t *>(at)[k] = w[k];
  }
}

// Bits 0, 2, 4, .. 2k of w packed into bits 0 .. k (k < 16).
__device__ __forceinline__ uint32_t even_bits(uint32_t w) {
  w &= 0x55555555u;
  w = (w | (w >> 1)) & 0x33333333u;
  w = (w | (w >> 2)) & 0x0f0f0f0fu;
  w = (w | (w >> 4)) & 0x00ff00ffu;
  return (w | (w >> 8)) & 0x0000ffffu;
}

// Bits lo..hi of a word, both clamped to [0, top]; 0 when empty.
__device__ __forceinline__ uint32_t span_bits(int lo, int hi, int top) {
  lo = max(lo, 0);
  hi = min(hi, top);
  return lo > hi ? 0u : (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo);
}

// The symbol ring of one pair (shared memory): pattern symbol j as a byte
// at ring[(j + C + 1) & (64E - 1)], text symbol t at text[t & 63].  Row 1's
// windows read u = 1 .. NP; after row h the last thread reads u = NP + h
// and every thread text byte h.  32 new bytes of each are written every 32
// rows, which 64E >= NP + 64 bytes of ring leave room for.
constexpr int kRefill = 32;

// The E pattern bytes u0 .. u0 + E - 1 of the ring as E/4 words (byte e of
// word e/4), read as words and funnel-shifted into place.
template <int E>
__device__ __forceinline__ void window_load(uint32_t (&win)[E / 4],
                                            const uint32_t *ring, int u0) {
  constexpr int kWords = 16 * E;  // ring words
  const int s = u0 & (4 * kWords - 1);
  const int wi = s >> 2, sh = 8 * (s & 3);
  uint32_t w = ring[wi];
#pragma unroll
  for (int k = 0; k < E / 4; ++k) {
    const uint32_t w2 = ring[(wi + k + 1) & (kWords - 1)];
    win[k] = __funnelshift_r(w, w2, sh);
    w = w2;
  }
}

// 1 where byte e of the window differs from the text byte, from nz: the
// window XOR the text byte in every byte, with each nonzero byte's high bit
// set and the rest cleared.
template <int E>
__device__ __forceinline__ int mismatch_at(const uint32_t (&nz)[E / 4],
                                           int e) {
  return (nz[e >> 2] >> (8 * (e & 3) + 7)) & 1;
}

// ---------------------------------------------------------------- K6 ----

template <int E, bool kSwg>
__global__ void __launch_bounds__(32 * kPairs, E <= 8 ? 8 : 1)
    fwd_kernel(const LongParams P) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CB = kSwg ? 4 : 2;                 // code bits a position
  constexpr int CW = (E * CB) >= 32 ? E * CB / 32 : 1;
  constexpr int IW = E >= 32 ? E / 32 : 1;
  constexpr int kRing = 64 * E;                    // pattern ring bytes
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long pair = (long)blockIdx.x * kPairs + warp;
  if (pair >= P.n) return;  // warp-uniform
  const int R = P.R, C = P.C, B = 2 * C + 1, NP = P.NP;
  const int plen = P.plens[pair], tlen = P.tlens[pair];
  const bool aliased = plen == tlen + 1;
  const int p0 = lane * E;
  const bool seam_r = ((p0 + E) & 127) == 0;
  const bool seam_l = p0 > 0 && (p0 & 127) == 0;
  const int hmax = min(tlen, R);
  // this row's code and is-match bytes of the thread: NW advances two
  // pointers a row; SWG, short of registers, computes them from the row's
  // index (pair * R + h - 1 < 2^31, which the host checks)
  const int coff = row_offset<E * (kSwg ? 4 : 2)>(lane);
  const int ioff = row_offset<E>(lane);
  uint8_t *crow = P.codes + pair * (long)R * P.cbytes + coff;
  uint8_t *irow = P.ism + pair * (long)R * P.ibytes + ioff;
  const unsigned rix0 = (unsigned)(pair * R) - 1u;

  // ---- the symbol ring: pattern u in [0, NP + 32), text t in [0, 32);
  // the next 32 of each wait in registers, one refill ahead
  uint8_t *ring = smem + (size_t)warp * (kRing + 64 + (kSwg ? 128 * E : 0));
  uint8_t *text = ring + kRing;
  // SWG: the I row, position e of the thread at pis[e * 32 + lane] (shared
  // memory in place of E registers, which the row's D scan needs)
  int *pis = reinterpret_cast<int *>(text + 64);
  const uint32_t *ring32 = reinterpret_cast<const uint32_t *>(ring);
  const uint8_t *prow = P.pats + pair * P.width;
  const uint8_t *trow = P.txts + pair * P.width;
  for (int u = lane; u < NP + kRefill; u += 32)
    ring[u] = (uint8_t)sym_in(prow, P, u - C - 1);
  text[lane] = (uint8_t)sym_in(trow, P, lane);
  // pattern byte | text byte << 8
  int next = sym_in(prow, P, NP + kRefill + lane - C - 1) |
             sym_in(trow, P, kRefill + lane) << 8;
  __syncwarp();
  // the thread's pattern window at row 1 (positions p0 .. p0 + E - 1), slid
  // one byte a row after that, and row 1's text byte
  uint32_t win[E / 4];
  window_load<E>(win, ring32, p0 + 1);
  int tsym = text[0];

  // row 0
  int pm[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = p0 + e, v0 = p - C;
    const bool inb = p < B;
    if (!kSwg) {
      int r = (v0 >= 0 && v0 <= plen && inb) ? v0 * P.gd : kInf;
      if (aliased && v0 == plen && inb && v0 >= 0) r = P.gi;
      pm[e] = r;
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
      pis[e * 32 + lane] = ok ? i0 : kInf;
    }
  }

  bool ovf = false;
  // valid cells: 1 <= v = p + h - C <= hiv and p < B, so the thread's
  // valid e form one interval; column 0 (v == 0) is the position below it
  const int hiv = kSwg ? plen : min(plen, tlen + C);
  const int etop = min(E - 1, B - 1 - p0);
  const int gi = P.gi, gd = P.gd, x = P.x;  // NW costs (SWG's read from P)
  // NW rows up to hsafe cannot hold a valid cell past int16: with costs >=
  // 0 every valid cell is at most the diagonal path's cost, max(gi, gd, x)
  // * (max(h, v) + 1) with v <= h + C, so the range check starts after it
  const int hsafe = gi >= 0 && gd >= 0 && x >= 0
                        ? 32767 / max(1, max(gi, max(gd, x))) - C - 2
                        : 0;
  const int margin = P.go + P.ge + max(P.x, max(abs(P.mat), P.ge));
  const int db2 = aliased ? kInf : P.ms;  // SWG column 0's D from row 2
  // The next row's window and text byte after row h's, after a refill every
  // 32 rows.  NW advances them at the top of row h, where the shuffle and
  // loads hide behind the row's cells; SWG, short of registers for both
  // windows, at its end.
  auto next_symbols = [&](int h) {
    if (h % kRefill == 0) {  // warp-uniform
      ring[(NP + h + lane) & (kRing - 1)] = (uint8_t)next;
      text[(h + lane) & 63] = (uint8_t)(next >> 8);
      const long row = ((long)blockIdx.x * kPairs + warp) * P.width;
      next = sym_in(P.pats + row, P, NP + h + kRefill + lane - C - 1) |
             sym_in(P.txts + row, P, h + kRefill + lane) << 8;
      __syncwarp();
    }
    // positions p0 + 1 .. of this window, then the byte of the next
    // thread's first position (the last thread's: pattern u = NP + h)
    const uint32_t nb = __shfl_down_sync(kFull, win[0], 1);
    const uint32_t last =
        lane == 31 ? (uint32_t)ring[(NP + h) & (kRing - 1)] : nb & 0xffu;
#pragma unroll
    for (int k = 0; k + 1 < E / 4; ++k)
      win[k] = __funnelshift_r(win[k], win[k + 1], 8);
    win[E / 4 - 1] = (win[E / 4 - 1] >> 8) | (last << 24);
    tsym = text[h & 63];
  };
  for (int h = 1; h <= hmax; ++h) {
    const uint32_t vmask = span_bits(C + 1 - h - p0, hiv + C - h - p0, etop);
    const int e0 = C - h - p0;
    const uint32_t cmask = (unsigned)e0 < (unsigned)E ? 1u << e0 : 0u;
    const uint32_t lmask = vmask | cmask;
    uint32_t nz[E / 4];
    {
      const uint32_t tt = (uint32_t)tsym * 0x01010101u;
#pragma unroll
      for (int k = 0; k < E / 4; ++k) {
        const uint32_t d = win[k] ^ tt;
        nz[k] = (((d & 0x7f7f7f7fu) + 0x7f7f7f7fu) | d) & 0x80808080u;
      }
    }
    if constexpr (!kSwg) next_symbols(h);
    // SWG: the same as one E-bit word (bits 7, 15, 23, 31 of each nz word
    // moved to 4k .. 4k + 3 by one multiply), one register in place of E/4
    uint32_t mm = 0;
    if constexpr (kSwg) {
#pragma unroll
      for (int k = 0; k < E / 4; ++k)
        mm |= ((nz[k] * 0x00204081u) >> 28) << (4 * k);
    }
    // ---- row cells
    uint32_t cw[CW] = {}, iw[IW] = {};
    if (!kSwg) {
      int cur[E];
      const int rn = from_right(pm[0], lane, seam_r);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int ins = (e + 1 < E ? pm[e + 1] : rn) + gi;
        const int own = min(ins, pm[e] + mismatch_at<E>(nz, e) * x);
        const int z = (vmask >> e) & 1 ? own : kInf;
        cur[e] = z - (p0 + e) * gd;
      }
      if (h <= C) {  // warp-uniform: column 0 (v == 0) is in the band
#pragma unroll
        for (int e = 0; e < E; ++e)
          if ((cmask >> e) & 1) cur[e] = h * gi - (p0 + e) * gd;
      }
      band_min_scan(cur, lane);
#pragma unroll
      for (int e = 0; e < E; ++e)
        cur[e] = (lmask >> e) & 1 ? cur[e] + (p0 + e) * gd : kInf;
      if (h > hsafe) {  // warp-uniform
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (((vmask >> e) & 1) && abs(cur[e]) > 32767) ovf = true;
      }
      // ---- codes
      if (P.backtrace) {
        const int ln = from_left(cur[E - 1], lane, seam_l);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          // priority D, I, X, else M (D 0, I 1, M 2, X 3), without branches
          const int left = e > 0 ? cur[e - 1] : ln;
          const int ins = (e + 1 < E ? pm[e + 1] : rn) + gi;
          const bool is_d = cur[e] == left + gd;
          const bool is_i = cur[e] == ins;
          const bool is_x = cur[e] == pm[e] + x;
          const uint32_t code = is_d ? 0u : is_i ? 1u : is_x ? 3u : 2u;
          cw[(2 * e) / 32] |= code << ((2 * e) % 32);
        }
        // is-match: code M (bits 10), position e at bit e
#pragma unroll
        for (int k = 0; k < CW; ++k) {
          const uint32_t m = even_bits((cw[k] >> 1) & ~cw[k]);
          iw[k / 2] |= m << (16 * (k & 1));
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e) pm[e] = cur[e];
    } else {
      const int go = P.go, ge = P.ge, mat = P.mat, mis = P.x;
      const int mb = go + h * ge;
      const int db = h >= 2 ? db2 : P.ms;
      const int rnm = from_right(pm[0], lane, seam_r);
      // the previous row's I, this thread's E and the next thread's first
      int *my = pis + lane;
      auto i_at = [&](int e) { return my[e * 32]; };
      auto i_set = [&](int e, int v) { my[e * 32] = v; };
      const int rni = from_right(i_at(0), lane, seam_r);
      // the diagonal term c of the thread's last position first: the next
      // thread's D chain reads it; then, ascending (pm[e+1] and I at e+1
      // still the previous row's), I, c and the D chain's input z.  c is
      // recomputed after the scan instead of kept, and I goes back to
      // shared memory (registers).
      int c;
      {
        const int iov = rnm + go + ge;
        int ic = (vmask >> (E - 1)) & 1 ? min(iov, rni + ge) : kInf;
        if ((cmask >> (E - 1)) & 1) ic = mb;
        c = (vmask >> (E - 1)) & 1
                ? min(pm[E - 1] + ((mm >> (E - 1)) & 1 ? mis : mat), ic)
                : kInf;
      }
      const int lnc = from_left(c, lane, seam_l);
      uint32_t iopen = 0;
      int d[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int p = p0 + e, v = p + h - C;
        const bool valid = (vmask >> e) & 1;
        const int iov = (e + 1 < E ? pm[e + 1] : rnm) + go + ge;
        int ic = min(iov, (e + 1 < E ? i_at(e + 1) : rni) + ge);
        ic = valid ? ic : kInf;
        if ((cmask >> e) & 1) ic = mb;
        iopen |= (uint32_t)(ic == iov) << e;
        i_set(e, ic);  // position e + 1 still holds the previous row's
        // M at p - 1 where that cell is column 0, else INF
        int ml = (p >= 1 && p - 1 + h - C == 0 && p - 1 < B) ? mb : kInf;
        if (e == 0 && seam_l) ml = min(ml, kSeamCap);
        const int left = e > 0 ? c : lnc;  // c of position p - 1
        int z = ((cmask >> e) & 1) ? db
              : v == 1 ? ml + go + ge : left + go + ge;
        z = (lmask >> e) & 1 ? z : kInf;
        d[e] = z - p * ge;
        c = valid ? min(pm[e] + ((mm >> e) & 1 ? mis : mat), ic) : kInf;
      }
      band_min_scan(d, lane);
      // M = min(c, D), the codes, and pm <- M position by position
      // (ascending: the D-opened test reads M at p - 1; position 0's, from
      // the previous thread, after the loop)
      int d0 = 0, mleft = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool valid = (vmask >> e) & 1;
        const bool live = (lmask >> e) & 1;
        const int ie = i_at(e);  // this row's I, stored above
        const int de = live ? d[e] + (p0 + e) * ge : kInf;
        const int ce =
            valid ? min(pm[e] + ((mm >> e) & 1 ? mis : mat), ie) : kInf;
        int m = min(ce, de);
        if ((cmask >> e) & 1) m = mb;
        m = live ? m : kInf;
        if (valid) {
          const int mx = max(abs(m), max(abs(ie), abs(de)));
          if (mx > 32767 - margin && mx < kInf / 2) ovf = true;
        }
        if (P.backtrace) {
          // the M choice, priority D, I, M, else X (D 0, I 1, M 2, X 3),
          // without branches; CH_M where the cell is not valid
          const bool is_d = m == de;
          const bool is_i = m == ie;
          const bool is_m = m == pm[e] + mat;
          const uint32_t b1 = !is_d && !is_i;
          const uint32_t b0 = !is_d && (is_i || !is_m);
          const uint32_t dop = e > 0 && de == mleft + go + ge;
          const uint32_t code = valid ? b0 | b1 << 1 | dop << 2 |
                                            ((iopen >> e) & 1) << 3
                                      : (uint32_t)kCM;
          cw[(4 * e) / 32] |= code << ((4 * e) % 32);
          iw[e / 32] |= (uint32_t)(valid && b1 && !b0) << (e % 32);
        }
        if (e == 0) d0 = de;
        mleft = m;
        pm[e] = m;
      }
      if (P.backtrace) {  // position 0's D-opened bit
        const int lnm = from_left(mleft, lane, seam_l);
        if ((vmask & 1) && d0 == lnm + go + ge) cw[0] |= 4u;
      }
    }
    if (P.backtrace) {
      if constexpr (kSwg) {
        const unsigned rix = rix0 + (unsigned)h;
        crow = P.codes + (unsigned long long)rix * (unsigned)P.cbytes + coff;
        irow = P.ism + (unsigned long long)rix * (unsigned)P.ibytes + ioff;
      }
      store_row<E * CB>(crow, cw, lane);
      store_row<E>(irow, iw, lane);
      if constexpr (!kSwg) {
        crow += P.cbytes;
        irow += P.ibytes;
      }
    }
    if constexpr (kSwg) next_symbols(h);
    // ---- row end
  }
  // score: the cell at band position kc of row tlen, which pm holds once
  // the pair's rows are done
  const int kend = plen - tlen;
  const int kc = kend + C;
  const bool hit_in = kc >= 0 && kc < B;
  int score = 0;
  if (tlen >= 1 && tlen <= R && hit_in) {  // warp-uniform
    int val = 0;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (p0 + e == kc) val = pm[e];
    score = __shfl_sync(kFull, val, kc / E);
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

int launch_long(Kern k, const LongParams &P, size_t smem, void *stream) {
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  const long blocks = (P.n + kPairs - 1) / kPairs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  k<<<(unsigned)blocks, 32 * kPairs, smem, s>>>(P);
  return (int)cudaGetLastError();
}

// K6 at `planes` (NW or SWG), and its dynamic shared memory a block: each
// warp's symbol ring (64 * E pattern bytes, 64 text bytes) and, for SWG,
// its I row (E ints a thread).
Kern fwd_kernel_for(int planes, bool swg, size_t *smem) {
  const int E = 4 * planes;
  *smem = (size_t)kPairs * (64 * E + 64 + (swg ? 128 * E : 0));
  switch (planes) {
    case 1: return swg ? fwd_kernel<4, true> : fwd_kernel<4, false>;
    case 2: return swg ? fwd_kernel<8, true> : fwd_kernel<8, false>;
    case 4: return swg ? fwd_kernel<16, true> : fwd_kernel<16, false>;
    case 8: return swg ? fwd_kernel<32, true> : fwd_kernel<32, false>;
  }
  return nullptr;
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
      (!backtrace && !rec) || (double)n * R >= 2147483648.0)
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
  size_t smem;
  Kern k = fwd_kernel_for(planes, swg != 0, &smem);
  return launch_long(k, P, smem, stream);
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
  return launch_long(swg ? walk_kernel<true> : walk_kernel<false>, P, 0,
                     stream);
}

// What K6 runs at `planes` (NW or SWG): out = {registers a thread, local
// (spill) bytes a thread, dynamic shared memory a block, resident blocks an
// SM, pairs a warp, 0}.  Returns a cudaError_t (0 on success).
int aim_nwswg_long_info(int planes, int swg, int *out) {
  if (!planes_ok(planes)) return (int)cudaErrorInvalidValue;
  size_t smem;
  Kern k = fwd_kernel_for(planes, swg != 0, &smem);
  return band_info(k, smem, 1, out);
}

}  // extern "C"
