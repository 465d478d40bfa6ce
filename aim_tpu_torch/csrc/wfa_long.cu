// K5: WFA / WFA-adaptive long-read tier for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel aim_tpu/ops/wfa_pallas_long.py::_wfa_long_kernel
// (launched by wfa_forward_pallas_long and wfa_forward_pallas_long_bytes),
// the reference's DPU-MRAM analogue for reads of 1-16 kbp.  It computes
// K1's function -- the recursion, adaptive reduce and level walk of
// csrc/wfa.cuh -- and writes the same step records[n, smax+4] int32.  What
// the sizes change, against K1:
//
//   * History.  The m/i/d offsets [3][smax+1][K] int16 are 3.0 MB a pair at
//     smax 500 (10 kbp, e = 1 %), so they always live in a global scratch
//     the wrapper allocates ([n][3][smax+1][K]); the TPU kernel's on-chip
//     ring and its row DMAs have no counterpart here.
//   * Sequences.  Both rows are staged in shared memory as they arrive --
//     2-bit codes 16 a 32-bit word, or raw bytes 4 a word -- with three
//     spare words: 2.5 KB a sequence at 10 kbp packed, 10 KB as bytes.
//     With klo/khi/flags (12 B a level) a warp needs 11 KB at the 10 kbp
//     config (26 KB as bytes) and at most 45 KB (16 kbp raw bytes at smax
//     1023), so a block of 4 warps opts in to up to 180 KB of dynamic
//     shared memory.
//   * Extend.  A match run is about 100 bases at e = 1 %, so the extend
//     compares a 64-bit window at a time (32 packed bases or 8 bytes):
//     XOR, then __ffsll for the first differing base.  Records do not
//     depend on the word layout (the reference's packed and byte layouts
//     give equal records), so both layouts run this one kernel.
//
// What bounds it on this card: the forward walks all K diagonals of every
// level it reaches (K = 1001 at smax 500, 32 a lane) and writes each
// level's three history rows, 6 KB, to device memory: up to 3 MB a pair,
// so the history traffic, not arithmetic, is the floor; the extend's
// windows come from shared memory.  Bounds come from the lengths, never
// from the data: an extend stops at min(tlen, plen + k).

#include "wfa.cuh"

namespace {

constexpr int kWarps = 4;  // pairs a block (WARPS in ops/wfa_long.py)

struct Params {
  const uint8_t *pats, *txts;
  const int32_t *plens, *tlens;
  int32_t *rec;
  int16_t *scratch;  // [n][3][smax+1][K]
  long n;
  int width;         // bytes per sequence row
  int bsh;           // log2 of the bits a base: 1 (2-bit codes) or 3 (bytes)
  int smax, K, R;
  int x, go, ge;
  int adaptive, backtrace;
  int seq_words;     // staged 32-bit words a sequence
  int warp_bytes;    // shared memory per warp
};

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

__global__ void __launch_bounds__(32 * kWarps) wfa_long_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long pair = (long)blockIdx.x * kWarps + warp;
  if (pair >= P.n) return;  // warp-uniform

  const int smax = P.smax, K = P.K, R = P.R, bsh = P.bsh;
  const int S1 = smax + 1;
  unsigned char *base = smem + (size_t)warp * P.warp_bytes;
  aimwfa::Levels S;
  S.KL = reinterpret_cast<int *>(base);
  S.KH = S.KL + S1;
  S.FL = S.KH + S1;
  uint32_t *sp = reinterpret_cast<uint32_t *>(S.FL + S1);
  uint32_t *st = sp + P.seq_words;
  S.Hm = P.scratch + pair * (3L * S1 * K);
  S.Hi = S.Hm + (long)S1 * K;
  S.Hd = S.Hi + (long)S1 * K;

  // plen, tlen <= R by contract; the clamps keep a caller that breaks it
  // inside the staged rows.
  const int plen = min(P.plens[pair], R), tlen = min(P.tlens[pair], R);

  // ---- stage the pair's bytes as they are, zero past the input width ----
  {
    const uint8_t *gp = P.pats + pair * P.width;
    const uint8_t *gt = P.txts + pair * P.width;
    uint8_t *bp = reinterpret_cast<uint8_t *>(sp);
    uint8_t *bt = reinterpret_cast<uint8_t *>(st);
    for (int j = lane; j < 4 * P.seq_words; j += 32) {
      bp[j] = j < P.width ? gp[j] : 0;
      bt[j] = j < P.width ? gt[j] : 0;
    }
  }
  // staged words are visible to the warp after the forward's first
  // __syncwarp, before any extend reads them

  const int step = 64 >> bsh;  // bases a window
  auto extend = [&](int k, int m) {
    const int lo_b = k > 0 ? k : 0;
    const int hi_b = max(min(tlen, plen + k), 0);
    if (m < lo_b || m >= hi_b) return m;
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
  };
  const aimwfa::Costs C{smax, K, P.x, P.go, P.ge, P.adaptive};
  const int score = aimwfa::forward(C, S, plen, tlen, lane, extend);
  aimwfa::write_records(C, S, plen, tlen, score, P.backtrace != 0,
                        P.rec + pair * (long)(smax + 4), lane);
}

}  // namespace

extern "C" {

// Launches K5 on `stream`.  Returns cudaGetLastError() after the launch
// (0 on success); the caller raises on anything else.
int aim_wfa_long_forward(const void *pats, const void *txts,
                         const void *plens, const void *tlens, void *rec,
                         void *scratch, long n, int width, int packed,
                         int smax, int R, int x, int go, int ge, int adaptive,
                         int backtrace, void *stream) {
  if (n <= 0) return 0;
  if (smax < 0 || R <= 0 || width <= 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.pats = static_cast<const uint8_t *>(pats);
  P.txts = static_cast<const uint8_t *>(txts);
  P.plens = static_cast<const int32_t *>(plens);
  P.tlens = static_cast<const int32_t *>(tlens);
  P.rec = static_cast<int32_t *>(rec);
  P.scratch = static_cast<int16_t *>(scratch);
  P.n = n;
  P.width = width;
  P.bsh = packed ? 1 : 3;
  P.smax = smax;
  P.K = 2 * smax + 1;
  P.R = R;
  P.x = x;
  P.go = go;
  P.ge = ge;
  P.adaptive = adaptive;
  P.backtrace = backtrace;
  const int bases_per_word = packed ? 16 : 4;
  P.seq_words = (R + 2 + bases_per_word - 1) / bases_per_word + 3;
  long wb = 12L * (smax + 1) + 8L * P.seq_words;
  wb = (wb + 15) / 16 * 16;
  P.warp_bytes = (int)wb;
  const size_t smem = (size_t)wb * kWarps;
  cudaError_t e = cudaFuncSetAttribute(
      wfa_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (n + kWarps - 1) / kWarps;
  wfa_long_kernel<<<(unsigned)blocks, 32 * kWarps, smem,
                    static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
