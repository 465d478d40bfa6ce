// K1: WFA / WFA-adaptive short-read tier for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel aim_tpu/ops/wfa_pallas2.py::_wfa2_kernel
// (launched by wfa_forward_pallas2).  Same function, same output: per
// pair, the gap-affine wavefront forward (extend, adaptive reduce,
// next-score compute) up to smax, then a level-walk backtrace writing one
// step record per score level into records[n, smax+4] int32, byte-equal
// to the reference kernel.  The recursion, the walk and the extend are
// csrc/wfa.cuh, shared with K5 (wfa_long.cu); this file stages the pairs
// and places the history.
//
// Mapping: where all K = 2*smax+1 diagonals fit in 16 lanes (smax <= 7,
// the 100 bp config's K = 11), two pairs a warp, one diagonal a lane of a
// 16-lane segment; otherwise one pair a warp, lanes over the live band.
// Per pair, in shared memory: the band word per level, the pattern and
// text staged as they arrive (2-bit codes, 16 bases a word, or raw bytes),
// and -- while a block's share fits in 48 KB -- the m/i/d offset history
// [3][smax+1][K] int16 (396 B a pair at smax = 5); otherwise the history
// goes to a global scratch the wrapper allocates.  The extend compares a
// 64-bit window at a time (32 packed bases, or 8 bytes), so a ~100-base
// match run takes 4 steps, not 100.
//
// What bounds it on this card: neither bytes nor arithmetic.  A pair reads
// 2 x 28 packed bytes and writes 36 record bytes (main config), reaches
// ~5.3 levels and holds ~6 live cells in all; its work is a chain of a few
// dozen dependent steps (shared loads, warp votes and reductions, the walk
// on one lane).  Measured (NVIDIA H100, tools/row_profile.py): 528 pairs,
// one wave, take ~10 us, and a 16,384-pair chunk 0.026 ms at 55 registers
// and 9 blocks an SM (1.7 waves), where the first design (one pair a warp,
// a byte a step from unpacked rows) took 0.057 ms in 3.1 waves.  Capping
// the registers at 40 for 12 blocks an SM spilled and ran slower.

#include "wfa.cuh"

namespace {

constexpr int kWarps = aimband::kWarps;  // warps a block (WARPS in ops/wfa2.py)

struct Params {
  const uint8_t *pats, *txts;
  const int32_t *plens, *tlens;
  int32_t *rec;
  int16_t *scratch;  // [n][3][smax+1][K] when the history is not in smem
  long n;
  int width;         // bytes per sequence row
  int bsh;           // log2 of the bits a base: 1 (2-bit codes) or 3 (bytes)
  int smax, K, Rp;
  int x, go, ge;
  int adaptive, backtrace, hist_smem;
  int seq_words;     // staged 32-bit words a sequence
  int pair_bytes;    // shared memory per pair
};

template <int W>
__global__ void __launch_bounds__(32 * kWarps) wfa2_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPairs = 32 / W;  // pairs a warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long first = ((long)blockIdx.x * kWarps + warp) * kPairs;
  if (first >= P.n) return;  // warp-uniform
  const int seg = lane / W, b = lane & (W - 1);
  const long pair = first + seg;
  const bool live = pair < P.n;

  const int smax = P.smax, K = P.K, S1 = smax + 1;
  unsigned char *base =
      smem + (size_t)(warp * kPairs + seg) * P.pair_bytes;
  aimwfa::Levels S;
  S.LV = reinterpret_cast<int *>(base);
  uint32_t *sp = reinterpret_cast<uint32_t *>(S.LV + S1);
  uint32_t *st = sp + P.seq_words;
  S.Hm = P.hist_smem ? reinterpret_cast<int16_t *>(st + P.seq_words)
                     : P.scratch + pair * (3L * S1 * K);
  S.Hi = S.Hm + S1 * K;
  S.Hd = S.Hi + S1 * K;

  // plen, tlen <= R < Rp by contract; the clamps keep a caller that breaks
  // it inside the staged rows.
  const int plen = live ? min(P.plens[pair], P.Rp) : 0;
  const int tlen = live ? min(P.tlens[pair], P.Rp) : 0;
  if (live) {
    aimwfa::stage_row<W>(sp, P.pats + pair * P.width, P.width, P.seq_words,
                         b);
    aimwfa::stage_row<W>(st, P.txts + pair * P.width, P.width, P.seq_words,
                         b);
  }
  const aimwfa::WindowExtend extend{sp, st, plen, tlen, P.bsh};
  const aimwfa::Costs C{smax, K, P.x, P.go, P.ge, P.adaptive};
  const int score = aimwfa::forward<W>(C, S, plen, tlen, live, b, extend);
  aimwfa::write_records<W>(C, S, plen, tlen, score, P.backtrace != 0, live,
                           P.rec + pair * (long)(smax + 4), b);
}

// Sizes P from smax and Rp; returns the segment width W.
int plan(Params &P, int smax, int Rp, int hist_smem) {
  P.smax = smax;
  P.K = 2 * smax + 1;
  P.Rp = Rp;
  P.hist_smem = hist_smem;
  // room for raw bytes (4 a word) whatever the layout, three spare words
  P.seq_words = Rp / 4 + 3;
  long pb = 4L * (smax + 1) + 8L * P.seq_words;
  if (hist_smem) pb += 6L * (smax + 1) * P.K;
  P.pair_bytes = (int)((pb + 15) / 16 * 16);
  return P.K <= 16 ? 16 : 32;
}

}  // namespace

extern "C" {

// Launches K1 on `stream`.  Returns cudaGetLastError() after the launch
// (0 on success); the caller raises on anything else.
int aim_wfa2_forward(const void *pats, const void *txts, const void *plens,
                     const void *tlens, void *rec, void *scratch, long n,
                     int width, int packed, int smax, int Rp, int x, int go,
                     int ge, int adaptive, int backtrace, int hist_smem,
                     void *stream) {
  if (n <= 0) return 0;
  if (smax < 0 || smax > 1023 || Rp <= 0 || Rp % 16 || width <= 0 ||
      (!hist_smem && scratch == nullptr))
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
  P.x = x;
  P.go = go;
  P.ge = ge;
  P.adaptive = adaptive;
  P.backtrace = backtrace;
  const int W = plan(P, smax, Rp, hist_smem);
  void (*kern)(const Params) = W == 16 ? wfa2_kernel<16> : wfa2_kernel<32>;
  const long per_block = (long)kWarps * (32 / W);
  const size_t smem = (size_t)P.pair_bytes * per_block;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (n + per_block - 1) / per_block;
  kern<<<(unsigned)blocks, 32 * kWarps, smem,
         static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

// The launch facts of K1 at (smax, Rp, hist_smem) into out[6]
// (ops/_build.py INFO_KEYS).
int aim_wfa_info(int smax, int Rp, int hist_smem, int *out) {
  if (smax < 0 || smax > 1023 || Rp <= 0 || Rp % 16)
    return (int)cudaErrorInvalidValue;
  Params P;
  const int W = plan(P, smax, Rp, hist_smem);
  return aimband::band_info(W == 16 ? wfa2_kernel<16> : wfa2_kernel<32>,
                            (size_t)P.pair_bytes * kWarps * (32 / W), 32 / W,
                            out);
}

const char *aim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
