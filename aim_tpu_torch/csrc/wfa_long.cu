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
//     smax 500 (10 kbp, e = 1 %), so they live in a global scratch the
//     wrapper allocates ([n][3][smax+1][K], sized for the non-adaptive
//     config, whose band fills K); only each level's band is written, a
//     few hundred bytes a level at the adaptive config.  The TPU kernel's
//     on-chip ring and its row DMAs have no counterpart here.
//   * Sequences.  Both rows are staged in shared memory as they arrive --
//     2-bit codes 16 a 32-bit word, or raw bytes 4 a word -- with three
//     spare words: 2.5 KB a sequence at 10 kbp packed, 10 KB as bytes.
//     With the band word (4 B a level) a warp needs 7 KB at the 10 kbp
//     config (22 KB as bytes) and at most 37 KB (16 kbp raw bytes at smax
//     1023), so a block of 4 warps opts in to up to 148 KB of dynamic
//     shared memory.
//   * Extend.  A match run is about 100 bases at e = 1 %; wfa.cuh's extend
//     compares a 64-bit window at a time (32 packed bases or 8 bytes), and
//     both word layouts run this one kernel.
//
// What bounds it on this card: neither bytes nor arithmetic come near the
// card's rates.  A pair is a chain of ~430 dependent levels at 10 kbp (e =
// 1 %); a lone warp spends ~1.3 us a level (measured, NVIDIA H100, with
// tools/row_profile.py), the instructions of the band's passes, the
// extend's windows and the warp reductions, and the walk a round of
// history loads a step.  The first design swept all K = 1001 diagonals of
// every level in five passes and wrote full-K history rows -- ~107 times
// the live cells of the adaptive config -- and a lone warp spent ~13 us a
// level in the loads of those passes.  Now each pass and each history
// store covers only the level's live band (9.5 diagonals on average at
// the adaptive 10 kbp config, one step a lane), and the non-adaptive
// config, whose band fills K, does no more than before.  Bounds come from
// the lengths, never from the data: an extend stops at min(tlen, plen + k).

#include "wfa.cuh"

namespace {

// pairs a block (WARPS in ops/wfa_long.py)
constexpr int kWarps = aimband::kWarps;

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
  S.LV = reinterpret_cast<int *>(base);
  uint32_t *sp = reinterpret_cast<uint32_t *>(S.LV + S1);
  uint32_t *st = sp + P.seq_words;
  S.Hm = P.scratch + pair * (3L * S1 * K);
  S.Hi = S.Hm + (long)S1 * K;
  S.Hd = S.Hi + (long)S1 * K;

  // plen, tlen <= R by contract; the clamps keep a caller that breaks it
  // inside the staged rows.
  const int plen = min(P.plens[pair], R), tlen = min(P.tlens[pair], R);

  aimwfa::stage_row<32>(sp, P.pats + pair * P.width, P.width, P.seq_words,
                        lane);
  aimwfa::stage_row<32>(st, P.txts + pair * P.width, P.width, P.seq_words,
                        lane);
  const aimwfa::WindowExtend extend{sp, st, plen, tlen, bsh};
  const aimwfa::Costs C{smax, K, P.x, P.go, P.ge, P.adaptive};
  const int score = aimwfa::forward<32>(C, S, plen, tlen, true, lane,
                                        extend);
  aimwfa::write_records<32>(C, S, plen, tlen, score, P.backtrace != 0, true,
                            P.rec + pair * (long)(smax + 4), lane);
}

// Sizes P's shared memory from smax, R and the layout; returns a block's.
size_t plan(Params &P, int smax, int R, int packed) {
  P.smax = smax;
  P.K = 2 * smax + 1;
  P.R = R;
  P.bsh = packed ? 1 : 3;
  const int bases_per_word = packed ? 16 : 4;
  P.seq_words = (R + 2 + bases_per_word - 1) / bases_per_word + 3;
  const long wb = 4L * (smax + 1) + 8L * P.seq_words;
  P.warp_bytes = (int)((wb + 15) / 16 * 16);
  return (size_t)P.warp_bytes * kWarps;
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
  if (smax < 0 || smax > 1023 || R <= 0 || width <= 0 || scratch == nullptr)
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
  P.x = x;
  P.go = go;
  P.ge = ge;
  P.adaptive = adaptive;
  P.backtrace = backtrace;
  const size_t smem = plan(P, smax, R, packed);
  cudaError_t e = cudaFuncSetAttribute(
      wfa_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (n + kWarps - 1) / kWarps;
  wfa_long_kernel<<<(unsigned)blocks, 32 * kWarps, smem,
                    static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

// The launch facts of K5 at (smax, R, packed) into out[6] (ops/_build.py
// INFO_KEYS).
int aim_wfa_long_info(int smax, int R, int packed, int *out) {
  if (smax < 0 || smax > 1023 || R <= 0) return (int)cudaErrorInvalidValue;
  Params P;
  const size_t smem = plan(P, smax, R, packed);
  return aimband::band_info(wfa_long_kernel, smem, 1, out);
}

}  // extern "C"
