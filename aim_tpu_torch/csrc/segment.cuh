// Segmented band helpers for K2 (nw.cu) and K3 (swg.cu) at band widths
// L <= 32, for NVIDIA Hopper (sm_90a).
//
// A warp holds 32/L pairs, one band lane a thread: band lane b of a pair is
// lane b of its L-lane segment.  Moving a row by d lanes is one
// __shfl_up_sync or __shfl_down_sync of width L, masked to [0, L) (a source
// outside the segment returns the lane's own value, which the mask
// replaces); a truncated scan is log2 of them; one ballot serves every pair
// of the warp, each taking its segment's L bits.  Code planes are L-bit
// words (uint8 at L = 8, uint16 at 16, uint32 at 32).  Collectives stay
// warp-uniform: the pairs of a warp step together to the warp's longest
// text, and the walk loops while any segment still walks.
//
// L = 64 and 128 keep one pair a warp (band.cuh's helpers).

#pragma once

#include "band.cuh"

namespace aimband {

// BandParams plus the shared memory of one pair (pairs sit back to back).
struct SegParams : BandParams {
  int pair_bytes;
};

template <int L> struct PlaneWord { typedef uint32_t T; };
template <> struct PlaneWord<8> { typedef uint8_t T; };
template <> struct PlaneWord<16> { typedef uint16_t T; };

// The segment's L bits of a warp-wide ballot, at bit 0.
template <int L>
__device__ __forceinline__ unsigned seg_bits(unsigned ballot, int seg0) {
  return L == 32 ? ballot : (ballot >> seg0) & ((1u << (L & 31)) - 1u);
}

// The value at band lane b + 1, or `fill` where that lies past L - 1.
template <int L>
__device__ __forceinline__ int seg_next(int v, int b, int fill) {
  const int r = __shfl_down_sync(kFull, v, 1, L);
  return b + 1 < L ? r : fill;
}

// The value at band lane b - d (d > 0), or `fill` where that lies below 0.
template <int L>
__device__ __forceinline__ int seg_prev(int v, int d, int b, int fill) {
  const int r = __shfl_up_sync(kFull, v, d, L);
  return b >= d ? r : fill;
}

// Truncated prefix min over the segment (trunc_min of band.cuh).
template <int L>
__device__ __forceinline__ int seg_trunc_min(int v, int DS, int b) {
  for (int s = 1; s <= DS && s < L; s *= 2)
    v = min(v, seg_prev<L>(v, s, b, kInf));
  return v;
}

// Stage the pattern and text of the warp's `pairs` pairs (from pair
// `first`) into shared memory, one code a byte (stage_seqs of band.cuh):
// pair q's at wbase + q * pair_bytes, the text seq_bytes after it.
__device__ __forceinline__ void stage_warp_seqs(const SegParams &P,
                                                long first, int pairs,
                                                unsigned char *wbase,
                                                int lane) {
  const int sb = P.seq_bytes;
  for (int idx = lane; idx < pairs * sb; idx += 32) {
    const int q = idx / sb, j = idx - q * sb;
    const long pair = first + q;
    if (pair >= P.n) continue;
    const uint8_t *gp = P.pats + pair * P.width;
    const uint8_t *gt = P.txts + pair * P.width;
    uint8_t a = 0, c = 0;
    if (P.packed) {
      const int byte = j >> 2, sh = 2 * (j & 3);
      if (byte < P.width) {
        a = (gp[byte] >> sh) & 3;
        c = (gt[byte] >> sh) & 3;
      }
    } else if (j < P.width) {
      a = gp[j];
      c = gt[j];
    }
    uint8_t *dst = wbase + (size_t)q * P.pair_bytes;
    dst[j] = a;
    dst[sb + j] = c;
  }
}

// Consecutive is-match rows at band lane cb from row hm1 down to the first
// row of its 32-row word (match_run of band.cuh), read 32/L rows at a time
// in L-row rounds: lane b of the segment reads row hm1 - (round*L + b).
// Every thread of the warp calls it.
template <int L, typename W>
__device__ __forceinline__ int seg_match_run(const W *planes, int stride,
                                             int ism_plane, int hm1, int cb,
                                             int b, int seg0) {
  const int pos = hm1 & 31;
  unsigned bits = 0;
#pragma unroll
  for (int rd = 0; rd < 32 / L; ++rd) {
    const int t = rd * L + b;
    const bool ok = t <= pos &&
        ((planes[(long)(hm1 - t) * stride + ism_plane] >> cb) & 1);
    bits |= seg_bits<L>(__ballot_sync(kFull, ok), seg0) << (rd * L);
  }
  const unsigned u = ~bits & (pos == 31 ? kFull : ((1u << (pos + 1)) - 1u));
  return u == 0 ? pos + 1 : __ffs((int)u) - 1;
}

// The highest set bit of the L-bit word w within [lo, hi] (0 <= lo, hi <
// 32), or -1: the D-run search of one plane word.
__device__ __forceinline__ int last_set_in(unsigned w, int lo, int hi) {
  const unsigned m = w & ((2u << hi) - 1u) & ~((1u << lo) - 1u);
  return m ? 31 - __clz((int)m) : -1;
}

// Shared memory of one pair on the segmented path: pattern and text one
// code a byte, then (kept on chip, with backtrace) R rows x `planes` L-bit
// words (ops/nw.py, ops/swg.py::warp_smem_bytes).
inline long seg_pair_bytes(const BandParams &P, bool planes_in_smem) {
  long b = 2L * round16(P.R);
  if (planes_in_smem && P.backtrace) b += (long)P.R * P.planes * (P.L / 8);
  return (b + 15) / 16 * 16;
}

// Sizes P for the segmented path; returns the shared memory a block.
inline size_t seg_plan(SegParams &P) {
  P.words = 1;
  P.seq_bytes = round16(P.R);
  P.pair_bytes = (int)seg_pair_bytes(P, P.planes_smem != 0);
  return (size_t)P.pair_bytes * kWarps * (32 / P.L);
}

// Launches a segmented kernel, 32/L pairs a warp, on `stream`.  Returns
// cudaGetLastError() after the launch (0 on success).
template <typename K>
inline int launch_seg(SegParams &P, K kern, void *stream) {
  if (P.n <= 0) return 0;
  if (!band_args_ok(P)) return (int)cudaErrorInvalidValue;
  const size_t smem = seg_plan(P);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long per_block = (long)kWarps * (32 / P.L);
  const long blocks = (P.n + per_block - 1) / per_block;
  kern<<<(unsigned)blocks, 32 * kWarps, smem,
         static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace aimband
