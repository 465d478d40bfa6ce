// K1: WFA / WFA-adaptive short-read tier for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel aim_tpu/ops/wfa_pallas2.py::_wfa2_kernel
// (launched by wfa_forward_pallas2).  Same function, same output: per
// pair, the gap-affine wavefront forward (extend, adaptive reduce,
// next-score compute) up to smax, then a level-walk backtrace writing one
// step record per score level into records[n, smax+4] int32, byte-equal
// to the reference kernel.  The recursion and the walk are csrc/wfa.cuh,
// shared with K5 (wfa_long.cu); this file stages the pair, brings the
// extend and places the history.
//
// Mapping: one warp per pair, lanes over the K = 2*smax+1 diagonals (a
// loop when K > 32).  Per-pair state lives
// in shared memory: klo/khi/flags per level, the pattern and text
// unpacked to one code per byte, and -- when a block's share fits in
// 48 KB -- the m/i/d offset history [3][smax+1][K] int16 (396 B a pair at
// smax = 5); otherwise the history goes to a global scratch the wrapper
// allocates.  The backtrace is sequential per pair and runs on lane 0.
//
// What bounds it on this card: neither bytes nor tensor math.  A pair
// reads 2x30 packed bytes and writes 36 record bytes (main config); the
// work is a few hundred dependent integer steps per pair, so the kernel is
// latency bound and needs many warps in flight: 16384 pairs a chunk give
// 4096 blocks of 4 warps, about 31 blocks for each of the 132 SMs.
// Extend compares one byte per step, like the reference oracle; TPU
// workarounds (mismatch bitmasks from a reversed pattern plane, the 4-bit
// next-word table, float-exponent ctz, one-hot gathers, rolls) are not
// carried over.
//
// Bounds come from the lengths, never from the data: a mismatch is forced
// for h < max(k,0) and h >= min(tlen, plen+k); packed padding codes are 0,
// the code of a real base.

#include "wfa.cuh"

namespace {

constexpr int kWarps = 4;  // pairs a block (WARPS in ops/wfa2.py)

struct Params {
  const uint8_t *pats, *txts;
  const int32_t *plens, *tlens;
  int32_t *rec;
  int16_t *scratch;  // [n][3][smax+1][K] when the history is not in smem
  long n;
  int width;         // bytes per sequence row
  int packed;        // 2-bit codes, 4 a byte, little-endian fields
  int smax, K, Rp;
  int x, go, ge;
  int adaptive, backtrace, hist_smem;
  int warp_bytes;    // shared memory per warp
};

__global__ void __launch_bounds__(32 * kWarps) wfa2_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long pair = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= P.n) return;  // warp-uniform

  const int smax = P.smax, K = P.K, Rp = P.Rp;
  const int S1 = smax + 1;
  unsigned char *base = smem + (size_t)warp * P.warp_bytes;
  aimwfa::Levels S;
  S.KL = reinterpret_cast<int *>(base);
  S.KH = S.KL + S1;
  S.FL = S.KH + S1;
  uint8_t *sp = reinterpret_cast<uint8_t *>(S.FL + S1);
  uint8_t *st = sp + Rp;
  S.Hm = P.hist_smem ? reinterpret_cast<int16_t *>(st + Rp)
                     : P.scratch + pair * (3L * S1 * K);
  S.Hi = S.Hm + S1 * K;
  S.Hd = S.Hi + S1 * K;

  const int plen = P.plens[pair], tlen = P.tlens[pair];

  // ---- stage the pair: one code per byte, zero past the input width ----
  {
    const uint8_t *gp = P.pats + pair * P.width;
    const uint8_t *gt = P.txts + pair * P.width;
    for (int j = lane; j < Rp; j += 32) {
      uint8_t a = 0, b = 0;
      if (P.packed) {
        const int byte = j >> 2, sh = 2 * (j & 3);
        if (byte < P.width) {
          a = (gp[byte] >> sh) & 3;
          b = (gt[byte] >> sh) & 3;
        }
      } else if (j < P.width) {
        a = gp[j];
        b = gt[j];
      }
      sp[j] = a;
      st[j] = b;
    }
  }
  // staged bytes are visible to the warp after the forward's first
  // __syncwarp, before any extend reads them

  // one byte a step, like the reference oracle
  auto extend = [&](int k, int m) {
    if (m >= Rp) return m;
    const int lo_b = k > 0 ? k : 0;
    // plen, tlen <= R < Rp by contract; the clamps keep a caller that
    // breaks it inside the staged rows.
    int hi_b = min(tlen, min(plen, Rp) + k);
    hi_b = min(max(hi_b, 0), Rp);
    int h = m;
    if (h >= lo_b) {
      while (h < hi_b && sp[h - k] == st[h]) ++h;
    }
    return h;
  };
  const aimwfa::Costs C{smax, K, P.x, P.go, P.ge, P.adaptive};
  const int score = aimwfa::forward(C, S, plen, tlen, lane, extend);
  aimwfa::write_records(C, S, plen, tlen, score, P.backtrace != 0,
                        P.rec + pair * (long)(smax + 4), lane);
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
  if (smax < 0 || Rp <= 0 || width <= 0 ||
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
  P.packed = packed;
  P.smax = smax;
  P.K = 2 * smax + 1;
  P.Rp = Rp;
  P.x = x;
  P.go = go;
  P.ge = ge;
  P.adaptive = adaptive;
  P.backtrace = backtrace;
  P.hist_smem = hist_smem;
  long wb = 12L * (smax + 1) + 2L * Rp;
  if (hist_smem) wb += 6L * (smax + 1) * P.K;
  wb = (wb + 15) / 16 * 16;
  P.warp_bytes = (int)wb;
  const size_t smem = (size_t)wb * kWarps;
  cudaError_t e = cudaFuncSetAttribute(
      wfa2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (n + kWarps - 1) / kWarps;
  wfa2_kernel<<<(unsigned)blocks, 32 * kWarps, smem,
                static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

const char *aim_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
