// M1 and M2: primitive-cost probes for NVIDIA Hopper (sm_90a).
//
// Replace the TPU probes of tools/microbench_mosaic.py: the twelve kernels
// `_mk` builds (:39; bodies :69-249) and `build_dynslice_row` (:252).
// Each probe repeats one body `reps` times with a carried dependency and
// writes the same output as the Pallas probe; ops/probes.py holds each
// against its plain PyTorch version and tools/microbench.py times it at two
// rep counts, so the slope is the cost of one rep on this card.  Each
// design answers the question the probe asks here, not the TPU's tiling:
//
//   elementwise   popcount, varshift (u32 rotate), i32 min: one thread an
//                 element; i8 min: one thread a word of four int8, Hopper's
//                 SIMD-in-word __vadd4 / __vmins4 (K3's int8 question).
//   row-local     lane gather and word select: a row of 128 a warp, four
//                 values a thread, the row's table in shared memory; lane
//                 roll: four consecutive values a thread, one __shfl_sync a
//                 rep; one-hot column gather: the row in registers, the
//                 column fetched by one __shfl_sync from its owner lane.
//   tile-wide     sublane gather and roll, transpose, the while loop: the
//                 whole tile in one block; the roll and the transpose pass
//                 the tile through shared memory between two
//                 __syncthreads (the transpose's 128 x 129 padded tile,
//                 66 KB, needs dynamic shared memory past 48 KB), the while
//                 loop's tile-wide exit is __syncthreads_or.
//   M2            every element's history chain is its own, so a block of
//                 128 elements keeps its 62 history rows in shared memory
//                 (31 KB), 56 blocks for the [56, 128] tile (as K1 and K4
//                 keep their history rows).
//
// What bounds them: nothing but the dependent chain of each rep (a few
// integer instructions, a shuffle, a shared-memory round trip or a block
// barrier); bytes are a few tens of KB.  Arithmetic is the reference's:
// int32 wraps (done in unsigned), `%` is floor-mod, the rotate is on u32,
// int8 wraps per byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t *a;  // first input
  const int32_t *b;  // second input (or null)
  int32_t *out;
  int reps;
};

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// floor-mod, as jnp's `%`
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return (r != 0 && ((r < 0) != (m < 0))) ? r + m : r;
}

// ---- M1 :69  lane gather, src/idx [448, 128]: warp a row, 4 a thread ----
__global__ void __launch_bounds__(256) gather_lanes(const Args P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t *src = reinterpret_cast<int32_t *>(smem);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + w;
  for (int q = 0; q < 4; ++q)
    src[w * 128 + lane + 32 * q] = P.a[row * 128 + lane + 32 * q];
  __syncwarp();
  int idx[4], acc[4];
  for (int q = 0; q < 4; ++q) {
    idx[q] = P.b[row * 128 + lane + 32 * q];
    acc[q] = 0;
  }
  for (int i = 0; i < P.reps; ++i)
    for (int q = 0; q < 4; ++q)
      acc[q] = floor_mod(
          wadd(acc[q], src[w * 128 + floor_mod(wadd(idx[q], acc[q]), 128)]),
          7);
  for (int q = 0; q < 4; ++q) P.out[row * 128 + lane + 32 * q] = acc[q];
}

// ---- M1 :88  sublane gather, src/idx [56, 128]: the tile in one block ----
__global__ void __launch_bounds__(1024) gather_sublanes(const Args P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t *src = reinterpret_cast<int32_t *>(smem);
  const int t = threadIdx.x;
  int idx[7], acc[7];
  for (int k = 0; k < 7; ++k) {
    src[t + 1024 * k] = P.a[t + 1024 * k];
    idx[k] = P.b[t + 1024 * k];
    acc[k] = 0;
  }
  __syncthreads();
  const int c = t & 127;
  for (int i = 0; i < P.reps; ++i)
    for (int k = 0; k < 7; ++k)
      acc[k] = floor_mod(
          wadd(acc[k], src[floor_mod(wadd(idx[k], acc[k]), 56) * 128 + c]),
          7);
  for (int k = 0; k < 7; ++k) P.out[t + 1024 * k] = acc[k];
}

// ---- M1 :106  sublane roll by one, [56, 128]: the tile in one block ----
__global__ void __launch_bounds__(1024) roll_sublane(const Args P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t *tile = reinterpret_cast<int32_t *>(smem);
  const int t = threadIdx.x;
  int acc[7];
  for (int k = 0; k < 7; ++k) acc[k] = P.a[t + 1024 * k];
  // element t + 1024k is row t/128 + 8k; after the roll it takes the value
  // of the row above (row 55 for row 0)
  const int r0 = t >> 7, c = t & 127;
  for (int i = 0; i < P.reps; ++i) {
    for (int k = 0; k < 7; ++k) tile[t + 1024 * k] = acc[k];
    __syncthreads();
    for (int k = 0; k < 7; ++k)
      acc[k] = wadd(tile[floor_mod(r0 + 8 * k - 1, 56) * 128 + c], 1);
    __syncthreads();
  }
  for (int k = 0; k < 7; ++k) P.out[t + 1024 * k] = acc[k];
}

// ---- M1 :117  lane roll by one, [56, 128]: warp a row, 4 consecutive
// values a thread, one shuffle a rep ----
__global__ void __launch_bounds__(256) roll_lane(const Args P) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int base = row * 128 + 4 * lane;
  int v0 = P.a[base], v1 = P.a[base + 1], v2 = P.a[base + 2],
      v3 = P.a[base + 3];
  for (int i = 0; i < P.reps; ++i) {
    const int in = __shfl_sync(kFull, v3, (lane + 31) & 31);
    v3 = wadd(v2, 1);
    v2 = wadd(v1, 1);
    v1 = wadd(v0, 1);
    v0 = wadd(in, 1);
  }
  P.out[base] = v0;
  P.out[base + 1] = v1;
  P.out[base + 2] = v2;
  P.out[base + 3] = v3;
}

// ---- M1 :128  popcount, [56, 128]: one thread an element ----
__global__ void __launch_bounds__(256) popcount(const Args P) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int x = P.a[e];
  int acc = x;
  for (int i = 0; i < P.reps; ++i)
    acc = wadd(__popc(acc ^ x), floor_mod(acc, 3));
  P.out[e] = acc;
}

// ---- M1 :139  per-element rotate on u32, [56, 128] ----
__global__ void __launch_bounds__(256) varshift(const Args P) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int s = P.b[e];
  const unsigned r = (unsigned)s, l = (unsigned)floor_mod(32 - s, 32);
  unsigned u = (unsigned)P.a[e];
  for (int i = 0; i < P.reps; ++i)
    u = (r < 32u ? u >> r : 0u) | (l < 32u ? u << l : 0u);
  P.out[e] = (int)u;
}

// ---- M1 :155  min(acc + 1, x) + (acc & 3) in int32, [128, 128] ----
__global__ void __launch_bounds__(256) i32_min(const Args P) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int x = P.a[e];
  int acc = x;
  for (int i = 0; i < P.reps; ++i) acc = wadd(min(wadd(acc, 1), x), acc & 3);
  P.out[e] = acc;
}

// ---- M1 :168  the same in int8, [128, 128]: four a word, SIMD-in-word ----
__global__ void __launch_bounds__(256) i8_min(const Args P) {
  const int e = blockIdx.x * 256 + threadIdx.x;  // word: 4 int8 elements
  const unsigned x = (unsigned)P.a[e];
  unsigned acc = x;
  for (int i = 0; i < P.reps; ++i)
    acc = __vadd4(__vmins4(__vadd4(acc, 0x01010101u), x), acc & 0x03030303u);
  P.out[e] = (int)acc;
}

// ---- M1 :181  while loop with a tile-wide max exit, [56, 128] ----
__global__ void __launch_bounds__(1024) while_loop(const Args P) {
  const int t = threadIdx.x;
  int acc[7], x5[7];
  for (int k = 0; k < 7; ++k) {
    acc[k] = P.a[t + 1024 * k];
    x5[k] = floor_mod(acc[k], 5);
  }
  for (int i = 0; i < P.reps; ++i) {
    int big = 0;
    for (int k = 0; k < 7; ++k) big |= acc[k] >= 1000000;
    if (__syncthreads_or(big)) break;
    for (int k = 0; k < 7; ++k)
      acc[k] = min(wadd(acc[k], 1), wadd(wadd(acc[k], acc[k]), x5[k]));
  }
  for (int k = 0; k < 7; ++k) P.out[t + 1024 * k] = acc[k];
}

// ---- M1 :200  word select from w[8, 128] for q[56, 128]: warp a row ----
__global__ void __launch_bounds__(256) onehot_wordsel(const Args P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t *w = reinterpret_cast<int32_t *>(smem);
  for (int j = threadIdx.x; j < 8 * 128; j += 256) w[j] = P.a[j];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  int q[4], acc[4];
  for (int k = 0; k < 4; ++k) {
    q[k] = P.b[row * 128 + lane + 32 * k];
    acc[k] = 0;
  }
  for (int i = 0; i < P.reps; ++i)
    for (int k = 0; k < 4; ++k)
      acc[k] = floor_mod(
          w[floor_mod(wadd(q[k], acc[k]), 8) * 128 + lane + 32 * k], 9);
  for (int k = 0; k < 4; ++k) P.out[row * 128 + lane + 32 * k] = acc[k];
}

// ---- M1 :221  transpose + 1, [128, 128]: one block, a padded tile ----
constexpr int kTp = 129;  // the tile's row pitch: the column read is
                          // conflict-free
__global__ void __launch_bounds__(1024) transpose(const Args P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t *tile = reinterpret_cast<int32_t *>(smem);
  const int t = threadIdx.x;
  const int r0 = t >> 7, c = t & 127;  // element t + 1024k: row r0 + 8k
  int acc[16];
  for (int k = 0; k < 16; ++k) acc[k] = P.a[t + 1024 * k];
  for (int i = 0; i < P.reps; ++i) {
    for (int k = 0; k < 16; ++k) tile[(r0 + 8 * k) * kTp + c] = acc[k];
    __syncthreads();
    for (int k = 0; k < 16; ++k) acc[k] = wadd(tile[c * kTp + r0 + 8 * k], 1);
    __syncthreads();
  }
  for (int k = 0; k < 16; ++k) P.out[t + 1024 * k] = acc[k];
}

// ---- M1 :232  one-hot column gather nm[128, 128] -> [128, 1]: the row in
// a warp's registers, the column from its owner lane ----
__global__ void __launch_bounds__(256) onehot_reduce(const Args P) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int *nr = P.a + row * 128 + 4 * lane;
  const int n0 = nr[0], n1 = nr[1], n2 = nr[2], n3 = nr[3];
  const int off = P.b[row];
  int acc = 0;
  for (int i = 0; i < P.reps; ++i) {
    const int col = floor_mod(wadd(off, acc), 111);
    const int s = col & 3;
    const int mine = s == 0 ? n0 : s == 1 ? n1 : s == 2 ? n2 : n3;
    acc = floor_mod(wadd(acc, __shfl_sync(kFull, mine, col >> 2)), 5);
  }
  if (lane == 0) P.out[row] = acc;
}

// ---- M2 :252  dynamic history rows: hist[s] + 1 read, min(r, acc) into
// hist[s+1], s = i % 60; a block's 128 elements keep their rows in shared
// memory ----
constexpr int kHistRows = 62;
__global__ void __launch_bounds__(128) dynslice_row(const Args P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t *hist = reinterpret_cast<int32_t *>(smem);
  const int t = threadIdx.x;
  const int e = blockIdx.x * 128 + t;
  int acc = P.a[e];
  hist[t] = acc;
  for (int i = 0; i < P.reps; ++i) {
    const int s = i % 60;
    const int r = wadd(hist[s * 128 + t], 1);
    hist[(s + 1) * 128 + t] = min(r, acc);
    acc = floor_mod(r, 97);
  }
  P.out[e] = acc;
}

struct Shape {
  void (*kern)(const Args);
  unsigned blocks, threads;
  size_t smem;
};

// in the order of ops/probes.py PROBES
Shape shape_of(int probe) {
  switch (probe) {
    case 0: return {gather_lanes, 56, 256, 8 * 128 * 4};
    case 1: return {gather_sublanes, 1, 1024, 56 * 128 * 4};
    case 2: return {roll_sublane, 1, 1024, 56 * 128 * 4};
    case 3: return {roll_lane, 7, 256, 0};
    case 4: return {popcount, 28, 256, 0};
    case 5: return {varshift, 28, 256, 0};
    case 6: return {i32_min, 64, 256, 0};
    case 7: return {i8_min, 16, 256, 0};
    case 8: return {while_loop, 1, 1024, 0};
    case 9: return {onehot_wordsel, 7, 256, 8 * 128 * 4};
    case 10: return {transpose, 1, 1024, 128 * kTp * 4};
    case 11: return {onehot_reduce, 16, 256, 0};
    case 12: return {dynslice_row, 56, 128, kHistRows * 128 * 4};
    default: return {nullptr, 0, 0, 0};
  }
}

}  // namespace

extern "C" {

// Launches probe `probe` (its index in ops/probes.py PROBES) on `stream`
// at its fixed shape.  Returns cudaGetLastError() after the launch (0 on
// success); the caller raises on anything else.
int aim_probe(int probe, const void *a, const void *b, void *out, int reps,
              void *stream) {
  const Shape S = shape_of(probe);
  if (S.kern == nullptr || reps < 0) return (int)cudaErrorInvalidValue;
  Args P;
  P.a = static_cast<const int32_t *>(a);
  P.b = static_cast<const int32_t *>(b);
  P.out = static_cast<int32_t *>(out);
  P.reps = reps;
  void (*kern)(const Args) = S.kern;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S.smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<S.blocks, S.threads, S.smem, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

}  // extern "C"
