// Windowed warp gather of the dense spherical aligner, for Hopper (sm_90a).
//
// Replaces the TPU kernels of rgbd360_tpu/ops/warp_gather.py:
//   * _kernel_pipelined (single row policy mean/min/max, via
//     warp_gather_batched), and
//   * _kernel_pipelined_multi + _gather_tile (anchor sets ("min","max") and
//     ("mean","min","max"), via warp_gather_batched_multi).
// A single-anchor pass is the multi-anchor pass with one anchor, so one
// kernel serves both; rgbd360_torch/ops/warp_gather.py is its wrapper and
// holds the plain PyTorch version it is held to bit for bit.
//
// What it computes, per (batch, 8-row x 128-column source tile):
//   1. over the tile's active pixels: the column min/max, the seam straddle
//      test (cmax - cmin > W/2) with the +W remap of the low side, and the
//      row min/max — integer warp reductions, then shared-memory atomics;
//   2. per anchor, the 14 x 256 window origin (min- or max-anchored,
//      column 128-aligned, clipped to the padded footprint), and per output
//      row the K = 4-row sub-window of the row policy (row mean, min or max
//      of the in-window targets);
//   3. a pixel is covered when some anchor's window and row sub-window hold
//      its target; a covered pixel copies the 8 target channels as int32
//      bits (never float arithmetic: the planes hold -0.0 and denormals),
//      with channel 6 set to the f32 1.0 flag; an uncovered pixel writes 0.
//
// On the TPU the window is a DMA'd copy in VMEM. Here it is only a coverage
// predicate: a covered pixel reads its target straight from global memory.
// The wrap-halo rule (rgbd360_tpu/ops/warp_gather.py::_wrap_halo) keeps
// every reachable window position off the zero padding, so reading column
// c - Wt for a remapped column c >= Wt equals reading the halo copy.
//
// What bounds it on the card: bytes. Each covered pixel reads 8 x 4 bytes
// at its own target row across the (H, 8, W) layout (channel stride W) and
// writes 8 x 4 bytes plus its mask byte; the arithmetic is a few integer
// reductions per tile. Neighbouring threads take neighbouring source
// columns, whose targets are neighbouring too under a coherent warp, so the
// reads of a warp fall on few cache lines per channel and the writes are
// fully coalesced. This first version keeps one block per tile and no
// staging in shared memory; reusing a tile's target window across its 8
// rows is the obvious next step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (rgbd360_torch/kernels/build.py). No fast-math flags: the
// mean row policy needs the IEEE f32 division of the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BR = 8;     // source tile rows
constexpr int BC = 128;   // source tile columns
constexpr int PR = 14;    // target window rows
constexpr int K = 4;      // per-output-row row window
constexpr int PC = 256;   // target window columns
constexpr int BIG = 1 << 24;
constexpr int FLAG_BITS = 0x3F800000;  // f32 1.0
constexpr int ANCHOR_MEAN = 0;
constexpr int ANCHOR_MIN = 1;
constexpr int ANCHOR_MAX = 2;
constexpr int MAX_ANCHORS = 3;
constexpr unsigned FULL = 0xffffffffu;

struct Anchors {
  int n;
  int code[MAX_ANCHORS];
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// floor division for b > 0 (Python's //, which the origin rule uses)
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void __launch_bounds__(BR * BC)
warp_gather_kernel(const int* __restrict__ planes,     // (B, Ht, 8, Wt) f32 bits
                   const int* __restrict__ r_idx,      // (B, Ho, Wo)
                   const int* __restrict__ c_idx,      // (B, Ho, Wo)
                   const uint8_t* __restrict__ active, // (B, Ho, Wo) or null
                   int* __restrict__ out,              // (B, 8, Ho, Wo) f32 bits
                   uint8_t* __restrict__ mask,         // (B, Ho, Wo)
                   int Ht, int Wt, int Ho, int Wo, int w_eff, int hp,
                   int wp_ext, int read_end, Anchors anchors) {
  const int tx = threadIdx.x;  // tile column
  const int ty = threadIdx.y;  // tile row
  const int lane = tx & 31;
  const int tid = ty * BC + tx;
  const int b = blockIdx.z;
  const int row = blockIdx.y * BR + ty;
  const int col = blockIdx.x * BC + tx;
  const bool inside = row < Ho && col < Wo;
  const size_t pix = ((size_t)b * Ho + row) * Wo + col;

  int r = 0, c = 0;
  bool act = false;
  if (inside) {
    r = r_idx[pix];
    c = c_idx[pix];
    act = active == nullptr || active[pix] != 0;
  }

  __shared__ int s_cmin, s_cmax, s_crmin, s_crmax, s_rmin, s_rmax;
  __shared__ int s_sum[MAX_ANCHORS][BR];
  __shared__ int s_cnt[MAX_ANCHORS][BR];
  __shared__ int s_lmin[MAX_ANCHORS][BR];
  __shared__ int s_lmax[MAX_ANCHORS][BR];
  if (tid == 0) {
    s_cmin = BIG; s_cmax = -BIG;
    s_crmin = BIG; s_crmax = -BIG;
    s_rmin = BIG; s_rmax = -BIG;
  }
  if (tid < MAX_ANCHORS * BR) {
    const int a = tid / BR, i = tid % BR;
    s_sum[a][i] = 0; s_cnt[a][i] = 0;
    s_lmin[a][i] = BIG; s_lmax[a][i] = -BIG;
  }
  __syncthreads();

  // 1. tile statistics over the active pixels. c_always is the remap as if
  // the tile straddled; min/max over it are the remapped extremes
  // (rgbd360_tpu/ops/warp_gather.py::_tile_origins).
  const int half = w_eff / 2;
  const int c_always = c + (c < half ? w_eff : 0);
  {
    int v;
    v = __reduce_min_sync(FULL, act ? c : BIG);
    if (lane == 0) atomicMin(&s_cmin, v);
    v = __reduce_max_sync(FULL, act ? c : -BIG);
    if (lane == 0) atomicMax(&s_cmax, v);
    v = __reduce_min_sync(FULL, act ? c_always : BIG);
    if (lane == 0) atomicMin(&s_crmin, v);
    v = __reduce_max_sync(FULL, act ? c_always : -BIG);
    if (lane == 0) atomicMax(&s_crmax, v);
    v = __reduce_min_sync(FULL, act ? r : BIG);
    if (lane == 0) atomicMin(&s_rmin, v);
    v = __reduce_max_sync(FULL, act ? r : -BIG);
    if (lane == 0) atomicMax(&s_rmax, v);
  }
  __syncthreads();

  const bool straddle = (s_cmax - s_cmin) > half;
  const int cr = (straddle && c < half) ? c + w_eff : c;  // remapped column
  const int cr_min = straddle ? s_crmin : s_cmin;
  const int cr_max = straddle ? s_crmax : s_cmax;

  // 2. per anchor: window origin, then the per-row statistics of the pixels
  // inside the window
  int lr[MAX_ANCHORS];
  bool ok[MAX_ANCHORS];
#pragma unroll
  for (int a = 0; a < MAX_ANCHORS; ++a) {
    lr[a] = 0;
    ok[a] = false;
    if (a >= anchors.n) continue;
    const int code = anchors.code[a];
    int r0, c0;
    if (code == ANCHOR_MAX) {
      r0 = clampi(s_rmax - (PR - 1), 0, hp - PR);
      c0 = clampi(floor_div(cr_max, 128) * 128 - (PC - 128), 0, wp_ext - PC);
    } else {  // "mean" and "min" place min-anchored windows
      r0 = clampi(s_rmin, 0, hp - PR);
      c0 = floor_div(clampi(cr_min, 0, wp_ext - PC), 128) * 128;
    }
    lr[a] = r - r0;
    const int lc = cr - c0;
    ok[a] = act && lc >= 0 && lc < PC;
    if (code == ANCHOR_MEAN) {
      const int s = __reduce_add_sync(FULL, ok[a] ? lr[a] : 0);
      const int n = __reduce_add_sync(FULL, ok[a] ? 1 : 0);
      if (lane == 0) {
        atomicAdd(&s_sum[a][ty], s);
        atomicAdd(&s_cnt[a][ty], n);
      }
    } else if (code == ANCHOR_MIN) {
      const int v = __reduce_min_sync(FULL, ok[a] ? lr[a] : BIG);
      if (lane == 0) atomicMin(&s_lmin[a][ty], v);
    } else {
      const int v = __reduce_max_sync(FULL, ok[a] ? lr[a] : -BIG);
      if (lane == 0) atomicMax(&s_lmax[a][ty], v);
    }
  }
  __syncthreads();

  bool hit = false;
#pragma unroll
  for (int a = 0; a < MAX_ANCHORS; ++a) {
    if (a >= anchors.n) continue;
    const int code = anchors.code[a];
    int lo;
    if (code == ANCHOR_MEAN) {
      // the TPU kernel's f32 order: sum / max(n, 1), minus (K-1)/2, plus
      // 0.5, truncated. Integer row sums are exact in f32 (|sum| < 2^24).
      const float n = fmaxf((float)s_cnt[a][ty], 1.0f);
      const float mean = __fdiv_rn((float)s_sum[a][ty], n);
      lo = (int)__fadd_rn(__fsub_rn(mean, 0.5f * (K - 1)), 0.5f);
    } else if (code == ANCHOR_MIN) {
      lo = s_lmin[a][ty];
    } else {
      lo = s_lmax[a][ty] - (K - 1);
    }
    lo = clampi(lo, 0, PR - K);
    hit = hit || (ok[a] && lr[a] >= lo && lr[a] < lo + K);
  }

  // 3. output: the 8 channels as bits, flag in channel 6
  if (!inside) return;
  const size_t plane = (size_t)Ho * Wo;
  int* o = out + (size_t)b * 8 * plane + (size_t)row * Wo + col;
  const bool readable = r >= 0 && r < Ht && cr >= 0 && cr < read_end;
  if (hit && readable) {
    const int cc = cr >= Wt ? cr - Wt : cr;
    const int* src = planes + ((size_t)b * Ht + r) * 8 * (size_t)Wt + cc;
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) {
      o[ch * plane] = ch == 6 ? FLAG_BITS : src[(size_t)ch * Wt];
    }
  } else {
#pragma unroll
    for (int ch = 0; ch < 8; ++ch) {
      o[ch * plane] = (ch == 6 && hit) ? FLAG_BITS : 0;
    }
  }
  mask[pix] = hit ? 1 : 0;
}

}  // namespace

// Plain C entry, bound with ctypes. Returns the cudaError_t of the launch.
extern "C" int rgbd360_warp_gather(const void* planes, const void* r_idx,
                                   const void* c_idx, const void* active,
                                   void* out, void* mask, int B, int Ht,
                                   int Wt, int Ho, int Wo, int w_eff, int hp,
                                   int wp_ext, int read_end, int n_anchors,
                                   int a0, int a1, int a2, void* stream) {
  if (n_anchors < 1 || n_anchors > MAX_ANCHORS) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Ho <= 0 || Wo <= 0) return 0;
  Anchors anchors;
  anchors.n = n_anchors;
  anchors.code[0] = a0;
  anchors.code[1] = a1;
  anchors.code[2] = a2;
  const dim3 block(BC, BR);
  const dim3 grid((Wo + BC - 1) / BC, (Ho + BR - 1) / BR, B);
  warp_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(planes), static_cast<const int*>(r_idx),
      static_cast<const int*>(c_idx), static_cast<const uint8_t*>(active),
      static_cast<int*>(out), static_cast<uint8_t*>(mask), Ht, Wt, Ho, Wo,
      w_eff, hp, wp_ext, read_end, anchors);
  return (int)cudaGetLastError();
}
