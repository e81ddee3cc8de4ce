// The growth loop of the plane segmentation's boundary refinement, for
// Hopper (sm_90a), run to its fixed point in one launch.
//
// Replaces the lax.while_loop of rgbd360_tpu/ops/planes_seg.py::
// refine_plane_labels (planes_seg.py:313). It replaces no Pallas kernel: on
// the TPU the loop is XLA code. rgbd360_torch/ops/planes_seg.py is its
// wrapper and holds the plain PyTorch loop (grow_labels_plain) it is held to
// bit for bit.
//
// What it computes, per sensor (one block each), round after round
// (synchronous: every pixel reads the state the round started from):
//   * a pixel that is unlabelled (lab0 < 0), not a non-model region's pixel
//     (grows_static) and has a finite point (valid) takes the largest label
//     among its 4-neighbours that carry one and whose plane fits it, with
//     that neighbour's plane (n, d); the neighbours are visited in the plain
//     loop's order (-1,0), (1,0), (0,-1), (0,1) with a strict cand > best;
//   * a plane fits when |dot3(n, p) - d| < thr in f32, with the arithmetic
//     of ops/normals.py::dot3 on the card (see card_dot3 below);
//   * a round in which no pixel of the sensor grows ends its loop; so does
//     max_sweeps. A converged sensor's further rounds would change nothing,
//     so stopping per sensor gives the batched loop's bits.
//
// State. A grown pixel carries the plane of the label it took, and that
// plane is the one its first carrier had, so a pixel's whole state is one
// int32: the index, within its sensor, of the labelled pixel whose label
// and plane it carries (its label lab0[src], its plane mod_n/mod_d[src]),
// or OPEN (may grow) or SHUT (never grows, never offers a label). Two
// buffers of it alternate between rounds.
//
// What bounds it on the card: neither bytes nor operations, but the rounds,
// each a pass over the sensor and a barrier; the inputs (38 bytes a pixel)
// are read once per round at most, from L1/L2. The two state buffers lie
// in a global scratch the wrapper allocates (2 x 4 bytes a pixel: 153,600
// bytes a sensor of the 8 x 120 x 160 sensor program, 1.47 MB for the
// 1024 x 180 stereo panorama); each sensor's is read and written by its
// block alone, so it stays in L1/L2. One version serves every shape.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (rgbd360_torch/kernels/build.py), in the one library with
// warp_gather.cu. No fast-math flags: the fit test must round as PyTorch's
// elementwise kernels do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int OPEN = -1;
constexpr int SHUT = -2;

// ops/normals.py::dot3 as PyTorch computes it on the card: the first
// product rounded, then torch.addcmul twice, each a fused multiply-add.
__device__ __forceinline__ float card_dot3(float n0, float n1, float n2,
                                           float p0, float p1, float p2) {
  return __fmaf_rn(n2, p2, __fmaf_rn(n1, p1, __fmul_rn(n0, p0)));
}

__global__ void __launch_bounds__(THREADS)
refine_grow_kernel(const int* __restrict__ lab0,          // (S, H, W)
                   const float* __restrict__ mod_n,       // (S, H, W, 3)
                   const float* __restrict__ mod_d,       // (S, H, W)
                   const uint8_t* __restrict__ grows_static,  // (S, H, W)
                   const uint8_t* __restrict__ valid,     // (S, H, W)
                   const float* __restrict__ p,           // (S, H, W, 3)
                   float thr, int max_sweeps, int H, int W,
                   int* __restrict__ out,                 // (S, H, W)
                   int* __restrict__ rounds,              // (S,)
                   int* scratch) {                        // (S, 2, H*W)
  const int hw = H * W;
  const int s = blockIdx.x;
  const size_t base = (size_t)s * hw;
  lab0 += base;
  mod_n += 3 * base;
  mod_d += base;
  grows_static += base;
  valid += base;
  p += 3 * base;
  // plain pointers, not __restrict__: other threads of the block write them
  int* cur = scratch + 2 * base;
  int* nxt = cur + hw;

  for (int i = threadIdx.x; i < hw; i += THREADS) {
    cur[i] = lab0[i] >= 0 ? i : (!grows_static[i] && valid[i] ? OPEN : SHUT);
  }
  __syncthreads();

  int r = 0;
  while (r < max_sweeps) {
    int grew = 0;
    for (int i = threadIdx.x; i < hw; i += THREADS) {
      int v = cur[i];
      if (v == OPEN) {
        const int y = i / W;
        const int x = i - y * W;
        const float p0 = p[3 * i], p1 = p[3 * i + 1], p2 = p[3 * i + 2];
        int best = -1;
        // _shift(arr, dr, dc)[y, x] = arr[y - dr, x - dc]: (-1,0) is the
        // pixel below, (1,0) above, (0,-1) right, (0,1) left
        const int nb[4] = {y + 1 < H ? i + W : -1, y > 0 ? i - W : -1,
                           x + 1 < W ? i + 1 : -1, x > 0 ? i - 1 : -1};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (nb[k] < 0) continue;
          const int u = cur[nb[k]];
          if (u < 0) continue;
          const int cand = lab0[u];
          if (cand <= best) continue;
          const float dot = card_dot3(mod_n[3 * u], mod_n[3 * u + 1], mod_n[3 * u + 2], p0, p1, p2);
          if (fabsf(__fsub_rn(dot, mod_d[u])) < thr) {
            best = cand;
            v = u;
          }
        }
        grew |= best >= 0;
      }
      nxt[i] = v;
    }
    ++r;
    grew = __syncthreads_or(grew);  // also the round's barrier
    int* t = cur;
    cur = nxt;
    nxt = t;
    if (!grew) break;
  }

  for (int i = threadIdx.x; i < hw; i += THREADS) {
    const int v = cur[i];
    out[base + i] = v >= 0 ? lab0[v] : -1;
  }
  if (threadIdx.x == 0) rounds[s] = r;
}

}  // namespace

// Plain C entry, bound with ctypes. Returns the cudaError_t of the launch.
extern "C" int rgbd360_refine_grow(const void* lab0, const void* mod_n,
                                   const void* mod_d, const void* grows_static,
                                   const void* valid, const void* p, float thr,
                                   int max_sweeps, int S, int H, int W,
                                   void* out, void* rounds, void* scratch,
                                   void* stream) {
  if (S <= 0 || H <= 0 || W <= 0 || max_sweeps < 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  refine_grow_kernel<<<S, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(lab0), static_cast<const float*>(mod_n), static_cast<const float*>(mod_d),
      static_cast<const uint8_t*>(grows_static), static_cast<const uint8_t*>(valid), static_cast<const float*>(p),
      thr, max_sweeps, H, W, static_cast<int*>(out), static_cast<int*>(rounds), static_cast<int*>(scratch));
  return (int)cudaGetLastError();
}
