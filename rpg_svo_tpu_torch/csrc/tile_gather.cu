// K1: batched integer tile gather from the padded, stacked image pyramid,
// with the origin clamp inside the kernel.
//
// Replaces the TPU kernel rpg_svo_tpu/ops/pallas_tiles.py::_tile_kernel
// (launched by _gather, called by gather_tiles).  Per item it clamps the
// requested level to [0, L-1] and the requested origin (x0, y0) into that
// level, [0, max(W - tw, 0)] x [0, max(H - th, 0)], offsets it by the
// level's first row in the (Hs, Ws) stack, copies the (th, tw) float tile
// and writes the clamped origins.  The level table (width, height, first
// row per level) comes by value, so nothing is copied to the card per call.
//
// What bounds it on the card: bytes in principle (17x17x256 moves about
// 0.6 MB, 0.18 us at 3.35 TB/s), launch latency in fact: the main path's
// calls are a few thousand floats each.  Design: one thread per output
// element, consecutive threads along the tile row (each row one coalesced
// run), so a 17x17x256 call spreads over about 290 blocks of 256 threads
// and gives every SM work; each thread re-derives its item's clamp from
// three cached int loads instead of waiting on a per-tile leader.  The
// thread of element (0, 0) writes the item's origins.  The TPU's 128-lane
// aligned load plus two rolls is a VMEM layout trick and is not carried
// over.  The copy is exact: tiles and origins are bit-identical to the
// torch clamp plus flat-index gather of ops/tiles.py::gather_tiles_plain.
//
// Stream batches: under torch.func.vmap (parallel/streams.py) one launch
// serves B camera streams, as a pallas_call under jax.vmap gains a grid
// axis.  blockIdx.y is the stream; each stream has its own stack and
// requests (per-stream strides, 0 for a shared one) and writes its own
// tiles and origins.  The single-stream entry point is the same kernel
// with one stream.

#include <cuda_runtime.h>

// Kernel-parameter structs live outside the unnamed namespace: the
// extern "C" entry point takes them, and must keep external linkage.
constexpr int kMaxLevels = 8;

struct LevelTable {
  int n;                 // levels in use
  int w[kMaxLevels];     // level widths
  int h[kMaxLevels];     // level heights
  int off[kMaxLevels];   // first row of each level in the stack
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
tile_gather_kernel(const float* __restrict__ stack, long long stack_bs,
                   int ws, LevelTable tab, const int* __restrict__ level,
                   long long level_bs, long long level_stride,
                   const int* __restrict__ x0, long long x0_bs,
                   long long x0_stride, const int* __restrict__ y0,
                   long long y0_bs, long long y0_stride,
                   float* __restrict__ out, int* __restrict__ org, int n,
                   int th, int tw) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int per_item = th * tw;
  if (e >= static_cast<long long>(n) * per_item) return;
  // this block's stream
  const long long b = blockIdx.y;
  stack += b * stack_bs;
  level += b * level_bs;
  x0 += b * x0_bs;
  y0 += b * y0_bs;
  out += b * n * per_item;
  org += b * 2 * n;
  const int item = static_cast<int>(e / per_item);
  const int rem = static_cast<int>(e - static_cast<long long>(item) *
                                           per_item);
  const int r = rem / tw, c = rem - r * tw;
  const int lv = clampi(level[item * level_stride], 0, tab.n - 1);
  // static indices only: the table stays in the parameter bank
  int W = tab.w[0], H = tab.h[0], off = tab.off[0];
#pragma unroll
  for (int k = 1; k < kMaxLevels; ++k)
    if (k == lv) {
      W = tab.w[k];
      H = tab.h[k];
      off = tab.off[k];
    }
  const int xc = clampi(x0[item * x0_stride], 0, max(W - tw, 0));
  const int yc = clampi(y0[item * y0_stride], 0, max(H - th, 0));
  out[e] = stack[static_cast<long long>(off + yc + r) * ws + xc + c];
  if (rem == 0) {
    org[item] = xc;
    org[n + item] = yc;
  }
}

}  // namespace

// B streams in one launch: stream b reads stack + b * stack_bs and its
// requests at + b * *_bs, and writes out[b] (n, th, tw) and org[b] (2, n).
extern "C" int tile_gather_batched(const float* stack, long long stack_bs,
                                   int ws, LevelTable tab, const int* level,
                                   long long level_bs, long long level_stride,
                                   const int* x0, long long x0_bs,
                                   long long x0_stride, const int* y0,
                                   long long y0_bs, long long y0_stride,
                                   float* out, int* org, int n, int th,
                                   int tw, int nb, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * th * tw;
  if (total > 0 && nb > 0) {
    const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads),
                    static_cast<unsigned>(nb));
    tile_gather_kernel<<<grid, kThreads, 0, stream>>>(
        stack, stack_bs, ws, tab, level, level_bs, level_stride, x0, x0_bs,
        x0_stride, y0, y0_bs, y0_stride, out, org, n, th, tw);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tile_gather(const float* stack, int ws, LevelTable tab,
                           const int* level, long long level_stride,
                           const int* x0, long long x0_stride, const int* y0,
                           long long y0_stride, float* out, int* org, int n,
                           int th, int tw, cudaStream_t stream) {
  return tile_gather_batched(stack, 0, ws, tab, level, 0, level_stride, x0,
                             0, x0_stride, y0, 0, y0_stride, out, org, n, th,
                             tw, 1, stream);
}
