// K2: the whole coarse-to-fine sparse image alignment, in one launch.
//
// Replaces the TPU kernel rpg_svo_tpu/ops/pallas_align.py::_gn_kernel
// (launched by level_gn_kernel once per pyramid level, after an XLA
// precompute and a tile gather per level).  Semantics are those of
// ops/sparse_align.sparse_img_align_plain (svo/src/sparse_img_align.cpp:
// 43-258 with vk::NLLSSolver).  For each level from max_level down to
// min_level, one CTA:
//
// 1. prologue: cuts each feature's bordered reference patch from the
//    reference stack (8x8 origin floor(px*s) - 3 clamped into the level,
//    valid only if unclamped; 4-tap blend with the feature's fraction;
//    central differences), forms its inverse-compositional Jacobian
//    (16, 6) = grad . jacobian_xyz2uv(f * depth) * fx * s, and its 21
//    normal-equation H terms summed over its 16 pixels in pixel order;
// 2. tile origins: floor(world2cam(T * p) * s) - 2 - 6 at the level's
//    starting pose, clamped into the level as gather_tiles does; the
//    bilinear window is then read straight from the current stack at
//    (first row + y0c + iy + py, x0c + ix + px), the values the 17x17 tile
//    would hold, with _window's rule that the 5x5 support stays inside it;
// 3. Gauss-Newton: per iteration the masked residuals, Jr and chi2 over
//    (feature, pixel) pairs, the masked features' H terms, a +1e-8-damped
//    6x6 Cholesky (NaN means rollback), T <- T * exp(-x); best pose kept,
//    stop on rollback, a chi2 plateau (rel. 1e-4) or max|x| < eps within
//    n_iter iterations, decided on the card; a final evaluation keeps the
//    better of the last and the best pose, which starts the next level.
//
// What bounds it on the card: neither bytes nor operations.  The inputs
// these features need are each valid feature's 7x7 reference region and
// at least the 5x5 current region of its windows at each level, about
// 0.1 MB at N = 128 (0.03 us at 3.35 TB/s); the operations are about 1600
// per valid feature and level for the prologue and 450 per valid feature
// and pass (under 0.03 us at 67 TFLOP/s).  The floor is the serial chain
// of iterations, each a pixel pass, a block reduction and a 6x6 solve.
// Design, against the length of that chain:
// - one CTA of 512 threads (16 warps) keeps every feature's per-level
//   constants (reference patch, Jacobian, H terms, point, tile origin) in
//   shared memory, 600 B per feature, so H costs no per-pixel work in the
//   loop;
// - in a pass, (feature, pixel) pairs map to threads, 16 lanes per
//   feature; each lane projects its feature itself (no barrier between
//   projection and window), and the pass loop carries no branch, so the
//   window loads of several passes can be in flight together;
// - a lane's 7 per-pixel sums (Jr, r^2) are folded over its feature's 16
//   lanes by a transpose-halving reduction (8 shuffles for all 7), the 29
//   block sums by one group of 16 lanes per sum;
// - each warp stages its features' 8x8 reference tiles in shared memory
//   with coalesced loads before blending them; Jacobian rows keep an odd
//   per-feature stride (17) so that the H-term pass, one thread per
//   (feature, term) with features fastest, reads 32 banks per warp;
// - thread 0 solves and decides; the Cholesky takes a reciprocal square
//   root per pivot instead of a square root and divisions, which shortens
//   that one-thread chain.
// Tensor cores and TMA do not fit: Jr is a 6 x 16N GEMV, the window reads
// are data-dependent gathers, and the time is the chain of iterations.
// The TPU kernel's one-hot window contractions and features-in-lanes
// transpose are layout work and are not carried over.
//
// Stream batches: under torch.func.vmap (parallel/streams.py) one launch
// aligns B camera streams, as a pallas_call under jax.vmap gains a grid
// axis.  Block b aligns stream b: its own reference and current stacks,
// features, initial pose and output row, at per-stream strides (0 for an
// input the streams share); the camera, level table, iteration count,
// eps and level range are shared.  Each block is the single-stream
// alignment as it stands, with its shared-memory budget per block; the
// single-stream entry point is the same kernel with one block.
//
// Build without fast math: the rollback test needs NaN from the reciprocal
// square root of a negative pivot, and NaN must propagate through the
// comparisons exactly as in the reference (converged = !anynan &&
// max|x| < eps; the reported chi2 is a NaN-propagating min).

#include <cuda_runtime.h>
#include <math.h>

// Kernel-parameter structs live outside the unnamed namespace: the
// extern "C" entry point takes them, and must keep external linkage.
constexpr int kMaxLevels = 8;

struct LevelTable {
  int n;
  int w[kMaxLevels];
  int h[kMaxLevels];
  int off[kMaxLevels];
};

struct Cam {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3;
  int distort;  // 0 for PinholeCameraIdeal: world2cam skips the distortion
};

// Elements from one stream's inputs to the next (0: shared by the streams).
struct StreamStrides {
  long long ref, cur, px, f, depth, valid, R, t;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFeatsPerPass = 2 * kWarps;  // 16 lanes per feature
constexpr int kPatch = 4;
constexpr int kArea = kPatch * kPatch;
constexpr int kHalf = 2;
constexpr int kSlack = 6;
constexpr int kTile = kPatch + 1 + 2 * kSlack;  // 17
constexpr int kRefTile = kPatch + 4;            // 8: bordered 6x6 + blend
constexpr int kJStride = kArea + 1;  // odd per-feature stride of J rows
// a warp's staging area for its two features' 8x8 reference tiles; the
// second starts 68 floats on, so the blends' reads of the two hit
// different banks
constexpr int kStageFeat = kRefTile * kRefTile + 4;
constexpr int kStage = 2 * kStageFeat;
constexpr int kHTerms = 21;
constexpr int kSums = 29;  // 21 H (upper triangle), 6 Jr, sum r^2, n_feat
// floats of shared memory per feature: Jacobian, reference patch, H terms;
// point, pixel, depth, input validity; tile origin, its stack offset,
// validity at the level
constexpr int kSmemPerFeat =
    6 * kJStride + kArea + kHTerms + 3 + 2 + 1 + 1 + 2 + 1 + 1;
// output row: [0, 9) R, [9, 12) t, [12, 48) H, 48 chi2, 49 n_meas;
// int32 slots: 50 tracked features, 56 + l iterations run at level l
constexpr int kOutTracked = 50;
constexpr int kOutIters = 56;
constexpr int kOutLen = 64;

static_assert(kWarps * (32 / kWarps) == 32 && kWarps <= 32,
              "the cross-warp reduction needs a power-of-two warp count");
static_assert(kSums <= 32, "one lane per sum in the cross-warp reduction");

// (a, b) of the 21 upper-triangle H terms, row-major
__constant__ unsigned char kTermA[kHTerms] = {0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
                                              2, 2, 2, 2, 3, 3, 3, 4, 4, 5};
__constant__ unsigned char kTermB[kHTerms] = {0, 1, 2, 3, 4, 5, 1, 2, 3, 4, 5,
                                              2, 3, 4, 5, 3, 4, 5, 4, 5, 5};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool isnan_f(float x) { return x != x; }

// NaN-propagating min, as torch.minimum.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (isnan_f(a) || isnan_f(b)) return NAN;
  return a < b ? a : b;
}

// Level l's width, height and first row, by static indices only, so the
// table stays in the parameter bank.
__device__ __forceinline__ void level_dims(const LevelTable& tab, int lv,
                                           int& W, int& H, int& off) {
  W = tab.w[0];
  H = tab.h[0];
  off = tab.off[0];
#pragma unroll
  for (int k = 1; k < kMaxLevels; ++k)
    if (k == lv) {
      W = tab.w[k];
      H = tab.h[k];
      off = tab.off[k];
    }
}

// The clamped origin of a feature's 8x8 reference tile at a level, and the
// unclamped one it wanted (ops/sparse_align._precompute_level).
__device__ __forceinline__ void ref_origin(float ux, float uy, int W, int H,
                                           int& xc, int& yc, int& wantx,
                                           int& wanty) {
  wantx = static_cast<int>(floorf(ux)) - (kHalf + 1);
  wanty = static_cast<int>(floorf(uy)) - (kHalf + 1);
  xc = clampi(wantx, 0, max(W - kRefTile, 0));
  yc = clampi(wanty, 0, max(H - kRefTile, 0));
}

// geometry/cameras.py world2cam of the camera-frame point, times scale.
__device__ __forceinline__ void project(const Cam& cam, float pcx, float pcy,
                                        float pcz, float scale, float& u,
                                        float& v) {
  const float zs = fabsf(pcz) < 1e-10f ? 1e-10f : pcz;
  float xd = pcx / zs, yd = pcy / zs;
  if (cam.distort) {
    const float xu = xd, yu = yd;
    const float r2 = xu * xu + yu * yu;
    const float radial = 1.f + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3));
    xd = xu * radial + 2.f * cam.p1 * xu * yu + cam.p2 * (r2 + 2.f * xu * xu);
    yd = yu * radial + cam.p1 * (r2 + 2.f * yu * yu) + 2.f * cam.p2 * xu * yu;
  }
  u = (cam.fx * xd + cam.cx) * scale;
  v = (cam.fy * yd + cam.cy) * scale;
}

// Per-feature state in dynamic shared memory (N features).
struct Feats {
  float* jac;    // [6][N * kJStride]
  float* ref;    // [N * 16] reference patch
  float* hf;     // [N][21] H terms
  float* pref;   // [N][3] reference point f * depth
  float* px;     // [N][2] level-0 pixel
  float* depth;  // [N]
  int* valid;    // [N] input validity
  float* bxy;    // [N][2] clamped 17x17 tile origin (x0c, y0c) as floats
  int* gofs;     // [N] stack offset of the tile origin
  int* ok;       // [N] valid at this level
};

// Once per launch: the features into shared memory.
__device__ void load_features(const Feats& F, const float* __restrict__ px,
                              const float* __restrict__ fb,
                              const float* __restrict__ depth,
                              const unsigned char* __restrict__ valid, int n) {
  for (int f = threadIdx.x; f < n; f += kThreads) {
    const float d = depth[f];
    F.px[2 * f] = px[2 * f];
    F.px[2 * f + 1] = px[2 * f + 1];
    F.depth[f] = d;
    F.valid[f] = valid[f];
    for (int c = 0; c < 3; ++c) F.pref[3 * f + c] = fb[3 * f + c] * d;
  }
}

// Prologue of one level: reference patch, Jacobian and validity of every
// (feature, pixel) pair (ops/sparse_align._precompute_level).  Each warp
// stages its two features' 8x8 tiles in shared memory with four coalesced
// loads per lane, then blends from there.
__device__ void precompute(const Feats& F, float (*stage)[kStage],
                           const float* __restrict__ ref_stack, int ws, int W,
                           int H, int off, float scale, float fxs, int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = lane & 15, py = p >> 2, pxl = p & 3;
  float* st = stage[warp] + (lane >> 4) * kStageFeat;
  for (int f0 = 0; f0 < n; f0 += kFeatsPerPass) {
    const int f = f0 + 2 * warp + (lane >> 4);
    const int fc = min(f, n - 1);
    const float ux = F.px[2 * fc] * scale, uy = F.px[2 * fc + 1] * scale;
    int xc, yc, wantx, wanty;
    ref_origin(ux, uy, W, H, xc, yc, wantx, wanty);
    const float* t = ref_stack + static_cast<long long>(off + yc) * ws + xc;
#pragma unroll
    for (int j = 0; j < kRefTile * kRefTile / 16; ++j) {
      const int e = p + 16 * j, r = e / kRefTile, c = e % kRefTile;
      st[r * kRefTile + c] = t[static_cast<long long>(r) * ws + c];
    }
    __syncwarp();
    const float wx = ux - floorf(ux), wy = uy - floorf(uy);
    const float w00 = (1.f - wy) * (1.f - wx), w01 = (1.f - wy) * wx;
    const float w10 = wy * (1.f - wx), w11 = wy * wx;
    // the bordered patch pb(i, j) = 4-tap blend of the tile at (i, j)
    auto pb = [&](int i, int j) {
      const float* a = st + i * kRefTile + j;
      return w00 * a[0] + w01 * a[1] + w10 * a[kRefTile] +
             w11 * a[kRefTile + 1];
    };
    const float val = pb(1 + py, 1 + pxl);
    const float dx = 0.5f * (pb(1 + py, 2 + pxl) - pb(1 + py, pxl));
    const float dy = 0.5f * (pb(2 + py, 1 + pxl) - pb(py, 1 + pxl));
    __syncwarp();
    const float x = F.pref[3 * fc], y = F.pref[3 * fc + 1],
                z = F.pref[3 * fc + 2];
    // geometry/triangulation.jacobian_xyz2uv
    const float zi = 1.f / (fabsf(z) < 1e-10f ? 1e-10f : z);
    const float zi2 = zi * zi;
    const float j0[6] = {-zi, 0.f, x * zi2, y * x * zi2,
                         -(1.f + x * x * zi2), y * zi};
    const float j1[6] = {0.f, -zi, y * zi2, 1.f + y * y * zi2,
                         -x * y * zi2, -x * zi};
    if (f < n) {
#pragma unroll
      for (int a = 0; a < 6; ++a)
        F.jac[a * n * kJStride + f * kJStride + p] =
            (dx * j0[a] + dy * j1[a]) * fxs;
      F.ref[f * kArea + p] = val;
      if (p == 0)
        F.ok[f] = F.valid[f] && F.depth[f] > 1e-6f && xc == wantx &&
                  yc == wanty;
    }
  }
}

// After the prologue: each feature's 21 H terms, summed over its 16 pixels
// in pixel order, one thread per (feature, term) with features fastest;
// each feature's clamped 17x17 tile origin at pose T.
__device__ void level_setup(const Feats& F, const float* T, const Cam& cam,
                            int ws, int W, int H, int off, float scale,
                            int n) {
  for (int k = threadIdx.x; k < n * kHTerms; k += kThreads) {
    const int term = k / n, f = k - term * n;
    const float* ja = F.jac + kTermA[term] * n * kJStride + f * kJStride;
    const float* jb = F.jac + kTermB[term] * n * kJStride + f * kJStride;
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kArea; ++p) s += ja[p] * jb[p];
    F.hf[f * kHTerms + term] = s;
  }
  for (int f = threadIdx.x; f < n; f += kThreads) {
    const float X = F.pref[3 * f], Y = F.pref[3 * f + 1],
                Z = F.pref[3 * f + 2];
    float u, v;
    project(cam, T[0] * X + T[1] * Y + T[2] * Z + T[9],
            T[3] * X + T[4] * Y + T[5] * Z + T[10],
            T[6] * X + T[7] * Y + T[8] * Z + T[11], scale, u, v);
    // int32 arithmetic wraps, as the reference's does
    const int bx = static_cast<int>(static_cast<unsigned>(
        static_cast<int>(floorf(u))) - (kHalf + kSlack));
    const int by = static_cast<int>(static_cast<unsigned>(
        static_cast<int>(floorf(v))) - (kHalf + kSlack));
    const int xc = clampi(bx, 0, max(W - kTile, 0));
    const int yc = clampi(by, 0, max(H - kTile, 0));
    F.bxy[2 * f] = static_cast<float>(xc);
    F.bxy[2 * f + 1] = static_cast<float>(yc);
    F.gofs[f] = (off + yc) * ws + xc;
  }
}

// One residual pass at pose T over the features; the 29 sums land in tot
// (shared): [0, 21) H of the masked features, [21, 27) sum res * J (Jr
// negated), 27 sum res^2, 28 masked features.
__device__ void evaluate(const Feats& F, const float* Ts,
                         const float* __restrict__ cur, int ws,
                         const Cam& cam, float scale, int n,
                         float (*warp_part)[32], float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = lane & 15, py = p >> 2, pxl = p & 3;
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = Ts[k];
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // Jr 6, r^2, pad
  float ha = 0.f, hb = 0.f;  // H term p; H term 16 + p (p < 5), count (5)
#pragma unroll 4
  for (int f0 = 0; f0 < n; f0 += kFeatsPerPass) {
    const int f = f0 + 2 * warp + (lane >> 4);
    const int fc = min(f, n - 1);
    // the feature's window at pose T (each of its 16 lanes alike)
    const float X = F.pref[3 * fc], Y = F.pref[3 * fc + 1],
                Z = F.pref[3 * fc + 2];
    const float pcz = T[6] * X + T[7] * Y + T[8] * Z + T[11];
    float u, vv;
    project(cam, T[0] * X + T[1] * Y + T[2] * Z + T[9],
            T[3] * X + T[4] * Y + T[5] * Z + T[10], pcz, scale, u, vv);
    const float ox = u - kHalf - F.bxy[2 * fc];
    const float oy = vv - kHalf - F.bxy[2 * fc + 1];
    const float oxf = floorf(ox), oyf = floorf(oy);
    // the 5x5 support stays inside the 17x17 tile (NaN fails the test)
    const bool usable = oxf >= 0.f && oyf >= 0.f &&
                        oxf <= static_cast<float>(kTile - kPatch - 1) &&
                        oyf <= static_cast<float>(kTile - kPatch - 1);
    const bool m = f < n && F.ok[fc] && usable && !(pcz <= 1e-6f);
    // a masked feature reads the stack's first samples and adds nothing
    const int o = m ? F.gofs[fc] + static_cast<int>(oyf) * ws +
                          static_cast<int>(oxf)
                    : 0;
    const float* r0 = cur + o + py * ws + pxl;
    const float* r1 = r0 + ws;
    const float wx = ox - oxf, wy = oy - oyf;
    // bilinear: along y first, then along x (the reference order)
    const float c0 = (1.f - wy) * r0[0] + wy * r1[0];
    const float c1 = (1.f - wy) * r0[1] + wy * r1[1];
    const float res = ((1.f - wx) * c0 + wx * c1) - F.ref[fc * kArea + p];
    float jr[6];
#pragma unroll
    for (int a = 0; a < 6; ++a)
      jr[a] = F.jac[a * n * kJStride + fc * kJStride + p];
    const float h0 = F.hf[fc * kHTerms + p];
    const float h1 = p < kHTerms - 16 ? F.hf[fc * kHTerms + 16 + p]
                                      : (p == kHTerms - 16 ? 1.f : 0.f);
    if (m) {
#pragma unroll
      for (int a = 0; a < 6; ++a) v[a] += res * jr[a];
      v[6] += res * res;
      ha += h0;
      hb += h1;
    }
  }
  // lanes l and l ^ 16 hold the same pixel of two features: fold them
  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < 7; ++k) v[k] += __shfl_xor_sync(full, v[k], 16);
  ha += __shfl_xor_sync(full, ha, 16);
  hb += __shfl_xor_sync(full, hb, 16);
  // transpose-halving over the 16 pixels: at each step a lane keeps half
  // of its values and receives its partner's partial sums of that half
  const bool b8 = lane & 8, b4 = lane & 4, b2 = lane & 2;
  float w4[4], w2[2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    w4[j] = (b8 ? v[j + 4] : v[j]) +
            __shfl_xor_sync(full, b8 ? v[j] : v[j + 4], 8);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    w2[j] = (b4 ? w4[j + 2] : w4[j]) +
            __shfl_xor_sync(full, b4 ? w4[j] : w4[j + 2], 4);
  float w1 = (b2 ? w2[1] : w2[0]) + __shfl_xor_sync(full, b2 ? w2[0] : w2[1], 2);
  w1 += __shfl_xor_sync(full, w1, 1);
  // lane l now holds the warp's sum of value 4 b8 + 2 b4 + b2
  const int idx = (b8 ? 4 : 0) + (b4 ? 2 : 0) + (b2 ? 1 : 0);
  if (lane < 16) {
    warp_part[warp][lane] = ha;
    if (lane < kHTerms - 16) warp_part[warp][16 + lane] = hb;
    if (lane == kHTerms - 16) warp_part[warp][28] = hb;
    if (!(lane & 1) && idx < 7) warp_part[warp][21 + idx] = w1;
  }
  __syncthreads();
  // one group of kWarps lanes per sum: 32 / kWarps sums per warp
  const int g = lane / kWarps, r = lane - g * kWarps;
  const int k = warp + kWarps * g;
  float s = k < kSums ? warp_part[r][k] : 0.f;
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1) s += __shfl_xor_sync(full, s, o);
  if (r == 0 && k < kSums) tot[k] = s;
  __syncthreads();
}

// x = (H + 1e-8 I)^-1 Jr by unrolled Cholesky, with the reciprocal square
// root of each pivot in place of a square root and divisions (within 2
// ulp of them); NaN on an indefinite H (a negative pivot).
__device__ void solve6(const float* Hu, const float* Jr, float* x) {
  float A[6][6], L[6][6], dinv[6];
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) {
      A[a][b] = Hu[k];
      A[b][a] = Hu[k];
      ++k;
    }
  for (int a = 0; a < 6; ++a) A[a][a] += 1e-8f;
  for (int j = 0; j < 6; ++j) {
    float s = A[j][j];
    for (int t = 0; t < j; ++t) s -= L[j][t] * L[j][t];
    dinv[j] = rsqrtf(s);  // NaN for a negative pivot, as sqrtf
    for (int i = j + 1; i < 6; ++i) {
      float s2 = A[i][j];
      for (int t = 0; t < j; ++t) s2 -= L[i][t] * L[j][t];
      L[i][j] = s2 * dinv[j];
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = Jr[i];
    for (int t = 0; t < i; ++t) s -= L[i][t] * y[t];
    y[i] = s * dinv[i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int t = i + 1; t < 6; ++t) s -= L[t][i] * x[t];
    x[i] = s * dinv[i];
  }
}

// T <- T * exp(-x), twist x = (v, w) (geometry/se3.SE3.exp).
__device__ void step_pose(const float* T, const float* x, float* Tn) {
  const float v[3] = {-x[0], -x[1], -x[2]};
  const float w0 = -x[3], w1 = -x[4], w2 = -x[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 > 0.f ? th2 : 0.f);
  const bool small = th2 < 1e-8f;
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float st = small ? 1.f - th2 / 6.f : sn / th;
  const float ct = small ? 0.5f - th2 / 24.f : (1.f - cs) / th2;
  const float vt = small ? 1.f / 6.f - th2 / 120.f : (th - sn) / (th2 * th);
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float W2[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      float s = 0.f;
      for (int c = 0; c < 3; ++c) s += W[a][c] * W[c][b];
      W2[a][b] = s;
    }
  float ER[3][3], V[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      const float e = a == b ? 1.f : 0.f;
      ER[a][b] = e + st * W[a][b] + ct * W2[a][b];
      V[a][b] = e + ct * W[a][b] + vt * W2[a][b];
    }
  float Et[3];
  for (int a = 0; a < 3; ++a)
    Et[a] = V[a][0] * v[0] + V[a][1] * v[1] + V[a][2] * v[2];
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b)
      Tn[3 * a + b] = T[3 * a] * ER[0][b] + T[3 * a + 1] * ER[1][b] +
                      T[3 * a + 2] * ER[2][b];
    Tn[9 + a] = T[3 * a] * Et[0] + T[3 * a + 1] * Et[1] +
                T[3 * a + 2] * Et[2] + T[9 + a];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
sparse_align_kernel(const float* __restrict__ ref_stack,
                    const float* __restrict__ cur_stack, int ws,
                    LevelTable tab, const float* __restrict__ px,
                    const float* __restrict__ fb,
                    const float* __restrict__ depth,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ R0, const float* __restrict__ t0,
                    Cam cam, int max_level, int min_level, int n_iter,
                    float eps, int n, float* __restrict__ out,
                    int* outi, StreamStrides ss) {
  // this block's stream
  const long long b = blockIdx.x;
  ref_stack += b * ss.ref;
  cur_stack += b * ss.cur;
  px += b * ss.px;
  fb += b * ss.f;
  depth += b * ss.depth;
  valid += b * ss.valid;
  R0 += b * ss.R;
  t0 += b * ss.t;
  out += b * kOutLen;
  outi += b * kOutLen;
  extern __shared__ float4 smem_raw[];
  Feats F;
  F.jac = reinterpret_cast<float*>(smem_raw);
  F.ref = F.jac + 6 * n * kJStride;
  F.hf = F.ref + n * kArea;
  F.pref = F.hf + n * kHTerms;
  F.px = F.pref + 3 * n;
  F.depth = F.px + 2 * n;
  F.valid = reinterpret_cast<int*>(F.depth + n);
  F.bxy = reinterpret_cast<float*>(F.valid + n);
  F.gofs = reinterpret_cast<int*>(F.bxy + 2 * n);
  F.ok = F.gofs + n;
  __shared__ float stage[kWarps][kStage];
  __shared__ float warp_part[kWarps][32];
  __shared__ float tot[32];
  __shared__ float T[12];
  __shared__ int done_flag;
  // thread 0's loop state
  float bT[12], Hc[21], bchi2 = INFINITY, nm = 0.f, chi2_out = 0.f;
  if (threadIdx.x < 9) T[threadIdx.x] = R0[threadIdx.x];
  if (threadIdx.x >= 9 && threadIdx.x < 12) T[threadIdx.x] = t0[threadIdx.x - 9];
  load_features(F, px, fb, depth, valid, n);
  // levels the launch does not run report 0 iterations
  if (threadIdx.x == 0)
    for (int l = 0; l < kMaxLevels; ++l)
      outi[kOutIters + l] = 0;
  __syncthreads();
  for (int level = max_level; level >= min_level; --level) {
    const float scale = ldexpf(1.f, -level);
    int W, H, off;
    level_dims(tab, level, W, H, off);
    precompute(F, stage, ref_stack, ws, W, H, off, scale, cam.fx * scale, n);
    __syncthreads();
    level_setup(F, T, cam, ws, W, H, off, scale, n);
    int iters = 0;
    if (threadIdx.x == 0) {
      done_flag = 0;
      bchi2 = INFINITY;
      for (int k = 0; k < 12; ++k) bT[k] = T[k];
      for (int k = 0; k < 21; ++k) Hc[k] = 0.f;
    }
    __syncthreads();
    for (int it = 0; it < n_iter; ++it) {
      evaluate(F, T, cur_stack, ws, cam, scale, n, warp_part, tot);
      if (threadIdx.x == 0) {
        const float nmi = tot[28] * 16.f;
        const float chi2 = tot[27] / (nmi > 1.f ? nmi : 1.f);
        float Jr[6], x[6];
        for (int a = 0; a < 6; ++a) Jr[a] = -tot[21 + a];
        solve6(tot, Jr, x);
        bool anynan = false;
        for (int k = 0; k < 6; ++k) anynan |= isnan_f(x[k]);
        const bool bad = anynan || chi2 > bchi2;
        const bool plateau = it > 0 && chi2 > bchi2 * (1.f - 1e-4f);
        float Tcur[12], Tn[12];
        for (int k = 0; k < 12; ++k) Tcur[k] = T[k];
        step_pose(Tcur, x, Tn);
        if (chi2 <= bchi2) {  // better (the loop only runs while not done)
          for (int k = 0; k < 12; ++k) bT[k] = Tcur[k];
          bchi2 = chi2;
        }
        const bool roll = bad && it > 0;
        for (int k = 0; k < 12; ++k) T[k] = roll ? bT[k] : Tn[k];
        for (int k = 0; k < 21; ++k) Hc[k] = tot[k];
        float mx = 0.f;
        for (int k = 0; k < 6; ++k) mx = fabsf(x[k]) > mx ? fabsf(x[k]) : mx;
        const bool converged = !anynan && mx < eps;
        done_flag = converged || plateau || roll;
      }
      ++iters;
      __syncthreads();
      if (done_flag) break;
    }
    // the final evaluation picks the better of the last and the best pose
    evaluate(F, T, cur_stack, ws, cam, scale, n, warp_part, tot);
    if (threadIdx.x == 0) {
      nm = tot[28] * 16.f;
      const float chi2f = tot[27] / (nm > 1.f ? nm : 1.f);
      if (!(chi2f <= bchi2))
        for (int k = 0; k < 12; ++k) T[k] = bT[k];
      chi2_out = nan_min(chi2f, bchi2);
      outi[kOutTracked] = static_cast<int>(tot[28]);
      outi[kOutIters + level] = iters;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < 12; ++k) out[k] = T[k];
    int k = 0;
    for (int a = 0; a < 6; ++a)
      for (int b = a; b < 6; ++b) {
        out[12 + a * 6 + b] = Hc[k];
        out[12 + b * 6 + a] = Hc[k];
        ++k;
      }
    out[48] = chi2_out;
    out[49] = nm;
  }
}

}  // namespace

// B streams in one launch, one block each: stream b reads its inputs at
// the strides of ss and writes the float slots of its output row to
// out[b * 64 .. + 64) and the int32 slots (tracked features, iterations
// per level) to the same offsets of outi[b * 64 .. + 64).
extern "C" int sparse_align_batched(
    const float* ref_stack, const float* cur_stack, int ws, LevelTable tab,
    const float* px, const float* f, const float* depth,
    const unsigned char* valid, const float* R0, const float* t0, Cam cam,
    int max_level, int min_level, int n_iter, float eps, int n, float* out,
    int* outi, StreamStrides ss, int nb, cudaStream_t stream) {
  // every feature's state lives in the block's shared memory; a count
  // that does not fit is refused here (the error is cleared, so later
  // launches do not report it)
  static int smem_set = 48 * 1024;
  const int smem = n * kSmemPerFeat * static_cast<int>(sizeof(float));
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_align_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    smem_set = smem;
  }
  if (nb > 0)
    sparse_align_kernel<<<nb, kThreads, smem, stream>>>(
        ref_stack, cur_stack, ws, tab, px, f, depth, valid, R0, t0, cam,
        max_level, min_level, n_iter, eps, n, out, outi, ss);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sparse_align(const float* ref_stack, const float* cur_stack,
                            int ws, LevelTable tab, const float* px,
                            const float* f, const float* depth,
                            const unsigned char* valid, const float* R0,
                            const float* t0, Cam cam, int max_level,
                            int min_level, int n_iter, float eps, int n,
                            float* out, cudaStream_t stream) {
  // one stream: the int32 slots share the float output row
  return sparse_align_batched(ref_stack, cur_stack, ws, tab, px, f, depth,
                              valid, R0, t0, cam, max_level, min_level,
                              n_iter, eps, n, out,
                              reinterpret_cast<int*>(out), StreamStrides{},
                              1, stream);
}
