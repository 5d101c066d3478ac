// One damped Gauss-Newton step of the refiner's LM pose solve, in one launch
// (`geometry/lm._lm_step` after `reprojection_optim`'s back-projection; the
// plain version is `ops/raster_kernels.lm_step_plain`).
//
// Replaces no TPU kernel: the JAX package leaves the LM step to XLA, which
// fuses it. Written in PyTorch ops it is a chain of about 357 kernels a step
// (back-projection, transform, projection and Jacobian, the f64 normal
// equations, the unrolled 6x6 Cholesky and the se(3) increment), 288 of them
// on 36 or 6 numbers an item, 12 steps a served request. What bounds it on
// the H100: the launch at B=1 on the 1/8 grid (900 pixels, 14 KB); at the
// parity preset's 240^2, B=8, the 7.4 MB it reads (depth, target, one weight
// channel: 2.2 us at 3.35 TB/s). The design: a grid over (pixel tile, item),
// each item's tiles one thread block cluster (at most 16 blocks, a size the
// H100 allows past the portable 8; the 1/8 grid's 900 pixels are 8 blocks:
// a thread's loop is bound by the latency of its loads, so more and shorter
// loops win even there); each thread computes its
// pixels' two Jacobian rows in f32 in `_lm_step`'s order (separately rounded
// ops, no FMA contraction) and adds them to the 21 upper entries of H and
// the 6 of b in f64 registers; each block reduces them (warp shuffles, then
// shared memory in warp order) into its shared memory; the cluster's first
// block reads the blocks' 27 sums through distributed shared memory in
// block order, then one thread damps, solves (`solve_spd`'s Cholesky-Crout
// in f64, its op order) and applies `se3_expm` by `geometry/se3`'s formulas.
// No state outlives a launch and no floating-point atomics: every launch
// gives the same bits, on any stream, and a graph replays it as it is.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;          // H's upper triangle, row by row, then b
constexpr float kProjMinDepth = 0.01f;  // `geometry/projective.MIN_DEPTH`
constexpr float kTaylorTheta2 = 1e-8f;  // `geometry/se3._TAYLOR_THETA2`
constexpr int kMaxItems = 65535;        // the grid's y limit: one item a row
constexpr int kMaxTiles = 16;           // the H100's largest cluster

// One weighted Jacobian row into the sums: H += (J w)^T J, b += (J w)^T r,
// with J w exact in f64 (`_lm_step`'s `Jw`).
__device__ __forceinline__ void add_row(double acc[kSums], const float J[6], float w, float r) {
  double jw[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) jw[k] = static_cast<double>(J[k]) * static_cast<double>(w);
  int n = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int l = k; l < 6; ++l, ++n) acc[n] = fma(jw[k], static_cast<double>(J[l]), acc[n]);
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) acc[21 + k] = fma(jw[k], static_cast<double>(r), acc[21 + k]);
}

// `geometry/se3._series`: k0 + p1 * f32(1/d1) + p2 * f32(1/d2), each product
// exact and each sum rounded in f64 then to f32 (`geometry/precise.fma`).
__device__ float series(float k0, float t2, float d1, float d2) {
  const float inner = __double2float_rn(__dadd_rn(
      static_cast<double>(k0),
      static_cast<double>(-t2) * static_cast<double>(__fdiv_rn(1.0f, d1))));
  return __double2float_rn(__dadd_rn(
      static_cast<double>(inner),
      static_cast<double>(__fmul_rn(t2, t2)) * static_cast<double>(__fdiv_rn(1.0f, d2))));
}

// The damped solve, the twist's exponential and T <- exp(delta) T for one
// item, on one thread. s: the item's 27 sums; T, T_out: (4, 4).
__device__ void finish(const double* s, const float* T, float* T_out, double lm_lambda,
                       double ep_lambda, double delta_clamp) {
  double H[6][6], b[6];
  int n = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int l = k; l < 6; ++l, ++n) H[k][l] = H[l][k] = s[n];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) b[k] = s[21 + k];
  // H + ep * I + (lm * diag(H)) * I, every entry as the plain version adds it.
  double diag[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) diag[k] = H[k][k];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int l = 0; l < 6; ++l) {
      const double eye = k == l ? 1.0 : 0.0;
      H[k][l] = __dadd_rn(__dadd_rn(H[k][l], __dmul_rn(ep_lambda, eye)),
                          __dmul_rn(__dmul_rn(lm_lambda, diag[k]), eye));
    }
  }
  // `solve_spd`: Jacobi scaling, Cholesky-Crout, both substitutions.
  double dinv[6], bs[6], L[6][6], y[6], x[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const double h = H[k][k] < 1e-12 ? 1e-12 : H[k][k];  // clamp(min): NaN stays
    dinv[k] = __ddiv_rn(1.0, __dsqrt_rn(h));
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) bs[k] = __dmul_rn(b[k], dinv[k]);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < j; ++k) acc = __dadd_rn(acc, __dmul_rn(L[j][k], L[j][k]));
    L[j][j] = __dsqrt_rn(__dsub_rn(__dmul_rn(__dmul_rn(H[j][j], dinv[j]), dinv[j]), acc));
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      double a = 0.0;
#pragma unroll
      for (int k = 0; k < j; ++k) a = __dadd_rn(a, __dmul_rn(L[i][k], L[j][k]));
      L[i][j] = __ddiv_rn(__dsub_rn(__dmul_rn(__dmul_rn(H[i][j], dinv[i]), dinv[j]), a),
                          L[j][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double a = 0.0;
#pragma unroll
    for (int k = 0; k < i; ++k) a = __dadd_rn(a, __dmul_rn(L[i][k], y[k]));
    y[i] = __ddiv_rn(__dsub_rn(bs[i], a), L[i][i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double a = 0.0;
#pragma unroll
    for (int k = i + 1; k < 6; ++k) a = __dadd_rn(a, __dmul_rn(L[k][i], x[k]));
    x[i] = __ddiv_rn(__dsub_rn(y[i], a), L[i][i]);
  }
  float delta[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    double v = __dmul_rn(x[k], dinv[k]);
    v = isfinite(v) ? v : 0.0;
    v = v < -delta_clamp ? -delta_clamp : (v > delta_clamp ? delta_clamp : v);
    delta[k] = __double2float_rn(v);
  }
  // `se3_expm`: R = I + A W + B W^2, t = (I + B W + C W^2) v.
  const float v0 = delta[0], v1 = delta[1], v2 = delta[2];
  const float w0 = delta[3], w1 = delta[4], w2 = delta[5];
  const float t2 = __fadd_rn(__fadd_rn(__fmul_rn(w0, w0), __fmul_rn(w1, w1)), __fmul_rn(w2, w2));
  float A, B, C;
  if (t2 < kTaylorTheta2) {
    A = series(1.0f, t2, 6.0f, 120.0f);
    B = series(0.5f, t2, 24.0f, 720.0f);
    C = series(static_cast<float>(1.0 / 6.0), t2, 120.0f, 5040.0f);
  } else {
    const float th = __fsqrt_rn(t2);
    const float sn = sinf(th);
    A = __fdiv_rn(sn, th);
    B = __fdiv_rn(__fsub_rn(1.0f, cosf(th)), t2);
    C = __fdiv_rn(__fsub_rn(th, sn), __fmul_rn(t2, th));
  }
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      W2[i][j] = __fadd_rn(__fadd_rn(__fmul_rn(W[i][0], W[0][j]), __fmul_rn(W[i][1], W[1][j])),
                           __fmul_rn(W[i][2], W[2][j]));
    }
  }
  float E[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = __fadd_rn(__fadd_rn(eye, __fmul_rn(A, W[i][j])), __fmul_rn(B, W2[i][j]));
      V[j] = __fadd_rn(__fadd_rn(eye, __fmul_rn(B, W[i][j])), __fmul_rn(C, W2[i][j]));
    }
    E[i][3] = __fadd_rn(__fadd_rn(__fmul_rn(V[0], v0), __fmul_rn(V[1], v1)), __fmul_rn(V[2], v2));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T_out[i * 4 + j] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(E[i][0], T[j]), __fmul_rn(E[i][1], T[4 + j])),
                    __fmul_rn(E[i][2], T[8 + j])),
          __fmul_rn(E[i][3], T[12 + j]));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) T_out[12 + j] = T[12 + j];  // exp(delta)'s row [0 0 0 1]
}

// Grid (tiles, B), launched as clusters of (tiles, 1, 1): one cluster an
// item. Two blocks an SM (at most 128 registers a thread): the finish, which
// runs once an item, may spill; the pixel loop's 27 f64 sums stay in
// registers.
__global__ void __launch_bounds__(kThreads, 2) lm_step_kernel(
    const float* __restrict__ T, const float* __restrict__ target,
    const float* __restrict__ weight, const float* __restrict__ depth,
    const float* __restrict__ K, float* __restrict__ T_out, int H, int W,
    int tile_pixels, long long tb, long long th,
    long long tw, long long tc, long long wb, long long wh, long long ww, long long wc,
    float min_depth, double lm_lambda, double ep_lambda, double delta_clamp) {
  cg::cluster_group cluster = cg::this_cluster();
  const int item = blockIdx.y;
  const int tiles = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int P = H * W;
  const float* Ti = T + item * 16;
  const float R00 = Ti[0], R01 = Ti[1], R02 = Ti[2], t0 = Ti[3];
  const float R10 = Ti[4], R11 = Ti[5], R12 = Ti[6], t1 = Ti[7];
  const float R20 = Ti[8], R21 = Ti[9], R22 = Ti[10], t2 = Ti[11];
  const float fx = K[item * 4], fy = K[item * 4 + 1], cx = K[item * 4 + 2], cy = K[item * 4 + 3];

  double acc[kSums];
#pragma unroll
  for (int n = 0; n < kSums; ++n) acc[n] = 0.0;
  const int begin = rank * tile_pixels;
  const int end = min(P, begin + tile_pixels);
  for (int p = begin + threadIdx.x; p < end; p += kThreads) {
    const int py = p / W, px = p - py * W;
    const float d = depth[static_cast<long long>(item) * P + p];
    // Back-projection (`projective.backproject`), then X1 = R X0 + t.
    const float x0 = __fmul_rn(__fdiv_rn(__fsub_rn(static_cast<float>(px), cx), fx), d);
    const float y0 = __fmul_rn(__fdiv_rn(__fsub_rn(static_cast<float>(py), cy), fy), d);
    const float X = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(x0, R00), __fmul_rn(y0, R01)), __fmul_rn(d, R02)), t0);
    const float Y = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(x0, R10), __fmul_rn(y0, R11)), __fmul_rn(d, R12)), t1);
    const float Z = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(x0, R20), __fmul_rn(y0, R21)), __fmul_rn(d, R22)), t2);
    // `projective.project` with its Jacobian: the clamp and the zeroed
    // inverse depth behind the camera.
    const float zc = Z < kProjMinDepth ? kProjMinDepth : Z;
    const float zinv = Z > kProjMinDepth ? __fdiv_rn(1.0f, zc) : 0.0f;
    const float u = __fadd_rn(__fmul_rn(__fmul_rn(fx, X), zinv), cx);
    const float v = __fadd_rn(__fmul_rn(__fmul_rn(fy, Y), zinv), cy);
    const float ju0 = __fmul_rn(fx, zinv);
    const float ju2 = __fmul_rn(__fmul_rn(__fmul_rn(-fx, X), zinv), zinv);
    const float jv1 = __fmul_rn(fy, zinv);
    const float jv2 = __fmul_rn(__fmul_rn(__fmul_rn(-fy, Y), zinv), zinv);
    // j_proj @ [I | -hat(X1)] (`projective.local_perturb_jacobian`).
    const float Ju[6] = {ju0, 0.0f, ju2, __fmul_rn(ju2, Y),
                         __fadd_rn(__fmul_rn(ju0, Z), __fmul_rn(ju2, -X)), __fmul_rn(ju0, -Y)};
    const float Jv[6] = {0.0f, jv1, jv2, __fadd_rn(__fmul_rn(jv1, -Z), __fmul_rn(jv2, Y)),
                         __fmul_rn(jv2, -X), __fmul_rn(jv1, X)};
    const long long to = item * tb + py * th + px * tw;
    const long long wo = item * wb + py * wh + px * ww;
    const float m = __fmul_rn(d > min_depth ? 1.0f : 0.0f, Z > min_depth ? 1.0f : 0.0f);
    add_row(acc, Ju, __fmul_rn(weight[wo], m), __fsub_rn(target[to], u));
    add_row(acc, Jv, __fmul_rn(weight[wo + wc], m), __fsub_rn(target[to + tc], v));
  }

  // The block's sums: warp shuffles, then the warps in order.
  __shared__ double warp_sums[kWarps][kSums];
  __shared__ double sums[kSums];    // this block's
  __shared__ double total[kSums];   // the item's, in the cluster's first block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < kSums; ++n) {
    double s = acc[n];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[warp][n] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    double s = warp_sums[0][threadIdx.x];
    for (int k = 1; k < kWarps; ++k) s += warp_sums[k][threadIdx.x];
    sums[threadIdx.x] = s;
  }
  cluster.sync();  // every block's sums are written
  if (rank == 0 && threadIdx.x < kSums) {
    double s = 0.0;
    for (int k = 0; k < tiles; ++k) s += cluster.map_shared_rank(sums, k)[threadIdx.x];
    total[threadIdx.x] = s;
  }
  cluster.sync();  // no block leaves while its sums are read
  if (rank == 0 && threadIdx.x == 0) {
    finish(total, Ti, T_out + item * 16, lm_lambda, ep_lambda, delta_clamp);
  }
}

}  // namespace

// One LM step on `stream` (capturable): T (B, 4, 4), depth (B, H, W) and
// K (B, 4) contiguous f32; target and weight (B, H, W, 2) f32 at the given
// element strides (a stride-0 channel is read as it is); T_out (B, 4, 4);
// 1 <= B <= 65535. `tiles` (1 to 16) blocks of `tile_pixels` pixels an item,
// tiles * tile_pixels >= H * W. Returns the launch's cudaError.
extern "C" int rnnpose_lm_step(const void* T, const void* target, const void* weight,
                               const void* depth, const void* K, void* T_out, int B, int H,
                               int W, int tiles, int tile_pixels, long long tb, long long th,
                               long long tw, long long tc, long long wb, long long wh,
                               long long ww, long long wc, float min_depth, double lm_lambda,
                               double ep_lambda, double delta_clamp, void* stream) {
  if (B < 1 || B > kMaxItems || H < 1 || W < 1 || tiles < 1 || tiles > kMaxTiles ||
      static_cast<long long>(tiles) * tile_pixels < static_cast<long long>(H) * W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles > 8) {  // past the portable cluster size, on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        lm_step_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, lm_step_kernel, static_cast<const float*>(T), static_cast<const float*>(target),
      static_cast<const float*>(weight), static_cast<const float*>(depth),
      static_cast<const float*>(K), static_cast<float*>(T_out), H, W, tile_pixels, tb, th, tw,
      tc, wb, wh, ww, wc, min_depth, lm_lambda, ep_lambda, delta_clamp);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
