// Z-buffer sweeps, z and face id only, batched: culled and brute force.
//
// Replaces two Pallas TPU kernels of rnnpose_tpu/ops/pallas_raster.py:
//   * `zbuffer_sweep_tiled` (kernel body `_tiled_kernel`): the culled sweep
//     of `rasterize` (parity preset, backface culling), 3 launches per
//     request there. The TPU version builds (T, F/chunk) culling tables in
//     XLA and runs one mesh per call; here one launch culls per face and
//     covers the batch (raster_sweep.cuh). Its bound on the H100: face_data
//     and bbox read once (0.33 MB per batch item at F=4096), z and fid
//     written once (0.46 MB at 240^2): 0.79 MB at B=1 and 6.31 MB at B=8,
//     0.24 us and 1.9 us at 3.35 TB/s;
//   * `zbuffer_sweep` (kernel body `_kernel`): the brute-force contract,
//     face_data alone with no bbox, reached only from
//     `rasterize(use_pallas=True)`, the regression reference. Its bound is
//     the same function's: 0.72 MB at B=1, 0.22 us. Testing every pixel
//     against every face (236 M tests an image at 240^2, F=4096) is ~1700x
//     that bound, while the z-buffer needs only the pixels near each face.
//     So two launches: `reach_kernel`, a thread per face, derives from the
//     face's own coefficients a box that holds every pixel centre the f32
//     test can cover (`face_reach`, argument below) into a (B, F, 4) scratch
//     that the wrapper allocates; then the culled sweep runs on it. Its
//     (z, face) minimum equals the brute-force ascending strict `<`, so the
//     output is the plain brute-force sweep's, bit for bit.
// Any H and W: the pixels of partial edge blocks are masked (the TPU
// kernels' tile-multiple sizes were a TPU tiling limit).

#include "raster_sweep.cuh"

namespace {

constexpr int kReachThreads = 128;

// Why the reach holds every covered pixel centre p = (x, y), 0 < x < W,
// 0 < y < H. Edge k's f32 value is fl(fl(fl(x a) + fl(y b)) + c) (no FMA).
// If M = |a| W + |b| H + |c| < 2^126 nothing overflows, and it differs
// from the exact E(p) = a x + b y + c by at most 3.01 u M + 2^-123
// (u = 2^-24, subnormals included), so e >= 0 implies g(p) = E(p) + eps
// >= 0 with eps = 2^-22 M + 2^-100: the covered centres lie in
// T = {g_0, g_1, g_2 >= 0}. A bound of T in direction d comes from any
// lambda_i, lambda_j >= 0 (edges i, j): lambda_i g_i(p) + lambda_j g_j(p)
// >= 0 reads d.p <= S + r.p, where S = lambda_i c'_i + lambda_j c'_j
// (c' = c + eps) and r = lambda_i n_i + lambda_j n_j + d (n = (a, b)) is
// the residual. Solving r = 0 for the pair in f64 (a_i b_j and a_j b_i are
// exact in f64; det, 1/det and lambda take 3 roundings), the residual's
// reach over the raster and the rounding of S stay below 3.01 u64
// (|lambda_i| m_i + |lambda_j| m_j), m = |a| W + |b| H + |c'|: the slack
// 2^-50 (that sum + |S|) + 2^-40 covers them and its own rounding. A
// certificate holds whether or not T is bounded, for any lambda that came
// out >= 0 (lambda <= 0 bounds -d instead), so a side without one is the
// raster's, and an ill-conditioned sliver gets a looser side, never a
// wrong one. Sides clamp to [-1, W + 1] x [-1, H + 1] and round outward to
// f32. NaN among the 12 coefficients, or valid <= 0 or NaN, covers nothing
// (every comparison with NaN is false): empty box; so do sides that cross.
// M >= 2^126 or not finite: the whole raster. Depth is not used: the box
// is a superset, the sweep tests exactly. ops/raster_kernels
// .brute_reach_bbox_plain is the same f64 operations in the same order, so
// the two agree bit for bit.
__device__ float4 face_reach(const float* v, int H, int W) {
  const float4 empty = make_float4(kFar, kFar, -kFar, -kFar);
  bool blank = !(v[12] > 0.0f);
  for (int k = 0; k < 12; ++k) blank |= isnan(v[k]);
  if (blank) return empty;
  const double Wd = static_cast<double>(W), Hd = static_cast<double>(H);
  double a[3], b[3], cp[3], m[3];
  for (int k = 0; k < 3; ++k) {
    a[k] = v[3 * k];
    b[k] = v[3 * k + 1];
    const double c = v[3 * k + 2];
    const double t = __dadd_rn(__dmul_rn(fabs(a[k]), Wd), __dmul_rn(fabs(b[k]), Hd));
    const double M = __dadd_rn(t, fabs(c));
    if (!(M < 0x1p126)) {
      return make_float4(-1.0f, -1.0f, static_cast<float>(W + 1), static_cast<float>(H + 1));
    }
    cp[k] = __dadd_rn(c, __dadd_rn(__dmul_rn(M, 0x1p-22), 0x1p-100));
    m[k] = __dadd_rn(t, fabs(cp[k]));
  }
  double lo[2] = {-INFINITY, -INFINITY}, hi[2] = {INFINITY, INFINITY};  // x, y
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3;
    const double det = __dsub_rn(__dmul_rn(a[i], b[j]), __dmul_rn(a[j], b[i]));
    if (det == 0.0) continue;
    const double r = __ddiv_rn(1.0, det);
    // lambda for +x and for +y: lambda_i n_i + lambda_j n_j = -d.
    const double lam[2][2] = {{__dmul_rn(-b[j], r), __dmul_rn(b[i], r)},
                              {__dmul_rn(a[j], r), __dmul_rn(-a[i], r)}};
    for (int axis = 0; axis < 2; ++axis) {
      const double li = lam[axis][0], lj = lam[axis][1];
      const double s = __dadd_rn(__dmul_rn(li, cp[i]), __dmul_rn(lj, cp[j]));
      const double slack = __dadd_rn(
          __dmul_rn(__dadd_rn(__dadd_rn(__dmul_rn(fabs(li), m[i]), __dmul_rn(fabs(lj), m[j])),
                              fabs(s)),
                    0x1p-50),
          0x1p-40);
      if (li >= 0.0 && lj >= 0.0) {
        const double up = __dadd_rn(s, slack);
        hi[axis] = up < hi[axis] ? up : hi[axis];
      } else if (li <= 0.0 && lj <= 0.0) {
        const double down = __dsub_rn(s, slack);
        lo[axis] = down > lo[axis] ? down : lo[axis];
      }
    }
  }
  const double x0 = lo[0] > -1.0 ? lo[0] : -1.0, x1 = hi[0] < Wd + 1.0 ? hi[0] : Wd + 1.0;
  const double y0 = lo[1] > -1.0 ? lo[1] : -1.0, y1 = hi[1] < Hd + 1.0 ? hi[1] : Hd + 1.0;
  if (x0 > x1 || y0 > y1) return empty;
  return make_float4(__double2float_rd(x0), __double2float_rd(y0), __double2float_ru(x1),
                     __double2float_ru(y1));
}

// A thread per (b, f): row i of face_data -> reach[i].
__global__ void __launch_bounds__(kReachThreads) reach_kernel(
    const float4* __restrict__ face_data, float4* __restrict__ reach, int n, int H, int W) {
  const int i = blockIdx.x * kReachThreads + threadIdx.x;
  if (i >= n) return;
  const float4* row = face_data + static_cast<size_t>(i) * 4;
  const float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
  const float v[13] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w,
                       q2.x, q2.y, q2.z, q2.w, q3.x};
  reach[i] = face_reach(v, H, W);
}

int launch_reach(const void* face_data, void* reach, int B, int F, int H, int W, void* stream) {
  if (B < 1 || F < 1 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n = B * F;
  reach_kernel<<<(n + kReachThreads - 1) / kReachThreads, kReachThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(face_data), static_cast<float4*>(reach), n, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The culled sweep: `split` CTAs per 32 x 32 pixel block.
extern "C" int rnnpose_raster_tiled(const void* face_data, const void* bbox,
                                    void* z_out, void* fid_out, int B, int F,
                                    int H, int W, int split, float min_depth,
                                    void* stream) {
  return launch_culled_sweep<false>(face_data, bbox, nullptr, z_out, fid_out,
                                    nullptr, B, F, H, W, 0, split, min_depth,
                                    stream);
}

// The reach pass alone: face_data (B, F, 16) -> reach (B, F, 4).
extern "C" int rnnpose_raster_reach(const void* face_data, void* reach, int B, int F, int H,
                                    int W, void* stream) {
  return launch_reach(face_data, reach, B, F, H, W, stream);
}

// The brute-force contract: the reach pass into the wrapper's scratch
// `reach` (B, F, 4), then the culled sweep on it, `split` CTAs per block.
// `chunk` is the contract's (the wrapper checks that it divides F); the
// sweep does not depend on it.
extern "C" int rnnpose_raster_brute(const void* face_data, void* reach, void* z_out,
                                    void* fid_out, int B, int F, int H, int W, int chunk,
                                    int split, float min_depth, void* stream) {
  (void)chunk;
  const int err = launch_reach(face_data, reach, B, F, H, W, stream);
  if (err != 0) return err;
  return launch_culled_sweep<false>(face_data, reach, nullptr, z_out, fid_out, nullptr, B, F,
                                    H, W, 0, split, min_depth, stream);
}
