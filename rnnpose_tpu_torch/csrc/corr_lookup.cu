// The windowed correlation lookups, all pyramid levels in one launch each:
// the 2D lookup of the refiner's flow step and of RAFT (`corr_lookup`), and
// the 1D lookup along image rows of RAFT-Stereo (`corr_lookup_1d`), where no
// gradient is needed (`ops/corr`; the plain versions are
// `kernels/corr.corr_lookup_plain` and `corr_lookup_1d_plain`).
//
// Replaces no TPU kernel: the JAX package leaves the lookup to XLA, which
// fuses it. Written in PyTorch ops it is a chain of 257 kernels a lookup (per
// level the two axes' taps, four gathers with their int64 index casts and
// the weighted sums; then a `cat`), 12 lookups a served RNNPose request and
// 32 a RAFT pair. What bounds it on the H100: at RAFT's 7,040 positions the
// bytes, the 9.1 MB it writes and the 32-byte sectors of each query's four
// (2r+2)^2 windows (about 18 MB): 6-8 us at 3.35 TB/s; at the refiner's 900
// positions (1.2 MB written) the launch itself. The design: one thread per
// output value, in the output's order (level-major, then dx, dy fastest), so
// a warp stores 32 neighbouring floats and a query's L (2r+1)^2 values leave
// as one coalesced row; each thread computes its y and x taps as the chain
// does (f32 ops rounded one by one, no FMA contraction: `c * 2^-i + d`, its
// floor, the weights times their validity), reads its four values through
// the read-only cache (a warp's reads fall in one ~10 x 5 patch of one
// query's level row, which L1 serves to its neighbours), and sums them in
// the chain's order. An out-of-range tap reads index 0 along its axis with
// weight 0, as the chain does: no read leaves the query's row, and a
// non-finite coordinate or value gives NaN where the chain gives NaN. A level
// pooled to zero size writes zeros. No scratch, no atomics and no state
// between launches: every launch gives the same bits, on any stream, and a
// graph replays it as it is.
//
// The 1D lookup is the same design along one axis. RAFT-Stereo's volume holds,
// for each query (a position of the 1/4 grid), its image row's correlations,
// pooled by two along the row per level: levels of (2r+2) contiguous values
// read and 2r+1 written per query and level. As a chain it is about 60 kernels
// a lookup, 32 lookups a pair, each over about 13 MB at Middlebury's 504 x 720
// grid. What bounds it: the bytes, the 52 MB it writes (362,880 queries x 4
// levels x 9 taps) and the (2r+2) values of each query's row per level (58 MB):
// about 33 us at 3.35 TB/s. One thread per output value, in the output's order
// (level-major, dx fastest), its two taps from `c * 2^-i + d` as the chain
// computes them; a query's level row is one contiguous stretch, which L1
// serves to the nine threads that read it. Offsets are 64-bit: a level holds
// queries x width values, past 2^31 at larger frames or batches.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;

struct Levels {
  const void* data[kMaxLevels];  // level l: (Q, h[l], w[l]), one row a query
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// A level's element as f32: a bf16 is the high half of its f32.
__device__ __forceinline__ float value(const float* row, int i) { return __ldg(row + i); }
__device__ __forceinline__ float value(const unsigned short* row, int i) {
  return __uint_as_float(static_cast<unsigned>(__ldg(row + i)) << 16);
}

// The two bilinear taps of window position center + d along an axis of
// `size` (`_taps`): each index (0 where it is out of range) and its weight
// times its validity.
struct Taps {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Taps taps(float center, float d, int size) {
  const float pos = __fadd_rn(center, d);
  const float f0 = floorf(pos);
  const float w1 = __fsub_rn(pos, f0);
  const float w0 = __fsub_rn(1.0f, w1);
  const float f1 = __fadd_rn(f0, 1.0f);
  const float top = static_cast<float>(size - 1);
  const bool v0 = f0 >= 0.0f && f0 <= top;
  const bool v1 = f1 >= 0.0f && f1 <= top;
  return {v0 ? static_cast<int>(f0) : 0, v1 ? static_cast<int>(f1) : 0,
          __fmul_rn(w0, v0 ? 1.0f : 0.0f), __fmul_rn(w1, v1 ? 1.0f : 0.0f)};
}

// Thread t writes out[t]: query q = t / (levels * win^2), then its level,
// dx and dy. coords (B, H, W, 2) by strides; out (B * H * W, levels * win^2).
template <typename T>
__global__ void __launch_bounds__(kThreads) corr_lookup_kernel(
    Levels lv, int levels, const float* __restrict__ coords, int H, int W, long long sb,
    long long sh, long long sw, long long sc, int radius, int total, float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int win = 2 * radius + 1;
  const int area = win * win;
  const int q = t / (levels * area);
  const int k = t - q * levels * area;
  const int lvl = k / area;
  const int dx = (k - lvl * area) / win;
  const int dy = k - lvl * area - dx * win;
  const T* base = nullptr;
  int h = 0, w = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {  // selects, so the struct stays in registers
    if (l == lvl) {
      base = static_cast<const T*>(lv.data[l]);
      h = lv.h[l];
      w = lv.w[l];
    }
  }
  if (h == 0 || w == 0) {  // a level pooled away: every tap reads 0
    out[t] = 0.0f;
    return;
  }
  const int b = q / (H * W);
  const int y = (q - b * H * W) / W;
  const int x = q - b * H * W - y * W;
  const float* c = coords + b * sb + y * sh + x * sw;
  const float scale = scalbnf(1.0f, -lvl);  // 2^-lvl, exact
  const Taps ty = taps(__fmul_rn(__ldg(c + sc), scale), static_cast<float>(dy - radius), h);
  const Taps tx = taps(__fmul_rn(__ldg(c), scale), static_cast<float>(dx - radius), w);
  const T* row = base + static_cast<long long>(q) * h * w;
  const float col0 = __fadd_rn(__fadd_rn(0.0f, __fmul_rn(ty.w0, value(row, ty.i0 * w + tx.i0))),
                               __fmul_rn(ty.w1, value(row, ty.i1 * w + tx.i0)));
  const float col1 = __fadd_rn(__fadd_rn(0.0f, __fmul_rn(ty.w0, value(row, ty.i0 * w + tx.i1))),
                               __fmul_rn(ty.w1, value(row, ty.i1 * w + tx.i1)));
  out[t] = __fadd_rn(__fadd_rn(0.0f, __fmul_rn(tx.w0, col0)), __fmul_rn(tx.w1, col1));
}

// Thread t writes out[t]: query q = t / (levels * win), then its level and
// dx. coords (B, H, W, 2) by strides, x at element 0; level l is (Q, w[l]),
// one row a query; out (Q, levels * win). 64-bit offsets throughout.
template <typename T>
__global__ void __launch_bounds__(kThreads) corr_lookup_1d_kernel(
    Levels lv, int levels, const float* __restrict__ coords, int H, int W, long long sb,
    long long sh, long long sw, int radius, long long total, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int win = 2 * radius + 1;
  const long long q = t / (levels * win);
  const int k = static_cast<int>(t - q * levels * win);
  const int lvl = k / win;
  const int dx = k - lvl * win;
  const T* base = nullptr;
  int w = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {  // selects, so the struct stays in registers
    if (l == lvl) {
      base = static_cast<const T*>(lv.data[l]);
      w = lv.w[l];
    }
  }
  if (w == 0) {  // a level pooled away: every tap reads 0
    out[t] = 0.0f;
    return;
  }
  const long long hw = static_cast<long long>(H) * W;
  const long long b = q / hw;
  const long long y = (q - b * hw) / W;
  const long long x = q - b * hw - y * W;
  const float* c = coords + b * sb + y * sh + x * sw;
  const float scale = scalbnf(1.0f, -lvl);  // 2^-lvl, exact
  const Taps tx = taps(__fmul_rn(__ldg(c), scale), static_cast<float>(dx - radius), w);
  const T* row = base + q * w;
  out[t] = __fadd_rn(__fmul_rn(tx.w0, value(row, tx.i0)), __fmul_rn(tx.w1, value(row, tx.i1)));
}

}  // namespace

// data, hs, ws: host arrays of the `levels` levels' device pointers (each
// contiguous (B * H * W, h, w), f32, or bf16 where `bf16`) and sizes; coords
// f32 (B, H, W, 2) by its element strides; out f32 (B * H * W, levels *
// (2 radius + 1)^2), contiguous. Returns the launch's cudaError.
extern "C" int rnnpose_corr_lookup(const void* const* data, const int* hs, const int* ws,
                                   int levels, int bf16, const void* coords, int B, int H, int W,
                                   long long sb, long long sh, long long sw, long long sc,
                                   int radius, void* out, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || B < 1 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long win = 2LL * radius + 1;
  const long long total = static_cast<long long>(B) * H * W * levels * win * win;
  if (total > INT_MAX - kThreads) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.data[l] = data[l];
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
  }
  const int blocks = static_cast<int>((total + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const float*>(coords);
  const auto o = static_cast<float*>(out);
  if (bf16) {
    corr_lookup_kernel<unsigned short><<<blocks, kThreads, 0, s>>>(
        lv, levels, c, H, W, sb, sh, sw, sc, radius, static_cast<int>(total), o);
  } else {
    corr_lookup_kernel<float><<<blocks, kThreads, 0, s>>>(
        lv, levels, c, H, W, sb, sh, sw, sc, radius, static_cast<int>(total), o);
  }
  return static_cast<int>(cudaGetLastError());
}

// data, ws: host arrays of the `levels` levels' device pointers (each
// contiguous (B * H * W, w), f32, or bf16 where `bf16`) and widths; coords f32
// (B, H, W, 2) by its element strides, x read; out f32 (B * H * W, levels *
// (2 radius + 1)), contiguous. Returns the launch's cudaError.
extern "C" int rnnpose_corr_lookup_1d(const void* const* data, const int* ws, int levels,
                                      int bf16, const void* coords, int B, int H, int W,
                                      long long sb, long long sh, long long sw, int radius,
                                      void* out, void* stream) {
  if (levels < 1 || levels > kMaxLevels || radius < 0 || B < 1 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(B) * H * W * levels * (2LL * radius + 1);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int l = 0; l < levels; ++l) {
    lv.data[l] = data[l];
    lv.h[l] = 1;
    lv.w[l] = ws[l];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<const float*>(coords);
  const auto o = static_cast<float*>(out);
  if (bf16) {
    corr_lookup_1d_kernel<unsigned short><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        lv, levels, c, H, W, sb, sh, sw, radius, total, o);
  } else {
    corr_lookup_1d_kernel<float><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        lv, levels, c, H, W, sb, sh, sw, radius, total, o);
  }
  return static_cast<int>(cudaGetLastError());
}
