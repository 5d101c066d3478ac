// The tile-culled z-buffer sweep shared by every raster kernel of the port.
//
// Contract (that of the Pallas kernels in rnnpose_tpu/ops/pallas_raster.py):
//   face_data    (B, F, 16) f32 rows [9 area-normalised edge coefs |
//                3 depth coefs | valid | pad x3];
//   bbox         (B, F, 4) f32 [x0, y0, x1, y1], empty for invalid faces
//                (read only when culling);
//   corner_attrs (B, F, 3, D) f32 (read only with attributes);
//   -> z (B, H, W) f32 (1e9 where empty), fid (B, H, W) i32 (-1 where
//      empty) and, with attributes, attrs (B, H, W, D) f32 (0 where empty).
// Pixels are sampled at their centres (+0.5). A pixel is covered when all
// three edge values are >= 0, depth > min_depth and the face is valid. The
// nearest depth wins; on a tie the lowest face index wins (a strict `<`
// over faces in ascending order, which equals the TPU kernels' first-min
// inside a chunk plus strict `<` across ascending chunks).
//
// What bounds it on the H100: at the main path's shapes (B<=8, F<=4096,
// 240^2) the inputs are ~0.3 MB per batch item and the outputs a few MB, so
// neither HBM bandwidth nor FLOPs are the limit; the cost is the per-pixel
// sweep over face chunks (FP32 FMA-free arithmetic, about 20 flops per
// pixel/face pair) and, when culling, the per-chunk cull test. The design:
//   * one CTA of 256 threads per (b, tile x tile pixel tile), so the grid has
//     B * ceil(H/tile) * ceil(W/tile) CTAs and no cross-block reduction.
//     The tile is a runtime argument (16 on the main path; 24-52 when
//     RNNPOSE_RASTER_TILE picks one); each thread owns kPix =
//     ceil(tile^2 / 256) pixels in a register array (pixel p = tid + i*256,
//     row-major in the tile), kPix a template parameter chosen from the tile
//     on the host (1 at 16, 3 at 24, 4 at 32, 7 at 40, 11 at 52, at most
//     kMaxPix). Pixels past the tile or past H or W (a partial edge tile)
//     take part in the cull vote and the staging but sweep and write
//     nothing, so any H, W works;
//   * with culling, the CTA culls chunks itself, in ascending order: each
//     thread tests one face's bbox against the tile and __syncthreads_or
//     decides; this replaces the TPU path's (T, F/chunk) overlap tables and
//     argsort. Without culling (the brute-force mode) every chunk is swept;
//   * an overlapping chunk's face rows (chunk x 16 f32, 8 KB at chunk 128)
//     are staged in shared memory and read as broadcasts, once per face for
//     all kPix pixels of a thread;
//   * each pixel keeps a running (z, fid); with attributes, the winner's
//     edge coefficients and corner attributes are then read with a direct
//     indexed load (the TPU kernel's one-hot matmul recovery was a
//     workaround for gathers).
// Edge, depth and attribute values are computed as `x*a + y*b + c` with
// explicit round-to-nearest multiplies and adds (no FMA contraction), the
// same rounding as the elementwise PyTorch version, so face ids agree
// exactly at edge ties.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPix = 11;  // tile <= 53
constexpr float kFar = 1e9f;

__device__ __forceinline__ float affine(float x, float y, float a, float b,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

template <bool kCull, bool kAttrs, int kPix>
__global__ void __launch_bounds__(kThreads) raster_sweep_kernel(
    const float* __restrict__ face_data, const float4* __restrict__ bbox,
    const float* __restrict__ corner_attrs, float* __restrict__ z_out,
    int* __restrict__ fid_out, float* __restrict__ attr_out, int F, int H,
    int W, int D, int chunk, int tile, float min_depth) {
  extern __shared__ float s_face[];  // chunk * 16 floats

  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * tile;
  const int ty0 = blockIdx.y * tile;
  const int tid = threadIdx.x;

  int px[kPix], py[kPix];
  float x[kPix], y[kPix], best_z[kPix];
  int best_f[kPix];
  bool active[kPix];
  bool any_active = false;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = tid + i * kThreads;
    px[i] = tx0 + p % tile;
    py[i] = ty0 + p / tile;
    active[i] = p < tile * tile && px[i] < W && py[i] < H;
    any_active |= active[i];
    x[i] = __fadd_rn(static_cast<float>(px[i]), 0.5f);
    y[i] = __fadd_rn(static_cast<float>(py[i]), 0.5f);
    best_z[i] = kFar;
    best_f[i] = -1;
  }

  // Inclusive extent of the tile's pixel centres inside the image, as the
  // TPU cull (which only ever sees full tiles: tx0 + tile - 1).
  const float cx0 = static_cast<float>(tx0) + 0.5f;
  const float cy0 = static_cast<float>(ty0) + 0.5f;
  const float cx1 = static_cast<float>(min(tx0 + tile, W) - 1) + 0.5f;
  const float cy1 = static_cast<float>(min(ty0 + tile, H) - 1) + 0.5f;

  const float* fd_b = face_data + static_cast<size_t>(b) * F * 16;

  const int num_chunks = F / chunk;
  for (int c = 0; c < num_chunks; ++c) {
    const int base = c * chunk;
    if (kCull) {
      const float4* bb = bbox + static_cast<size_t>(b) * F + base;
      int hit = 0;
      for (int i = tid; i < chunk; i += kThreads) {
        const float4 r = bb[i];
        hit |= (r.x <= cx1) & (r.z >= cx0) & (r.y <= cy1) & (r.w >= cy0);
      }
      if (!__syncthreads_or(hit)) continue;
    }

    const float* src = fd_b + static_cast<size_t>(base) * 16;
    for (int i = tid; i < chunk * 16; i += kThreads) s_face[i] = src[i];
    __syncthreads();

    if (any_active) {
      for (int j = 0; j < chunk; ++j) {
        const float* fd = s_face + j * 16;
        const float a0 = fd[0], b0 = fd[1], c0 = fd[2];
        const float a1 = fd[3], b1 = fd[4], c1 = fd[5];
        const float a2 = fd[6], b2 = fd[7], c2 = fd[8];
        const float az = fd[9], bz = fd[10], cz = fd[11];
        const bool face_ok = fd[12] > 0.0f;
#pragma unroll
        for (int i = 0; i < kPix; ++i) {
          if (!active[i]) continue;
          const float e0 = affine(x[i], y[i], a0, b0, c0);
          const float e1 = affine(x[i], y[i], a1, b1, c1);
          const float e2 = affine(x[i], y[i], a2, b2, c2);
          const float depth = affine(x[i], y[i], az, bz, cz);
          const bool ok = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) &&
                          (depth > min_depth) && face_ok;
          const float zc = ok ? depth : kFar;
          if (zc < best_z[i]) {
            best_z[i] = zc;
            best_f[i] = base + j;
          }
        }
      }
    }
    __syncthreads();  // s_face is overwritten by the next staged chunk
  }

#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    if (!active[i]) continue;
    const int f = best_z[i] < kFar ? best_f[i] : -1;
    const size_t pix = (static_cast<size_t>(b) * H + py[i]) * W + px[i];
    z_out[pix] = best_z[i];
    fid_out[pix] = f;
    if (!kAttrs) continue;

    float* out = attr_out + pix * D;
    if (f < 0) {
      for (int d = 0; d < D; ++d) out[d] = 0.0f;
      continue;
    }
    const float* fd = fd_b + static_cast<size_t>(f) * 16;
    const float w0 = affine(x[i], y[i], fd[0], fd[1], fd[2]);
    const float w1 = affine(x[i], y[i], fd[3], fd[4], fd[5]);
    const float w2 = affine(x[i], y[i], fd[6], fd[7], fd[8]);
    const float* ca = corner_attrs + (static_cast<size_t>(b) * F + f) * 3 * D;
    for (int d = 0; d < D; ++d) {
      out[d] = __fadd_rn(
          __fadd_rn(__fmul_rn(w0, ca[d]), __fmul_rn(w1, ca[D + d])),
          __fmul_rn(w2, ca[2 * D + d]));
    }
  }
}

// One launch of the kPix instance on `stream`; returns cudaGetLastError()
// of the launch (0 = ok).
template <bool kCull, bool kAttrs, int kPix>
int launch_instance(const void* face_data, const void* bbox,
                    const void* corner_attrs, void* z_out, void* fid_out,
                    void* attr_out, int B, int F, int H, int W, int D,
                    int chunk, int tile, float min_depth, void* stream) {
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, B);
  const size_t smem = static_cast<size_t>(chunk) * 16 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_sweep_kernel<kCull, kAttrs, kPix>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  raster_sweep_kernel<kCull, kAttrs, kPix>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(face_data),
          static_cast<const float4*>(bbox),
          static_cast<const float*>(corner_attrs), static_cast<float*>(z_out),
          static_cast<int*>(fid_out), static_cast<float*>(attr_out), F, H, W,
          D, chunk, tile, min_depth);
  return static_cast<int>(cudaGetLastError());
}

// Launches one sweep at pixel tile `tile` (1 <= ceil(tile^2 / 256) <=
// kMaxPix, else cudaErrorInvalidValue). F must be a multiple of `chunk`; the
// Python wrappers check tiles, shapes, dtypes, devices and contiguity
// before calling.
template <bool kCull, bool kAttrs>
int launch_raster_sweep(const void* face_data, const void* bbox,
                        const void* corner_attrs, void* z_out, void* fid_out,
                        void* attr_out, int B, int F, int H, int W, int D,
                        int chunk, int tile, float min_depth, void* stream) {
#define RNNPOSE_SWEEP_CASE(P)                                                \
  case P:                                                                    \
    return launch_instance<kCull, kAttrs, P>(face_data, bbox, corner_attrs,  \
                                             z_out, fid_out, attr_out, B, F, \
                                             H, W, D, chunk, tile,           \
                                             min_depth, stream);
  if (tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch ((tile * tile + kThreads - 1) / kThreads) {
    RNNPOSE_SWEEP_CASE(1)
    RNNPOSE_SWEEP_CASE(2)
    RNNPOSE_SWEEP_CASE(3)
    RNNPOSE_SWEEP_CASE(4)
    RNNPOSE_SWEEP_CASE(5)
    RNNPOSE_SWEEP_CASE(6)
    RNNPOSE_SWEEP_CASE(7)
    RNNPOSE_SWEEP_CASE(8)
    RNNPOSE_SWEEP_CASE(9)
    RNNPOSE_SWEEP_CASE(10)
    RNNPOSE_SWEEP_CASE(11)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RNNPOSE_SWEEP_CASE
}

}  // namespace
