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
//   * one CTA per (b, 16x16 tile), one thread per pixel, so the grid has
//     B * ceil(H/16) * ceil(W/16) CTAs and no cross-block reduction; the
//     pixels of a partial edge tile past H or W take part in the cull and
//     the staging but sweep and write nothing, so any H, W works;
//   * with culling, the CTA culls chunks itself, in ascending order: each
//     thread tests one face's bbox against the tile and __syncthreads_or
//     decides; this replaces the TPU path's (T, F/chunk) overlap tables and
//     argsort. Without culling (the brute-force mode) every chunk is swept;
//   * an overlapping chunk's face rows (chunk x 16 f32, 8 KB at chunk 128)
//     are staged in shared memory and read as broadcasts;
//   * each thread keeps a running (z, fid); with attributes, the winner's
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

constexpr int kTile = 16;
constexpr float kFar = 1e9f;

__device__ __forceinline__ float affine(float x, float y, float a, float b,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

template <bool kCull, bool kAttrs>
__global__ void raster_sweep_kernel(
    const float* __restrict__ face_data, const float4* __restrict__ bbox,
    const float* __restrict__ corner_attrs, float* __restrict__ z_out,
    int* __restrict__ fid_out, float* __restrict__ attr_out, int F, int H,
    int W, int D, int chunk, float min_depth) {
  extern __shared__ float s_face[];  // chunk * 16 floats

  const int b = blockIdx.z;
  const int tx0 = blockIdx.x * kTile;
  const int ty0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kTile;
  const int px = tx0 + threadIdx.x;
  const int py = ty0 + threadIdx.y;
  const bool in_image = px < W && py < H;
  const float x = __fadd_rn(static_cast<float>(px), 0.5f);
  const float y = __fadd_rn(static_cast<float>(py), 0.5f);

  // Inclusive extent of the tile's pixel centres inside the image, as the
  // TPU cull (which only ever sees full tiles).
  const float cx0 = static_cast<float>(tx0) + 0.5f;
  const float cy0 = static_cast<float>(ty0) + 0.5f;
  const float cx1 = static_cast<float>(min(tx0 + kTile, W) - 1) + 0.5f;
  const float cy1 = static_cast<float>(min(ty0 + kTile, H) - 1) + 0.5f;

  const float* fd_b = face_data + static_cast<size_t>(b) * F * 16;

  float best_z = kFar;
  int best_f = -1;
  const int num_chunks = F / chunk;
  for (int c = 0; c < num_chunks; ++c) {
    const int base = c * chunk;
    if (kCull) {
      const float4* bb = bbox + static_cast<size_t>(b) * F + base;
      int hit = 0;
      for (int i = tid; i < chunk; i += nthreads) {
        const float4 r = bb[i];
        hit |= (r.x <= cx1) & (r.z >= cx0) & (r.y <= cy1) & (r.w >= cy0);
      }
      if (!__syncthreads_or(hit)) continue;
    }

    const float* src = fd_b + static_cast<size_t>(base) * 16;
    for (int i = tid; i < chunk * 16; i += nthreads) s_face[i] = src[i];
    __syncthreads();

    if (in_image) {
      for (int j = 0; j < chunk; ++j) {
        const float* fd = s_face + j * 16;
        const float e0 = affine(x, y, fd[0], fd[1], fd[2]);
        const float e1 = affine(x, y, fd[3], fd[4], fd[5]);
        const float e2 = affine(x, y, fd[6], fd[7], fd[8]);
        const float depth = affine(x, y, fd[9], fd[10], fd[11]);
        const bool ok = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) &&
                        (depth > min_depth) && (fd[12] > 0.0f);
        const float zc = ok ? depth : kFar;
        if (zc < best_z) {
          best_z = zc;
          best_f = base + j;
        }
      }
    }
    __syncthreads();  // s_face is overwritten by the next staged chunk
  }
  if (!in_image) return;
  if (!(best_z < kFar)) best_f = -1;

  const size_t pix = (static_cast<size_t>(b) * H + py) * W + px;
  z_out[pix] = best_z;
  fid_out[pix] = best_f;
  if (!kAttrs) return;

  float* out = attr_out + pix * D;
  if (best_f < 0) {
    for (int d = 0; d < D; ++d) out[d] = 0.0f;
    return;
  }
  const float* fd = fd_b + static_cast<size_t>(best_f) * 16;
  const float w0 = affine(x, y, fd[0], fd[1], fd[2]);
  const float w1 = affine(x, y, fd[3], fd[4], fd[5]);
  const float w2 = affine(x, y, fd[6], fd[7], fd[8]);
  const float* ca =
      corner_attrs + (static_cast<size_t>(b) * F + best_f) * 3 * D;
  for (int d = 0; d < D; ++d) {
    out[d] = __fadd_rn(__fadd_rn(__fmul_rn(w0, ca[d]), __fmul_rn(w1, ca[D + d])),
                       __fmul_rn(w2, ca[2 * D + d]));
  }
}

// Launches one sweep on `stream`; returns cudaGetLastError() of the launch
// (0 = ok). F must be a multiple of `chunk`; the Python wrappers check
// shapes, dtypes, devices and contiguity before calling.
template <bool kCull, bool kAttrs>
int launch_raster_sweep(const void* face_data, const void* bbox,
                        const void* corner_attrs, void* z_out, void* fid_out,
                        void* attr_out, int B, int F, int H, int W, int D,
                        int chunk, float min_depth, void* stream) {
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  const dim3 block(kTile, kTile);
  const size_t smem = static_cast<size_t>(chunk) * 16 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_sweep_kernel<kCull, kAttrs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  raster_sweep_kernel<kCull, kAttrs>
      <<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(face_data),
          static_cast<const float4*>(bbox),
          static_cast<const float*>(corner_attrs), static_cast<float*>(z_out),
          static_cast<int*>(fid_out), static_cast<float*>(attr_out), F, H, W,
          D, chunk, min_depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
