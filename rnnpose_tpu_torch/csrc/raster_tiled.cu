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
//   * `zbuffer_sweep` (kernel body `_kernel`): brute force, every pixel
//     against every face, reached only from `rasterize(use_pallas=True)`,
//     the regression reference. Its bound is the same function's: 0.72 MB
//     at B=1 (no bbox), 0.22 us. It keeps the chunked sweep of the first
//     port: one CTA of 256 threads per 16 x 16 pixels, one pixel a thread,
//     every chunk of face rows staged in shared memory and read as
//     broadcasts; far from its bound by design (every pixel-face pair).
// Any H and W: the pixels of partial edge blocks are masked (the TPU
// kernels' tile-multiple sizes were a TPU tiling limit).

#include "raster_sweep.cuh"

namespace {

constexpr int kBruteTile = 16;
constexpr int kBruteThreads = kBruteTile * kBruteTile;  // a pixel a thread

__global__ void __launch_bounds__(kBruteThreads) brute_sweep_kernel(
    const float* __restrict__ face_data, float* __restrict__ z_out,
    int* __restrict__ fid_out, int F, int H, int W, int chunk,
    float min_depth) {
  extern __shared__ float s_chunk[];  // chunk * 16 floats

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int px = blockIdx.x * kBruteTile + tid % kBruteTile;
  const int py = blockIdx.y * kBruteTile + tid / kBruteTile;
  const bool active = px < W && py < H;
  const float x = __fadd_rn(static_cast<float>(px), 0.5f);
  const float y = __fadd_rn(static_cast<float>(py), 0.5f);
  float best_z = kFar;
  int best_f = -1;
  const float* fd_b = face_data + static_cast<size_t>(b) * F * 16;

  for (int base = 0; base < F; base += chunk) {
    const float* src = fd_b + static_cast<size_t>(base) * 16;
    for (int i = tid; i < chunk * 16; i += kBruteThreads) s_chunk[i] = src[i];
    __syncthreads();
    if (active) {
      for (int j = 0; j < chunk; ++j) {
        const float* fd = s_chunk + j * 16;
        const float e0 = affine(x, y, fd[0], fd[1], fd[2]);
        const float e1 = affine(x, y, fd[3], fd[4], fd[5]);
        const float e2 = affine(x, y, fd[6], fd[7], fd[8]);
        const float depth = affine(x, y, fd[9], fd[10], fd[11]);
        const bool ok = (e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) &&
                        (depth > min_depth) && (fd[12] > 0.0f);
        const float zc = ok ? depth : kFar;
        if (zc < best_z) {  // ascending faces: strict < keeps the lowest
          best_z = zc;
          best_f = base + j;
        }
      }
    }
    __syncthreads();  // s_chunk is overwritten by the next chunk
  }
  if (!active) return;
  const size_t pix = (static_cast<size_t>(b) * H + py) * W + px;
  z_out[pix] = best_z;
  fid_out[pix] = best_z < kFar ? best_f : -1;
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

// The brute-force sweep; F must be a multiple of `chunk` (checked by the
// Python wrapper).
extern "C" int rnnpose_raster_brute(const void* face_data, void* z_out,
                                    void* fid_out, int B, int F, int H, int W,
                                    int chunk, float min_depth, void* stream) {
  const dim3 grid((W + kBruteTile - 1) / kBruteTile,
                  (H + kBruteTile - 1) / kBruteTile, B);
  const size_t smem = static_cast<size_t>(chunk) * 16 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        brute_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  brute_sweep_kernel<<<grid, kBruteThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(face_data), static_cast<float*>(z_out),
      static_cast<int*>(fid_out), F, H, W, chunk, min_depth);
  return static_cast<int>(cudaGetLastError());
}
