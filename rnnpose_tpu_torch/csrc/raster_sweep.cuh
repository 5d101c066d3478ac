// The culled z-buffer sweep shared by every culled raster kernel of the port
// (raster_rows_attrs.cu, raster_tiled.cu, raster_tiled_attrs.cu): face-level
// culling on the card, staged faces, clusters that split a block's faces.
// Together they replace the TPU kernels `zbuffer_sweep_rows_attrs_batched`,
// `zbuffer_sweep_tiled`, `zbuffer_sweep_tiled_attrs_batched` and
// `zbuffer_sweep_tiled_attrs` of rnnpose_tpu/ops/pallas_raster.py.
//
// Contract (that of the Pallas kernels in rnnpose_tpu/ops/pallas_raster.py):
//   face_data    (B, F, 16) f32 rows [9 area-normalised edge coefs |
//                3 depth coefs | valid | pad x3];
//   bbox         (B, F, 4) f32 [x0, y0, x1, y1], empty for invalid faces
//                (culled sweep only);
//   corner_attrs (B, F, 3, D) f32 (read only with attributes);
//   -> z (B, H, W) f32 (1e9 where empty), fid (B, H, W) i32 (-1 where
//      empty) and, with attributes, attrs (B, H, W, D) f32 (0 where empty).
// Pixels are sampled at their centres (+0.5). A pixel is covered when all
// three edge values are >= 0, depth > min_depth and the face is valid. The
// nearest depth wins; on a tie the lowest face index wins. The culled sweep
// takes the lexicographic minimum of (z, face index), which equals the TPU
// kernels' first minimum inside a chunk plus strict `<` across ascending
// chunks, whatever order the faces are visited in.
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32): each input read
// once and each output written once is 2.47 MB at B=1 and 19.7 MB at B=8
// for the attribute sweep (240^2, F=4096, D=6), 0.79 / 6.31 MB for z/fid
// only: 0.74 / 5.9 us and 0.24 / 1.9 us. The operations (about 20 flops per
// pixel whose centre lies in a face's bbox, ~1e6 such pairs at B=8) bound
// it at 0.3 us, so bytes set the bound. Against that bound the cost is
// latency and wasted tests: a block that loops over face chunks in series,
// a 128-face chunk swept by every pixel of a block because one of its faces
// touches the block, and the one heaviest block that sets the time at B=1.
// The culled sweep's design:
//   * one CTA of 512 threads per 32 x 32 pixel block (or a cluster of
//     `split` CTAs per block, below). The block is the sweep's own: culling
//     changes no result, so the wrappers' `tile` (their contract's and the
//     TPU grid's) does not reach the card. Pixels past H or W (a partial
//     edge block) are never tested or written, so any H and W works;
//   * face-level culling in the same launch: every thread issues its bbox
//     loads (float4) back to back, kScan a round, and clips each bbox,
//     dilated by kDil pixels, to the block: the rectangle of pixels whose
//     centres it holds (a rounded edge test can pass a hair outside the
//     exact bbox; empty and NaN boxes stay culled, as every comparison with
//     them is false). Faces with pixels in the block go into a shared-memory
//     list (warp ballot, popc, one shared counter) with their rectangle. One
//     CTA culls for 4 tiles of 16 x 16, so the scan reads F x 16 B from L2
//     once per 32 x 32 pixels (33.5 MB at B=8, not 118 MB), and needs no
//     second launch;
//   * the listed faces' rows (64 B) are gathered into shared memory with
//     cp.async, 16 B a thread, in batches of 128, double-buffered so that
//     batch k+1 loads while batch k is swept;
//   * the sweep is face-parallel: a warp takes a listed face and its lanes
//     the face's rectangle, 32 / width rows a pass, so the pixel tests are
//     those of the dilated bboxes (1.8 M at B=8) and not every pixel of a
//     block against every listed face (46 M). A covered pixel takes the
//     minimum of the packed key (z bits << 32 | face index) with a shared
//     64-bit atomicMin (a compare-and-swap loop on this card): z > 0, so
//     the key orders as the lexicographic (z, face index), whatever order
//     the faces and lanes arrive in. 16 warps a CTA, because the time is
//     the serial chain of the most crowded block's faces;
//   * balance: a cluster of `split` CTAs (1, 2, 4 or 8; the wrapper picks
//     the least that gives every SM a CTA: 4 at B=1 and 1 at B=8) shares
//     one block. Rank r culls and sweeps every split-th run of 32 faces
//     (neighbouring faces lie close on screen, so a crowded block's faces
//     spread over the ranks), and the ranks merge their keys through
//     distributed shared memory with the same minimum, rank r finishing
//     rows r*32/split.. of the block;
//   * the winner's edge coefficients and corner attributes are read with a
//     direct indexed load (the TPU kernel's one-hot matmul recovery was a
//     workaround for gathers), and a warp writes a block row's attributes
//     an element a lane, so that the stores coalesce. The kernel allocates
//     nothing.
// Edge, depth and attribute values are computed as `x*a + y*b + c` with
// explicit round-to-nearest multiplies and adds (no FMA contraction; the
// sources build with --fmad=false), the same rounding as the elementwise
// PyTorch version, so face ids agree exactly at edge ties.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 32;                  // culled sweep: pixel block side
constexpr int kPixels = kBlock * kBlock;
constexpr int kPixPerThread = kPixels / kThreads;
constexpr int kListCap = 2048;              // list entries a round
constexpr int kScan = kListCap / kThreads;  // bbox loads per thread a round
constexpr int kBatch = kThreads / 4;        // faces staged per batch (16 B a thread)
constexpr int kMaxSplit = 8;
constexpr float kDil = 1.0f;                // bbox dilation in pixels
constexpr float kFar = 1e9f;

__device__ __forceinline__ float affine(float x, float y, float a, float b,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), c);
}

// The cull of one face's bbox r against the block at (tx0, ty0) whose first
// nx columns and ny rows lie in the image: the pixels of the block whose
// centres the bbox dilated by kDil holds, columns c0..c1 and rows r0..r1
// relative to the block, packed c0 | c1 << 5 | r0 << 10 | r1 << 15; -1 when
// there are none. ops/raster_kernels.tile_face_overlap is the same
// predicate in PyTorch.
__device__ __forceinline__ int face_rect(float4 r, int tx0, int ty0, int nx,
                                         int ny) {
  const float x0 = __fsub_rn(r.x, kDil), x1 = __fadd_rn(r.z, kDil);
  const float y0 = __fsub_rn(r.y, kDil), y1 = __fadd_rn(r.w, kDil);
  const float fx = static_cast<float>(tx0), fy = static_cast<float>(ty0);
  const bool hit = (x0 <= __fadd_rn(static_cast<float>(tx0 + nx - 1), 0.5f)) &
                   (x1 >= __fadd_rn(fx, 0.5f)) &
                   (y0 <= __fadd_rn(static_cast<float>(ty0 + ny - 1), 0.5f)) &
                   (y1 >= __fadd_rn(fy, 0.5f));
  if (!hit) return -1;
  const int c0 = static_cast<int>(
      fmaxf(ceilf(__fsub_rn(__fsub_rn(x0, fx), 0.5f)), 0.0f));
  const int c1 = static_cast<int>(fminf(
      floorf(__fsub_rn(__fsub_rn(x1, fx), 0.5f)), static_cast<float>(nx - 1)));
  const int r0 = static_cast<int>(
      fmaxf(ceilf(__fsub_rn(__fsub_rn(y0, fy), 0.5f)), 0.0f));
  const int r1 = static_cast<int>(fminf(
      floorf(__fsub_rn(__fsub_rn(y1, fy), 0.5f)), static_cast<float>(ny - 1)));
  if (c0 > c1 || r0 > r1) return -1;
  return c0 | (c1 << 5) | (r0 << 10) | (r1 << 15);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (z, f) packed so that the unsigned order is the lexicographic order of
// (z, f) for z >= 0: the contract's tie rule in any visiting order.
__device__ __forceinline__ unsigned long long pack_key(float z, int f) {
  return (static_cast<unsigned long long>(__float_as_uint(z)) << 32) |
         static_cast<unsigned>(f);
}
__device__ __forceinline__ float key_z(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}
__device__ __forceinline__ int key_f(unsigned long long key) {
  return static_cast<int>(key & 0xffffffffull);
}

// The culled sweep. Grid (ceil(W/32) * split, ceil(H/32), B), launched as
// clusters of (split, 1, 1); min_depth >= 0.
template <bool kAttrs>
__global__ void __launch_bounds__(kThreads) culled_sweep_kernel(
    const float* __restrict__ face_data, const float4* __restrict__ bbox,
    const float* __restrict__ corner_attrs, float* __restrict__ z_out,
    int* __restrict__ fid_out, float* __restrict__ attr_out, int F, int H,
    int W, int D, float min_depth) {
  __shared__ int2 s_list[kListCap];  // (face index, packed rectangle)
  __shared__ __align__(16) float s_face[2][kBatch * 16];
  __shared__ unsigned long long s_key[kPixels];  // running minimum per pixel
  __shared__ int s_count;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.z;
  const int tx0 = (blockIdx.x / split) * kBlock;
  const int ty0 = blockIdx.y * kBlock;
  const int nx = min(kBlock, W - tx0), ny = min(kBlock, H - ty0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned long long empty = pack_key(kFar, -1);
  for (int p = tid; p < kPixels; p += kThreads) s_key[p] = empty;

  const float* fd_b = face_data + static_cast<size_t>(b) * F * 16;
  const float4* bb_b = bbox + static_cast<size_t>(b) * F;

  for (int base = 0; base < F; base += kListCap * split) {
    // 1. Cull: this rank's faces of the round against the block.
    if (tid == 0) s_count = 0;
    __syncthreads();
    float4 r[kScan];
#pragma unroll
    for (int i = 0; i < kScan; ++i) {
      const int f = base + ((i * kWarps + warp) * split + rank) * 32 + lane;
      r[i] = f < F ? __ldg(bb_b + f) : make_float4(kFar, kFar, -kFar, -kFar);
    }
#pragma unroll
    for (int i = 0; i < kScan; ++i) {
      const int f = base + ((i * kWarps + warp) * split + rank) * 32 + lane;
      const int rect = face_rect(r[i], tx0, ty0, nx, ny);
      const unsigned hits = __ballot_sync(0xffffffffu, rect >= 0);
      if (hits) {
        int at = 0;
        if (lane == 0) at = atomicAdd(&s_count, __popc(hits));
        at = __shfl_sync(0xffffffffu, at, 0);
        if (rect >= 0) {
          s_list[at + __popc(hits & ((1u << lane) - 1u))] = make_int2(f, rect);
        }
      }
    }
    __syncthreads();
    const int n = s_count;

    // 2. Sweep the listed faces, staged in batches of kBatch rows; a warp
    // takes a face, its lanes the face's pixels.
    const int num_batches = (n + kBatch - 1) / kBatch;
    const int row = tid >> 2, piece = (tid & 3) * 4;
    auto stage = [&](int k) {
      const int e = k * kBatch + row;
      if (e < n) {
        cp_async16(&s_face[k & 1][row * 16 + piece],
                   fd_b + static_cast<size_t>(s_list[e].x) * 16 + piece);
      }
      cp_async_commit();
    };
    if (num_batches > 0) stage(0);
    for (int k = 0; k < num_batches; ++k) {
      if (k + 1 < num_batches) {
        stage(k + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int m = min(kBatch, n - k * kBatch);
      for (int j = warp; j < m; j += kWarps) {
        const int2 e = s_list[k * kBatch + j];
        const int c0 = e.y & 31, width = ((e.y >> 5) & 31) - c0 + 1;
        const int r0 = (e.y >> 10) & 31, r1 = (e.y >> 15) & 31;
        // Lane -> (row offset, column): `width` columns a row,
        // rows_per_pass rows a pass. Both are floors of (n + 0.5) / width,
        // at least 0.5 / width from an integer, so the approximate
        // division gives them exactly.
        const int lr = static_cast<int>(
            __fdividef(static_cast<float>(lane) + 0.5f, static_cast<float>(width)));
        const int rows_per_pass =
            static_cast<int>(__fdividef(32.5f, static_cast<float>(width)));
        if (lr >= rows_per_pass) continue;
        const float4* fd = reinterpret_cast<const float4*>(s_face[k & 1] + j * 16);
        const float4 q0 = fd[0], q1 = fd[1], q2 = fd[2], q3 = fd[3];
        // q0..q2: a0 b0 c0 a1 | b1 c1 a2 b2 | c2 az bz cz; q3.x: valid.
        if (!(q3.x > 0.0f)) continue;
        const int col = c0 + lane - lr * width;
        const float x = __fadd_rn(static_cast<float>(tx0 + col), 0.5f);
        const float xa0 = __fmul_rn(x, q0.x), xa1 = __fmul_rn(x, q0.w);
        const float xa2 = __fmul_rn(x, q1.z), xaz = __fmul_rn(x, q2.y);
        for (int rr = r0 + lr; rr <= r1; rr += rows_per_pass) {
          const float y = __fadd_rn(static_cast<float>(ty0 + rr), 0.5f);
          const float e0 = __fadd_rn(__fadd_rn(xa0, __fmul_rn(y, q0.y)), q0.z);
          const float e1 = __fadd_rn(__fadd_rn(xa1, __fmul_rn(y, q1.x)), q1.y);
          const float e2 = __fadd_rn(__fadd_rn(xa2, __fmul_rn(y, q1.w)), q2.x);
          const float depth = __fadd_rn(__fadd_rn(xaz, __fmul_rn(y, q2.z)), q2.w);
          if ((e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) && (depth > min_depth)) {
            atomicMin(&s_key[rr * kBlock + col], pack_key(depth, e.x));
          }
        }
      }
      __syncthreads();  // the buffer is restaged two batches on
    }
    __syncthreads();  // every thread has read s_count before the next round
  }

  // 3. Merge the ranks' minima (distributed shared memory): rank r
  // finishes rows row_lo..row_lo + rows_per_rank - 1 of the block.
  const int rows_per_rank = kBlock / split;
  const int row_lo = rank * rows_per_rank;
  const int row_hi = min(row_lo + rows_per_rank, ny);
  unsigned long long key[kPixPerThread];
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    const int p = tid + i * kThreads;
    key[i] = s_key[p];
  }
  if (split > 1) {
    cluster.sync();  // every rank's minima are final
#pragma unroll
    for (int i = 0; i < kPixPerThread; ++i) {
      const int p = tid + i * kThreads;
      if ((p / kBlock) / rows_per_rank != rank) continue;
      for (int other = 0; other < split; ++other) {
        if (other == rank) continue;
        const unsigned long long k2 = cluster.map_shared_rank(s_key, other)[p];
        key[i] = k2 < key[i] ? k2 : key[i];
      }
    }
    cluster.sync();  // no rank changes or leaves its minima while read
#pragma unroll
    for (int i = 0; i < kPixPerThread; ++i) s_key[tid + i * kThreads] = key[i];
  }

  // 4. Write this rank's rows: z and fid a pixel a thread (a warp a row).
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    const int p = tid + i * kThreads;
    const int row = p / kBlock, col = p % kBlock;
    if (row < row_lo || row >= row_hi || col >= nx) continue;
    const size_t pix = (static_cast<size_t>(b) * H + ty0 + row) * W + tx0 + col;
    const float z = key_z(key[i]);
    z_out[pix] = z;
    fid_out[pix] = z < kFar ? key_f(key[i]) : -1;
  }
  if (!kAttrs) return;

  // Attributes: the winners' barycentrics into shared memory (the list's
  // space), then each warp writes whole rows of the block's (pixel, d)
  // outputs, one element a lane, so that the stores are coalesced.
  float* s_w = reinterpret_cast<float*>(s_list);  // 3 x kPixels floats
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    const int p = tid + i * kThreads;
    const int row = p / kBlock, col = p % kBlock;
    if (row < row_lo || row >= row_hi || col >= nx || !(key_z(key[i]) < kFar)) continue;
    const float x = __fadd_rn(static_cast<float>(tx0 + col), 0.5f);
    const float y = __fadd_rn(static_cast<float>(ty0 + row), 0.5f);
    const float* fd = fd_b + static_cast<size_t>(key_f(key[i])) * 16;
    s_w[p] = affine(x, y, fd[0], fd[1], fd[2]);
    s_w[kPixels + p] = affine(x, y, fd[3], fd[4], fd[5]);
    s_w[2 * kPixels + p] = affine(x, y, fd[6], fd[7], fd[8]);
  }
  __syncthreads();
  for (int row = row_lo + warp; row < row_hi; row += kWarps) {
    float* out = attr_out + ((static_cast<size_t>(b) * H + ty0 + row) * W + tx0) * D;
    for (int e = lane; e < nx * D; e += 32) {
      // Pixel c and channel d of element e: c = floor((e + 0.5) / D), at
      // least 0.5 / D from an integer, so the approximate division is exact.
      const int c = static_cast<int>(
          __fdividef(static_cast<float>(e) + 0.5f, static_cast<float>(D)));
      const int d = e - c * D;
      const int p = row * kBlock + c;
      const unsigned long long kp = s_key[p];
      float v = 0.0f;
      if (key_z(kp) < kFar) {
        const float* ca =
            corner_attrs + (static_cast<size_t>(b) * F + key_f(kp)) * 3 * D;
        v = __fadd_rn(__fadd_rn(__fmul_rn(s_w[p], ca[d]),
                                __fmul_rn(s_w[kPixels + p], ca[D + d])),
                      __fmul_rn(s_w[2 * kPixels + p], ca[2 * D + d]));
      }
      out[e] = v;
    }
  }
}

// One launch of the culled sweep on `stream`, `split` CTAs per block
// (1, 2, 4 or 8, else cudaErrorInvalidValue); returns the launch's
// cudaError (0 = ok). The Python wrappers check shapes, dtypes, devices,
// contiguity and 16-byte alignment before calling.
template <bool kAttrs>
int launch_culled_sweep(const void* face_data, const void* bbox,
                        const void* corner_attrs, void* z_out, void* fid_out,
                        void* attr_out, int B, int F, int H, int W, int D,
                        int split, float min_depth, void* stream) {
  if (split < 1 || split > kMaxSplit || (split & (split - 1)) || B < 1 ||
      H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((W + kBlock - 1) / kBlock) * split,
                     (H + kBlock - 1) / kBlock, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, culled_sweep_kernel<kAttrs>, static_cast<const float*>(face_data),
      static_cast<const float4*>(bbox),
      static_cast<const float*>(corner_attrs), static_cast<float*>(z_out),
      static_cast<int*>(fid_out), static_cast<float*>(attr_out), F, H, W, D,
      min_depth);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
