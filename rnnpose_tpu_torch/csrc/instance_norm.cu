// InstanceNorm2d(affine=False) of a (B, C, H, W) tensor, with the ReLU after
// it where the caller applies one, in one launch (`models/raft.InstanceNorm`
// where no gradient is needed; the plain version is
// `kernels/norm.instance_norm_plain`).
//
// Replaces no TPU kernel: the JAX package leaves the norm to XLA, which
// fuses it. Written in PyTorch ops it is a chain of eight kernels (a cast to
// f32, the mean, the variance, the subtraction, + eps, rsqrt, the product
// and the cast back) and the ReLU's, 48 norms a served RNNPose frame and 15 a
// RAFT pair; its two reductions leave only B x C outputs to spread over the
// card. What bounds it on the H100: the bytes. The chain moves about 40 bytes
// an element in bf16; the least is the input read once and the output written
// once, 4 bytes in bf16 and 8 in f32 (RAFT's 440 x 1024 stem, B=2: 57.7 MB,
// 17 us at 3.35 TB/s).
//
// The design: a thread-block cluster for each (sample, group of channels),
// the grid's x the cluster's blocks. A thread moves 16-byte vectors (8
// elements in bf16, 4 in f32). In the channels-last layout that every
// encoder's convolution leaves, an item is a position's next 1, 2 or 4
// vectors of channels (up to 64 bytes: whole sectors, where one vector at a
// position's stride fetched twice the bytes it used) and a group those
// channels; in contiguous NCHW a group is one channel and an item one vector
// of neighbouring positions. The wrapper takes the widest item that still
// leaves a cluster of 16 blocks to every two SMs, and the fewest blocks that
// hold at most 64 KiB each and give the launch a block for every four SMs. Each block loads its share of the group's items
// once, four accesses in flight a thread, into its shared memory, and sums
// them per channel in f32; the cluster's blocks read each other's partial
// sums through distributed shared memory, in block order, so every block
// holds the same mean; the same again for the squared deviations from that
// mean (the population variance as the chain takes it, never E[x^2] -
// E[x]^2); then each block writes its share, (x - mean) * (1 / sqrt(var +
// eps)) rounded op by op as the chain's ops are, cast to the input's type,
// the ReLU last. Device memory is read once and written once. A share past
// 128 KiB (a group past 2 MiB, as RAFT's 220 x 512 stem) takes the second
// mode of the same kernel, chosen by the wrapper from the shape: each pass
// reads its share again, which the L2 cache mostly serves (measured faster
// there than a full shared memory). Sums run per thread, then warp
// shuffles, the warps in order and the blocks in order: no atomics and no
// state between launches, so every launch gives the same bits, on any
// stream, and a graph replays it as it is.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 16;               // the H100's largest cluster
constexpr int kMaxCacheBytes = 128 * 1024;  // a block's share kept on chip at most
constexpr int kMaxGrid = 65535;             // groups along y, samples along z

// The element types: the stored bits, and their value in f32.
struct F32 {
  using Bits = float;
  static __device__ __forceinline__ float value(float b) { return b; }
  static __device__ __forceinline__ float round(float y) { return y; }
};
struct BF16 {
  using Bits = unsigned short;
  static __device__ __forceinline__ float value(unsigned short b) {
    return __uint_as_float(static_cast<unsigned>(b) << 16);
  }
  // Round to nearest even, as the chain's cast does; the result as f32.
  static __device__ __forceinline__ float round(float y) {
    return __bfloat162float(__float2bfloat16_rn(y));
  }
};

template <int Bytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// G elements that lie next to each other in memory, moved as one access.
template <typename E, int G>
union Vec {
  typename Raw<sizeof(typename E::Bits) * G>::type raw;
  typename E::Bits v[G];
};

__device__ __forceinline__ float to_bits(F32, float y) { return y; }
__device__ __forceinline__ unsigned short to_bits(BF16, float y) {
  return static_cast<unsigned short>(__float_as_uint(y) >> 16);  // y is a bf16 value
}

// The block's sums of acc[0..G) by lane: slot s * G + j of part[] sums
// acc[j] over the threads of lane s (threadIdx.x % L, L a power of two
// dividing 32): warp shuffles down by L and more keep the lanes apart, then
// the warps are added in order.
template <int G, int L>
__device__ __forceinline__ void block_sums(const float (&acc)[G], float (*warp_part)[L * G],
                                           float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    float s = acc[j];
#pragma unroll
    for (int off = 16; off >= L; off >>= 1) {
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    }
    if (lane < L) warp_part[warp][lane * G + j] = s;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < L * G; x += kThreads) {
    float s = warp_part[0][x];
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, warp_part[w][x]);
    part[x] = s;
  }
}

// The cluster's sum of slot x, the blocks' parts read in block order; with
// `combine` (NCHW: every slot is the same channel) the sum over all slots.
// Called after a cluster.sync() that follows every block's `block_sums`.
template <int N>
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float* part, int x,
                                             int tiles, int combine) {
  float s = 0.0f;
  for (int i = combine ? 0 : x; i < (combine ? N : x + 1); ++i) {
    for (int k = 0; k < tiles; ++k) s = __fadd_rn(s, cluster.map_shared_rank(part, k)[i]);
  }
  return s;
}

// Calls body(v, get(v)) for this thread's vectors v < nv (v = threadIdx.x +
// m * kThreads), U gets issued before their bodies run, so that U loads
// from device memory are in flight at once.
template <int U, typename Get, typename Body>
__device__ __forceinline__ void sweep(int nv, Get get, Body body) {
  for (int v0 = threadIdx.x; v0 < nv; v0 += kThreads * U) {
    decltype(get(0)) x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v0 + u * kThreads < nv) x[u] = get(v0 + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (v0 + u * kThreads < nv) body(v0 + u * kThreads, x[u]);
    }
  }
}

// Grid (tiles, groups, B), launched as clusters of (tiles, 1, 1): one cluster
// a (sample, group). Item i of a group (L vectors of G elements, next to
// each other in memory) lies at b * batch_stride + group * group_stride +
// i * item_stride elements; block r of the cluster takes items
// [r * per_block, (r + 1) * per_block), its vector v being item v / L's
// lane v % L, so a warp's accesses cover 32 / L items' L vectors each.
template <typename E, int G, int L>
__global__ void __launch_bounds__(kThreads) instance_norm_kernel(
    const typename E::Bits* __restrict__ x, typename E::Bits* __restrict__ y,
    long long n_items, int per_block, long long item_stride, long long group_stride,
    long long batch_stride, int combine, int cached, float count, float eps, int relu) {
  using R = typename Raw<sizeof(typename E::Bits) * G>::type;
  constexpr int kSlots = L * G;  // the channels of a group (one, combined, in NCHW)
  extern __shared__ uint4 cache_raw[];
  R* cache = reinterpret_cast<R*>(cache_raw);
  __shared__ float warp_part[kWarps][kSlots];
  __shared__ float part_mean[kSlots], part_var[kSlots];  // this block's, read by the cluster
  __shared__ float mean_s[kSlots], rstd_s[kSlots];

  cg::cluster_group cluster = cg::this_cluster();
  const int tiles = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long begin = static_cast<long long>(rank) * per_block;
  const int nv =
      L * static_cast<int>(max(0LL, min(static_cast<long long>(per_block), n_items - begin)));
  const long long base = (blockIdx.z * batch_stride + blockIdx.y * group_stride) / G;
  const long long stride = item_stride / G;  // in vectors; item_stride is a multiple of G
  const R* src = reinterpret_cast<const R*>(x) + base;
  R* dst = reinterpret_cast<R*>(y) + base;
  const int s = threadIdx.x % L;  // this thread's lane: its G channels, in every pass
  auto at = [&](int v) { return (begin + v / L) * stride + s; };
  auto global = [&](int v) { return __ldg(src + at(v)); };
  auto kept = [&](int v) { return cached ? cache[v] : __ldg(src + at(v)); };

  // The mean: each element read once from device memory (and kept).
  float acc[G];
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = 0.0f;
  sweep<4>(nv, global, [&](int v, R raw) {
    if (cached) cache[v] = raw;
    Vec<E, G> e;
    e.raw = raw;
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = __fadd_rn(acc[j], E::value(e.v[j]));
  });
  block_sums<G, L>(acc, warp_part, part_mean);
  cluster.sync();  // every block's sums are written (and its cache filled)
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    mean_s[i] = __fdiv_rn(cluster_sum<kSlots>(cluster, part_mean, i, tiles, combine), count);
  }
  __syncthreads();
  float mean[G];
#pragma unroll
  for (int j = 0; j < G; ++j) mean[j] = mean_s[s * G + j];

  // The variance: the mean of the squared deviations from that mean.
#pragma unroll
  for (int j = 0; j < G; ++j) acc[j] = 0.0f;
  sweep<4>(nv, kept, [&](int, R raw) {
    Vec<E, G> e;
    e.raw = raw;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const float d = __fsub_rn(E::value(e.v[j]), mean[j]);
      acc[j] = __fadd_rn(acc[j], __fmul_rn(d, d));
    }
  });
  block_sums<G, L>(acc, warp_part, part_var);
  cluster.sync();  // every block's squared deviations are summed
  for (int i = threadIdx.x; i < kSlots; i += kThreads) {
    const float var = __fdiv_rn(cluster_sum<kSlots>(cluster, part_var, i, tiles, combine), count);
    rstd_s[i] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  __syncthreads();
  float rstd[G];
#pragma unroll
  for (int j = 0; j < G; ++j) rstd[j] = rstd_s[s * G + j];

  // The output: each element written once, in the input's type, ReLU last.
  sweep<4>(nv, kept, [&](int v, R raw) {
    Vec<E, G> e;
    e.raw = raw;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float r = E::round(__fmul_rn(__fsub_rn(E::value(e.v[j]), mean[j]), rstd[j]));
      if (relu && r < 0.0f) r = 0.0f;  // NaN stays NaN, -0 stays -0, as F.relu does
      e.v[j] = to_bits(E(), r);
    }
    dst[at(v)] = e.raw;
  });
  cluster.sync();  // no block leaves while its sums are read
}

template <typename E, int G, int L>
int launch(const void* x, void* y, long long n_items, int per_block, long long item_stride,
           long long group_stride, long long batch_stride, int groups, int B, int tiles,
           int combine, int cached, float count, float eps, int relu, cudaStream_t stream) {
  auto kernel = instance_norm_kernel<E, G, L>;
  const long long smem =
      cached ? static_cast<long long>(per_block) * L * G * sizeof(typename E::Bits) : 0;
  if (smem > kMaxCacheBytes || item_stride % G != 0 || (combine && L != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {  // past the default limit of dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxCacheBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (tiles > 8) {  // past the portable cluster size, on the current device
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, groups, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  using Bits = typename E::Bits;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const Bits*>(x), static_cast<Bits*>(y), n_items, per_block,
      item_stride, group_stride, batch_stride, combine, cached, count, eps, relu);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The norm of x into y on `stream` (capturable). x and y share one layout;
// `bf16` selects bfloat16 elements (else float32), `vec` the elements a
// vector holds (bf16: 8, 4, 2 or 1; f32: 4, 2 or 1), next to each other in
// memory and aligned to their size, and `lanes` the vectors an item holds,
// next to each other (1, 2 or 4; 1 unless `vec` is 16 bytes). A
// (sample, group) has `n_items` items, item i at b * batch_stride + group *
// group_stride + i * item_stride elements; `tiles` (1, 2, 4, 8 or 16)
// blocks of `per_block` items each, tiles * per_block >= n_items; `combine`
// when a group is one channel (its vectors' slots summed; lanes 1); `cached`
// keeps each block's items in shared memory (at most 128 KiB a block);
// `count` the elements a channel holds. Returns the launch's cudaError.
extern "C" int rnnpose_instance_norm(const void* x, void* y, int bf16, int vec, int lanes,
                                     long long n_items, int per_block, long long item_stride,
                                     long long group_stride, long long batch_stride, int groups,
                                     int B, int tiles, int combine, int cached, float count,
                                     float eps, int relu, void* stream) {
  if (n_items < 1 || per_block < 1 || groups < 1 || groups > kMaxGrid || B < 1 ||
      B > kMaxGrid || tiles < 1 || tiles > kMaxTiles || (tiles & (tiles - 1)) != 0 ||
      static_cast<long long>(tiles) * per_block < n_items) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RNNPOSE_NORM_LAUNCH(E, G, L)                                                          \
  return launch<E, G, L>(x, y, n_items, per_block, item_stride, group_stride, batch_stride,   \
                         groups, B, tiles, combine, cached, count, eps, relu, s)
  const int widest = bf16 ? 8 : 4;
  if (vec == widest) {
    switch (lanes) {
      case 1: if (bf16) { RNNPOSE_NORM_LAUNCH(BF16, 8, 1); } RNNPOSE_NORM_LAUNCH(F32, 4, 1);
      case 2: if (bf16) { RNNPOSE_NORM_LAUNCH(BF16, 8, 2); } RNNPOSE_NORM_LAUNCH(F32, 4, 2);
      case 4: if (bf16) { RNNPOSE_NORM_LAUNCH(BF16, 8, 4); } RNNPOSE_NORM_LAUNCH(F32, 4, 4);
      default: break;
    }
  } else if (lanes == 1) {
    switch (vec) {
      case 4: RNNPOSE_NORM_LAUNCH(BF16, 4, 1);
      case 2: if (bf16) { RNNPOSE_NORM_LAUNCH(BF16, 2, 1); } RNNPOSE_NORM_LAUNCH(F32, 2, 1);
      case 1: if (bf16) { RNNPOSE_NORM_LAUNCH(BF16, 1, 1); } RNNPOSE_NORM_LAUNCH(F32, 1, 1);
      default: break;
    }
  }
#undef RNNPOSE_NORM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
