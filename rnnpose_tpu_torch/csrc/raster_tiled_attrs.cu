// Culled z-buffer sweep with fused winner attribute interpolation, the
// kernel of the per-(b, tile) grid and of the one-mesh render.
//
// Replaces two Pallas TPU kernels of rnnpose_tpu/ops/pallas_raster.py:
//   * `zbuffer_sweep_tiled_attrs_batched` (kernel body
//     `_tiled_attrs_kernel_batched`): (B, F) faces over a (B, tiles) grid,
//     the grid the JAX package selects with RNNPOSE_RASTER_GRID=tile. Its
//     optional MXU sweep (RNNPOSE_RASTER_SWEEP=mxu) is a TPU matrix-unit
//     variant of the same arithmetic and has no counterpart here;
//   * `zbuffer_sweep_tiled_attrs` (kernel body `_tiled_attrs_kernel`): one
//     mesh, the same launch at B = 1.
// Both TPU kernels take tiles of 16, 24, 32 or 40 pixels (the JAX package's
// `_pick_tile`). Culling changes no result, so the tile stays the wrappers'
// contract and the sweep runs on its own 32 x 32 blocks.
//
// Its bound on the H100 is that of raster_rows_attrs.cu (the same function):
// 2.47 MB at B=1 and 19.7 MB at B=8 (240^2, F=4096, D=6), 0.74 us and
// 5.9 us at 3.35 TB/s. The design against it is in raster_sweep.cuh.

#include "raster_sweep.cuh"

// H and W are multiples of the wrapper's tile (checked by the Python
// wrappers).
extern "C" int rnnpose_raster_tiled_attrs(
    const void* face_data, const void* bbox, const void* corner_attrs,
    void* z_out, void* fid_out, void* attr_out, int B, int F, int H, int W,
    int D, int split, float min_depth, void* stream) {
  return launch_culled_sweep<true>(face_data, bbox, corner_attrs, z_out,
                                   fid_out, attr_out, B, F, H, W, D, split,
                                   min_depth, stream);
}
