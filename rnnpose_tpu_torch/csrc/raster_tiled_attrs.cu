// Tile-culled z-buffer sweep with fused winner attribute interpolation, on
// a per-(b, tile) grid at any supported tile.
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
// `_pick_tile`); here the tile is a runtime argument and each thread owns
// ceil(tile^2 / 256) pixels (raster_sweep.cuh: the sweep, what bounds it on
// the H100 and its design).

#include "raster_sweep.cuh"

// H and W must be multiples of `tile` (the TPU kernels' contract, checked by
// the Python wrappers) and F a multiple of `chunk`.
extern "C" int rnnpose_raster_tiled_attrs(
    const void* face_data, const void* bbox, const void* corner_attrs,
    void* z_out, void* fid_out, void* attr_out, int B, int F, int H, int W,
    int D, int chunk, int tile, float min_depth, void* stream) {
  return launch_raster_sweep<true, true>(face_data, bbox, corner_attrs, z_out,
                                         fid_out, attr_out, B, F, H, W, D,
                                         chunk, tile, min_depth, stream);
}
