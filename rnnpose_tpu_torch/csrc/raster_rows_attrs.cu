// Tile-culled z-buffer sweep with fused winner attribute interpolation.
//
// Replaces the Pallas TPU kernel `zbuffer_sweep_rows_attrs_batched`
// (rnnpose_tpu/ops/pallas_raster.py, kernel body `_rows_attrs_kernel_batched`)
// and keeps its contract. The sweep itself, what bounds it on the H100 and
// its design are in raster_sweep.cuh, shared with raster_tiled.cu; this
// file instantiates it with culling and attributes on.

#include "raster_sweep.cuh"

// H and W must be multiples of 16 (the TPU kernel's contract, checked by
// the Python wrapper) and F a multiple of `chunk`.
extern "C" int rnnpose_raster_rows_attrs(
    const void* face_data, const void* bbox, const void* corner_attrs,
    void* z_out, void* fid_out, void* attr_out, int B, int F, int H, int W,
    int D, int chunk, float min_depth, void* stream) {
  return launch_raster_sweep<true, true>(face_data, bbox, corner_attrs, z_out,
                                         fid_out, attr_out, B, F, H, W, D,
                                         chunk, min_depth, stream);
}
