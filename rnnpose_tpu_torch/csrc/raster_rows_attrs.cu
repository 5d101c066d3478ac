// Tile-culled z-buffer sweep with fused winner attribute interpolation.
//
// Replaces the Pallas TPU kernel `zbuffer_sweep_rows_attrs_batched`
// (rnnpose_tpu/ops/pallas_raster.py, kernel body `_rows_attrs_kernel_batched`)
// and keeps its contract. The sweep itself, what bounds it on the H100 and
// its design are in raster_sweep.cuh, shared with raster_tiled.cu and
// raster_tiled_attrs.cu; this file instantiates it with culling and
// attributes on. The TPU kernel's per-(b, tile-row) grid amortised the
// TPU's per-grid-step cost; a CTA has no such cost, so the grid here is one
// CTA per (b, tile), as in raster_tiled_attrs.cu.

#include "raster_sweep.cuh"

// H and W must be multiples of `tile` (the TPU kernel's contract, checked
// by the Python wrapper) and F a multiple of `chunk`.
extern "C" int rnnpose_raster_rows_attrs(
    const void* face_data, const void* bbox, const void* corner_attrs,
    void* z_out, void* fid_out, void* attr_out, int B, int F, int H, int W,
    int D, int chunk, int tile, float min_depth, void* stream) {
  return launch_raster_sweep<true, true>(face_data, bbox, corner_attrs, z_out,
                                         fid_out, attr_out, B, F, H, W, D,
                                         chunk, tile, min_depth, stream);
}
