// Culled z-buffer sweep with fused winner attribute interpolation.
//
// Replaces the Pallas TPU kernel `zbuffer_sweep_rows_attrs_batched`
// (rnnpose_tpu/ops/pallas_raster.py, kernel body `_rows_attrs_kernel_batched`)
// and keeps its contract: the default fused raster of serving and of every
// training step, 3 launches per request or step.
//
// Its bound on the H100: at 240^2, F=4096, D=6 the function reads face_data,
// bbox and corner_attrs (0.62 MB per batch item) and writes z, fid and attrs
// (1.84 MB per item): 2.47 MB at B=1 and 19.7 MB at B=8, 0.74 us and 5.9 us
// at 3.35 TB/s; the operations bound it lower (0.3 us at B=8). What the
// design does about it is in raster_sweep.cuh, shared with raster_tiled.cu
// and raster_tiled_attrs.cu: face-level culling in the launch, cp.async
// staging, clusters that split crowded blocks. The TPU kernel's
// per-(b, tile-row) grid amortised the TPU's per-grid-step cost and its
// chunk lists came from XLA; here one launch culls and sweeps.

#include "raster_sweep.cuh"

// H and W are multiples of the wrapper's tile (the TPU kernel's contract,
// checked by the Python wrapper; the sweep itself takes any H and W).
extern "C" int rnnpose_raster_rows_attrs(
    const void* face_data, const void* bbox, const void* corner_attrs,
    void* z_out, void* fid_out, void* attr_out, int B, int F, int H, int W,
    int D, int split, float min_depth, void* stream) {
  return launch_culled_sweep<true>(face_data, bbox, corner_attrs, z_out,
                                   fid_out, attr_out, B, F, H, W, D, split,
                                   min_depth, stream);
}
