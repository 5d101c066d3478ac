// Z-buffer sweep, z and face id only, batched, with or without tile culling.
//
// Replaces two Pallas TPU kernels of rnnpose_tpu/ops/pallas_raster.py:
//   * `zbuffer_sweep_tiled` (kernel body `_tiled_kernel`), cull = 1: each
//     tile x tile pixel tile sweeps only the face chunks whose bboxes
//     overlap it. The TPU version builds (T, F/chunk) culling tables in XLA
//     and runs one mesh per call (the JAX rasterizer loops over the batch in
//     Python); here each CTA culls its own chunks and one launch covers the
//     batch;
//   * `zbuffer_sweep` (kernel body `_kernel`), cull = 0: brute force, every
//     pixel against every face, on 16 x 16 tiles (`tile` is ignored). `bbox`
//     may then be null.
// The sweep, what bounds it on the H100 and its design are in
// raster_sweep.cuh. Any H and W: the pixels of partial edge tiles are
// masked (the TPU kernels' tile-multiple sizes were a TPU tiling limit).

#include "raster_sweep.cuh"

extern "C" int rnnpose_raster_tiled(const void* face_data, const void* bbox,
                                    void* z_out, void* fid_out, int B, int F,
                                    int H, int W, int chunk, int tile,
                                    int cull, float min_depth, void* stream) {
  if (cull) {
    return launch_raster_sweep<true, false>(face_data, bbox, nullptr, z_out,
                                            fid_out, nullptr, B, F, H, W, 0,
                                            chunk, tile, min_depth, stream);
  }
  return launch_instance<false, false, 1>(face_data, nullptr, nullptr, z_out,
                                          fid_out, nullptr, B, F, H, W, 0,
                                          chunk, 16, min_depth, stream);
}
