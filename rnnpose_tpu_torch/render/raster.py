"""Mesh rasterization (port of `rnnpose_tpu/render/raster.py`).

Both branches pack per-face screen data and bounding boxes and hand them to
a z-buffer sweep of `kernels/raster.py`, whose wrappers call the
`torch.ops.rnnpose` operators (a CUDA kernel on a CUDA tensor, the plain
version on the CPU; one graph node each under `torch.export`):
* `rasterize_with_vis_attrs`, the fused branch: the tile-culled sweep also
  interpolates constant vertex attributes (RGB, camera-frame normals) at the
  winning face. As in the JAX package it runs only when `_pick_tile` finds a
  pixel tile for the raster; otherwise it runs `rasterize` and
  `interpolate_attributes`;
* `rasterize`, the non-fused branch: z and face id from the tile-culled or
  the brute-force sweep, optionally over a per-pose compacted face set
  (backface culling), then the winner's full-resolution barycentrics;
  `render_mesh_attributes` adds the interpolation.
Two environment variables, read once at import as the JAX package reads
them: `RNNPOSE_RASTER_TILE` (the culled sweeps' pixel tile, default 16; see
`_pick_tile`) and `RNNPOSE_RASTER_GRID` ("rows", the default, runs the fused
branch through `zbuffer_sweep_rows_attrs`; "tile" through
`zbuffer_sweep_tiled_attrs_batched`; the results are the same).
`RNNPOSE_RASTER_SWEEP=mxu` selects a TPU matrix-unit variant of the JAX
kernels and changes nothing here. An exported forward (`utils/export`)
freezes the choices made while it was traced: the branch, the tile and the
operator; its manifest records them.
The results are detached: rasterization is not on the gradient path.
`compute_bary` recovers barycentrics of given (face, pixel) pairs on a
subgrid, and `interpolate_attributes` is the differentiable gather-form
interpolation (same values as the JAX package's one-hot form).
Screen-space barycentrics, pixel centres at +0.5.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..geometry import projective as proj
from ..geometry.precise import fma
from ..kernels.raster import (
    FAR,
    TILE,
    zbuffer_sweep,
    zbuffer_sweep_rows_attrs,
    zbuffer_sweep_rows_attrs_plain,
    zbuffer_sweep_tiled,
    zbuffer_sweep_tiled_attrs_batched,
    zbuffer_sweep_tiled_plain,
)

__all__ = [
    "Fragments",
    "prepare_face_data",
    "compact_faces",
    "rasterize",
    "rasterize_with_vis_attrs",
    "render_mesh_attributes",
    "compute_bary",
    "interpolate_attributes",
]

_AREA_EPS = 1e-9
_TILE_PREF = os.environ.get("RNNPOSE_RASTER_TILE")
_GRID_PREF = os.environ.get("RNNPOSE_RASTER_GRID", "rows")


def _pick_tile(h: int, w: int, chunk: int) -> Optional[int]:
    """The culled sweeps' pixel tile, by the JAX package's rule: the
    `RNNPOSE_RASTER_TILE` tile (default 16) if it divides h and w and its
    (tile^2, chunk) working set of 24-byte entries fits 8 MiB (the TPU's
    VMEM bound, kept so both packages take the same branch), else None."""
    for t in ((int(_TILE_PREF),) if _TILE_PREF else (16,)):
        if h % t == 0 and w % t == 0 and t * t * chunk * 4 * 6 <= 8 << 20:
            return t
    return None


class Fragments(NamedTuple):
    """Per-pixel rasterization results."""

    face_id: torch.Tensor  # (B, H, W) int, -1 where background
    bary: torch.Tensor     # (B, H, W, 3) screen-space barycentrics
    zbuf: torch.Tensor     # (B, H, W) depth, 0 where background


def _face_screen_data(uv, z, faces, face_valid):
    """Per-face edge functions of a batch of projected meshes.

    uv (B, V, 2), z (B, V), faces (F, 3) int64, face_valid (F,) or (B, F)
    bool ->
    edge_coef (B, F, 3, 3) rows [a, b, c] with E_k(x, y) = a x + b y + c
    twice the signed area of (p, v_{k+1}, v_{k+2}); zf (B, F, 3) corner
    depths; valid (B, F) non-degenerate, fully-front faces; area2 (B, F);
    fuv (B, F, 3, 2) corner pixel positions.

    c and area2 are the JAX package's formulas as written, each product
    rounded, not as XLA's CPU backend contracts them: c_k = x_i y_j - x_j y_i
    gives the two faces of an edge exact negatives (x_j y_i - x_i y_j), so no
    pixel centre falls between them. XLA's fma(x_i, y_j, -(x_j y_i)) rounds
    one product and not the other; the two constants then differ by up to
    an ulp of the products, and a pixel in that crack sees the surface
    behind it, a depth jump that a 1e-7 change of the pose toggles.
    """
    fuv = uv[:, faces]
    zf = z[:, faces]
    x0, y0 = fuv[..., 0, 0], fuv[..., 0, 1]
    x1, y1 = fuv[..., 1, 0], fuv[..., 1, 1]
    x2, y2 = fuv[..., 2, 0], fuv[..., 2, 1]
    a = torch.stack([y1 - y2, y2 - y0, y0 - y1], dim=-1)
    b = torch.stack([x2 - x1, x0 - x2, x1 - x0], dim=-1)
    c = torch.stack(
        [x1 * y2 - x2 * y1, x2 * y0 - x0 * y2, x0 * y1 - x1 * y0], dim=-1
    )
    edge_coef = torch.stack([a, b, c], dim=-1)
    area2 = a[..., 0] * x0 + b[..., 0] * y0 + c[..., 0]
    front = torch.all(zf > proj.MIN_DEPTH, dim=-1)
    valid = face_valid & front & (torch.abs(area2) > _AREA_EPS)
    return edge_coef, zf, valid, area2, fuv


def _area_normalised(edge_coef, valid, area2):
    ones = torch.ones_like(area2)
    inv_area = torch.where(valid, 1.0 / torch.where(valid, area2, ones),
                           torch.zeros_like(area2))
    return edge_coef * inv_area[..., None, None]


def prepare_face_data(
    uv: torch.Tensor, z: torch.Tensor, faces: torch.Tensor,
    face_valid: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sweep's inputs: face_data (B, F, 16) rows [9 area-normalised edge
    coefs | 3 depth coefs | valid | pad x3] and bbox (B, F, 4) [x0, y0, x1,
    y1], empty (+FAR, -FAR) for invalid faces. face_valid is (F,) or, per
    pose, (B, F)."""
    edge_coef, zf, valid, area2, fuv = _face_screen_data(uv, z, faces, face_valid)
    coef = _area_normalised(edge_coef, valid, area2)
    # Depth is affine in (x, y) too: d = (sum_k coef_k z_k) . [x, y, 1]. The
    # sum is a fused multiply-add chain over k, each step rounded to f32
    # (`precise.fma`), as the JAX package's XLA dot computes it: the
    # coefficients reach ~1e2, so a plain sum moves depths by ~1e-5.
    zcoef = coef[..., 0, :] * zf[..., 0, None]
    for k in (1, 2):
        zcoef = fma(coef[..., k, :], zf[..., k, None], zcoef)
    B, F = valid.shape
    face_data = torch.cat(
        [
            coef.reshape(B, F, 9),
            zcoef,
            valid.to(torch.float32)[..., None],
            torch.zeros((B, F, 3), dtype=coef.dtype, device=coef.device),
        ],
        dim=-1,
    )
    big = torch.full_like(fuv[..., 0, :], FAR)
    bbox = torch.cat(
        [
            torch.where(valid[..., None], fuv.amin(dim=-2), big),
            torch.where(valid[..., None], fuv.amax(dim=-2), -big),
        ],
        dim=-1,
    )
    return face_data, bbox


def compact_faces(
    face_data: torch.Tensor, bbox: torch.Tensor, compact_to: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Valid faces first, in their order, and only the first `compact_to`
    kept: (face_data (B, compact_to, 16), bbox (B, compact_to, 4), perm
    (B, compact_to) int64, the original index of each kept row)."""
    invalid = (face_data[..., 12] <= 0.0).to(torch.uint8)
    perm = torch.argsort(invalid, dim=-1, stable=True)[:, :compact_to]
    face_data = torch.gather(face_data, 1, perm[..., None].expand(-1, -1, 16))
    bbox = torch.gather(bbox, 1, perm[..., None].expand(-1, -1, 4))
    return face_data, bbox, perm


def _winner_bary(coef, fid_flat, pix_xy):
    """Barycentrics (B, P, 3) of the faces `fid_flat` (B, P) int64 at the
    pixel-centre coordinates `pix_xy` (..., 2) with P entries: x*a + y*b + c
    with each edge row of coef (B, F, 3, 3); 0 where fid_flat is -1.

    Rounded as the JAX package's `[x, y, 1] . coef` dot is on XLA's CPU
    backend, a fused multiply-add chain: round(x*a), then y*b added with one
    rounding (`precise.fma`), then c. Edge coefficients reach ~1e2, so
    separate rounding moves a weight by up to ~3e-5."""
    B = coef.shape[0]
    hit = fid_flat >= 0
    safe = torch.where(hit, fid_flat, torch.zeros_like(fid_flat))
    sel = torch.gather(
        coef.reshape(B, -1, 9), 1, safe[..., None].expand(B, safe.shape[1], 9)
    ).reshape(B, -1, 3, 3)
    px = pix_xy.reshape(1, -1, 1, 2).to(coef.dtype)
    bary = fma(px[..., 1], sel[..., 1], px[..., 0] * sel[..., 0]) + sel[..., 2]
    return torch.where(hit[..., None], bary, torch.zeros_like(bary))


@torch.no_grad()
def rasterize(
    verts_cam: torch.Tensor,
    faces: torch.Tensor,
    intrinsics: torch.Tensor,
    h: int,
    w: int,
    face_valid: Optional[torch.Tensor] = None,
    chunk: int = 128,
    use_pallas: Union[None, bool, str] = None,
    face_keep: Optional[torch.Tensor] = None,
    compact_to: Optional[int] = None,
) -> Fragments:
    """Rasterize camera-frame meshes (the JAX `rasterize` contract).

    Args:
      verts_cam: (B, V, 3) camera-frame vertices.
      faces: (F, 3) int64; F a multiple of `chunk`.
      intrinsics: (B, 4) [fx, fy, cx, cy].
      h, w: raster size, any.
      face_valid: optional (F,) bool mask of padded faces (default: faces
        whose three indices are equal are invalid).
      use_pallas: the z-buffer sweep, named as in the JAX package. None or
        "tiled": the tile-culled sweep, at the `_pick_tile` tile or, where
        there is none, at 16 (the JAX package then runs its scan sweep; z
        and face ids are the same); True: the brute-force sweep; both
        launch their CUDA kernel on a CUDA tensor and run the plain version
        on a CPU one. False: the plain version on any device.
      face_keep: optional (B, F) bool per-pose keep mask (backface culling).
      compact_to: with face_keep, sort the valid faces first and sweep only
        this many (a multiple of `chunk`).
    Returns:
      Fragments: face_id (B, h, w) int32 (-1 at background), bary (B, h, w,
      3) and zbuf (B, h, w) (0 at background), detached.
    """
    if face_valid is None:
        face_valid = ~((faces[:, 0] == faces[:, 1]) & (faces[:, 1] == faces[:, 2]))
    valid = face_valid if face_keep is None else face_valid & face_keep
    uv, _ = proj.project(verts_cam, intrinsics[:, None, :])
    face_data, bbox = prepare_face_data(uv, verts_cam[..., 2], faces, valid)
    perm = None
    if compact_to is not None and compact_to < face_data.shape[1]:
        if compact_to % chunk:
            raise ValueError(f"compact_to={compact_to} must be a multiple of chunk={chunk}")
        face_data, bbox, perm = compact_faces(face_data, bbox, compact_to)

    if use_pallas is None or use_pallas == "tiled":
        z, fid = zbuffer_sweep_tiled(face_data, bbox, h, w, chunk,
                                     tile=_pick_tile(h, w, chunk) or TILE)
    elif use_pallas is True:
        z, fid = zbuffer_sweep(face_data, h, w, chunk)
    elif use_pallas is False:
        z, fid = zbuffer_sweep_tiled_plain(face_data, bbox, h, w, chunk)
    else:
        raise ValueError(f"use_pallas must be None, 'tiled', True or False, got {use_pallas!r}")

    B = face_data.shape[0]
    dev = face_data.device
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    pix_xy = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)
    flat = fid.reshape(B, -1).long()
    hit = flat >= 0
    bary = _winner_bary(face_data[..., :9].reshape(B, -1, 3, 3), flat, pix_xy)
    if perm is not None:
        safe = torch.where(hit, flat, torch.zeros_like(flat))
        flat = torch.where(hit, torch.gather(perm, 1, safe), flat)
    return Fragments(
        face_id=flat.to(torch.int32).reshape(B, h, w),
        bary=bary.reshape(B, h, w, 3),
        zbuf=torch.where(fid >= 0, z, torch.zeros_like(z)),
    )


def render_mesh_attributes(
    verts_cam: torch.Tensor,
    faces: torch.Tensor,
    intrinsics: torch.Tensor,
    vert_attrs: torch.Tensor,
    h: int,
    w: int,
    face_valid: Optional[torch.Tensor] = None,
    chunk: int = 128,
):
    """Rasterize + interpolate in one call: (attr_maps (B, h, w, D), depth
    (B, h, w), mask (B, h, w))."""
    frags = rasterize(verts_cam, faces, intrinsics, h, w, face_valid, chunk)
    attr = interpolate_attributes(frags, faces, vert_attrs)
    return attr, frags.zbuf, (frags.face_id >= 0).to(verts_cam.dtype)


@torch.no_grad()
def rasterize_with_vis_attrs(
    verts_cam: torch.Tensor,
    faces: torch.Tensor,
    intrinsics: torch.Tensor,
    vis_attrs: torch.Tensor,
    h: int,
    w: int,
    face_valid: torch.Tensor,
    chunk: int = 128,
    plain: bool = False,
):
    """Rasterize and interpolate constant vertex attributes in one sweep.

    Args:
      verts_cam: (B, V, 3) camera-frame vertices.
      faces: (F, 3) int64; F a multiple of `chunk`; face_valid (F,) bool.
      intrinsics: (B, 4) [fx, fy, cx, cy].
      vis_attrs: (B, V, D) constant vertex attributes.
      h, w: raster size.
      plain: run the plain sweeps on any device; by default a CUDA tensor
        launches the kernels and a CPU tensor runs the plain versions.
    Returns:
      (attrs (B, h, w, D) 0 where empty, zbuf (B, h, w) 0 where empty,
       face_id (B, h, w) int32 -1 where empty), all detached.

    The fused sweep runs at the `_pick_tile` tile, on the grid
    `_GRID_PREF` names; without a tile, `rasterize` and
    `interpolate_attributes` (the JAX package's unfused branch).
    """
    tile = _pick_tile(h, w, chunk)
    if tile is None:
        frags = rasterize(verts_cam, faces, intrinsics, h, w, face_valid, chunk,
                          use_pallas=False if plain else None)
        return interpolate_attributes(frags, faces, vis_attrs), frags.zbuf, frags.face_id
    if plain:
        sweep = zbuffer_sweep_rows_attrs_plain
    elif _GRID_PREF == "tile":
        sweep = zbuffer_sweep_tiled_attrs_batched
    else:
        sweep = zbuffer_sweep_rows_attrs
    uv, _ = proj.project(verts_cam, intrinsics[:, None, :])
    face_data, bbox = prepare_face_data(uv, verts_cam[..., 2], faces, face_valid)
    corner_attrs = vis_attrs[:, faces].to(torch.float32)    # (B, F, 3, D)
    zb, fid, attr = sweep(face_data, bbox, corner_attrs, h, w, chunk=chunk, tile=tile)
    hit = fid >= 0
    return (
        torch.where(hit[..., None], attr, torch.zeros_like(attr)),
        torch.where(hit, zb, torch.zeros_like(zb)),
        fid,
    )


@torch.no_grad()
def compute_bary(
    verts_cam: torch.Tensor,
    faces: torch.Tensor,
    intrinsics: torch.Tensor,
    fid: torch.Tensor,
    pix_xy: torch.Tensor,
    face_valid: torch.Tensor,
) -> torch.Tensor:
    """Barycentrics (B, h', w', 3) of the faces `fid` (B, h', w') at the
    absolute pixel-centre coordinates `pix_xy` (h', w', 2); 0 at
    background."""
    uv, _ = proj.project(verts_cam, intrinsics[:, None, :])
    edge_coef, _, valid, area2, _ = _face_screen_data(
        uv, verts_cam[..., 2], faces, face_valid
    )
    coef = _area_normalised(edge_coef, valid, area2)        # (B, F, 3, 3)
    B, hp, wp = fid.shape
    bary = _winner_bary(coef, fid.reshape(B, -1).long(), pix_xy)
    return bary.reshape(B, hp, wp, 3)


def interpolate_attributes(
    fragments: Fragments, faces: torch.Tensor, vert_attrs: torch.Tensor
) -> torch.Tensor:
    """Barycentric vertex-attribute interpolation, differentiable in
    `vert_attrs` (B, V, D). Returns (B, H, W, D), zeros at background."""
    fid = fragments.face_id
    B = fid.shape[0]
    D = vert_attrs.shape[-1]
    flat = fid.reshape(B, -1).long()
    hit = flat >= 0
    safe = torch.where(hit, flat, torch.zeros_like(flat))
    corner = faces[safe].reshape(B, -1)                      # (B, P*3)
    vals = torch.gather(
        vert_attrs, 1, corner[..., None].expand(B, corner.shape[1], D)
    ).reshape(B, -1, 3, D)
    bary = fragments.bary.reshape(B, -1, 3).to(vert_attrs.dtype)
    out = torch.einsum("bpk,bpkd->bpd", bary, vals)
    out = out * hit[..., None].to(out.dtype)
    return out.reshape(fid.shape + (D,))
