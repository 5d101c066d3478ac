"""Mesh loading, simplification and padding on the host (numpy).

Copies of the numpy functions of `rnnpose_tpu/render/mesh.py`: dependency-free
OBJ/PLY readers, normalisation, and the static budgets: meshes are
simplified to a vertex/face budget with watertight vertex clustering, wound
outward, Morton-ordered and padded, so every rasterization has fixed shapes.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["TriMesh", "load_obj", "load_ply", "load_mesh", "normalize_mesh", "decimate_mesh",
           "simplify_mesh", "orient_faces_outward", "pad_mesh"]


@dataclasses.dataclass
class TriMesh:
    """Triangle mesh with per-vertex colors. All numpy, host-side."""

    verts: np.ndarray            # (V, 3) float32
    faces: np.ndarray            # (F, 3) int32
    vert_colors: np.ndarray      # (V, 3) float32 in [0, 1]
    num_verts: int = 0           # valid count (<= V) after padding
    num_faces: int = 0

    def __post_init__(self):
        if self.num_verts == 0:
            self.num_verts = len(self.verts)
        if self.num_faces == 0:
            self.num_faces = len(self.faces)


def load_obj(path: str) -> TriMesh:
    """Minimal OBJ parser: v / vn / f lines, fan-triangulates polygons."""
    verts, colors, faces = [], [], []
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:  # vertex color extension
                    colors.append([float(x) for x in parts[4:7]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for i in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[i], idx[i + 1]])
    v = np.asarray(verts, np.float32)
    f_arr = np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)
    c = (
        np.asarray(colors, np.float32)
        if len(colors) == len(verts)
        else np.full_like(v, 0.7)
    )
    return TriMesh(v, f_arr, c)


def load_ply(path: str) -> TriMesh:
    """Minimal binary/ascii PLY parser (vertex xyz [+rgb], face lists).

    Covers the BOP/LINEMOD model PLYs the reference reads via
    `thirdparty/vsd/inout.py`.
    """
    with open(path, "rb") as f:
        line = f.readline().decode("ascii").strip()
        assert line == "ply", f"not a ply file: {path}"
        fmt = None
        elems = []  # list of (name, count, [(prop_type, prop_name) or ('list', idx_t, cnt_t, name)])
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment") or line.startswith("obj_info"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elems.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[1], parts[2]))
            elif line == "end_header":
                break

        np_types = {
            "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
            "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
            "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
        }
        verts = colors = faces = None
        if fmt == "ascii":
            for name, cnt, props in elems:
                rows = [f.readline().decode("ascii").split() for _ in range(cnt)]
                if name == "vertex":
                    names = [p[-1] for p in props]
                    arr = np.asarray(rows, np.float64)
                    xi = [names.index(k) for k in ("x", "y", "z")]
                    verts = arr[:, xi].astype(np.float32)
                    if "red" in names:
                        ci = [names.index(k) for k in ("red", "green", "blue")]
                        colors = (arr[:, ci] / 255.0).astype(np.float32)
                elif name == "face":
                    faces = np.asarray([r[1:4] for r in rows], np.int32)
        else:
            endian = "<" if "little" in fmt else ">"
            for name, cnt, props in elems:
                if name == "vertex" and all(p[0] != "list" for p in props):
                    dt = np.dtype([(p[1], endian + np_types[p[0]]) for p in props])
                    data = np.frombuffer(f.read(dt.itemsize * cnt), dtype=dt)
                    verts = np.stack(
                        [data["x"], data["y"], data["z"]], axis=-1
                    ).astype(np.float32)
                    names = dt.names
                    if "red" in names:
                        colors = np.stack(
                            [data["red"], data["green"], data["blue"]], axis=-1
                        ).astype(np.float32) / 255.0
                elif name == "face":
                    # Assume uniform triangle lists.
                    assert props[0][0] == "list"
                    it = np.dtype(endian + np_types[props[0][1]])
                    vt = np.dtype(endian + np_types[props[0][2]])
                    out = np.empty((cnt, 3), np.int32)
                    extra_props = props[1:]
                    extra_size = sum(np.dtype(endian + np_types[p[0]]).itemsize for p in extra_props)
                    for i in range(cnt):
                        k = int(np.frombuffer(f.read(it.itemsize), it)[0])
                        vals = np.frombuffer(f.read(vt.itemsize * k), vt)
                        out[i] = vals[:3]
                        if extra_size:
                            f.read(extra_size)
                    faces = out
        if verts is None:
            raise ValueError(f"no vertex element in {path}")
        if colors is None:
            colors = np.full_like(verts, 0.7)
        if faces is None:
            faces = np.zeros((0, 3), np.int32)
        return TriMesh(verts, faces, colors)


def load_mesh(path: str) -> TriMesh:
    if path.endswith(".obj"):
        return load_obj(path)
    if path.endswith(".ply"):
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def normalize_mesh(mesh: TriMesh) -> Tuple[TriMesh, np.ndarray, float]:
    """Center + scale by bbox extent (reference `data/preprocess.py:397-406`).

    Returns (normalized mesh, center (3,), scale). Poses must be compensated:
    X_norm = (X - center) / scale, so T_norm = T . diag(scale) + R.center.
    """
    v = mesh.verts[: mesh.num_verts]
    lo, hi = v.min(0), v.max(0)
    center = (lo + hi) / 2.0
    scale = float(np.linalg.norm(hi - lo))
    verts = (mesh.verts - center) / scale
    return (
        TriMesh(verts.astype(np.float32), mesh.faces, mesh.vert_colors,
                mesh.num_verts, mesh.num_faces),
        center.astype(np.float32),
        scale,
    )


def decimate_mesh(mesh: TriMesh, max_faces: int, seed: int = 0) -> TriMesh:
    """Cheap decimation: uniformly subsample faces to a budget.

    Only suitable for synthetic fixtures (leaves pinholes in the surface).
    Real data paths must use `simplify_mesh`, which preserves a watertight
    surface (reference rasterizes the full PyTorch3D mesh,
    `geometry/diff_render_optim.py:269-325`; we instead simplify once at load
    to a static budget).
    """
    if mesh.num_faces <= max_faces:
        return mesh
    rs = np.random.RandomState(seed)
    keep = rs.choice(mesh.num_faces, max_faces, replace=False)
    keep.sort()
    return TriMesh(mesh.verts, mesh.faces[keep], mesh.vert_colors,
                   mesh.num_verts, max_faces)


def _cluster_simplify_once(
    verts: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray,
    res: int,
) -> TriMesh:
    """One vertex-clustering pass at grid resolution `res` (cells along the
    longest bbox axis), with quadric-optimal vertex placement.

    Out-of-core-style clustering (Lindstrom 2000): vertices are binned on a
    uniform grid; each occupied cell collapses to the point minimizing the
    sum of squared distances to the incident faces' planes (its quadric),
    falling back to the cell mean when the quadric is ill-conditioned. Faces
    with two corners in the same cell become degenerate and are dropped;
    duplicated triangles are deduplicated. Unlike random face deletion this
    keeps the surface closed: every surviving patch of surface stays
    connected through its cluster vertices.
    """
    lo, hi = verts.min(0), verts.max(0)
    extent = float(np.max(hi - lo))
    cell = max(extent / max(res, 1), 1e-12)
    gid = np.floor((verts - lo) / cell).astype(np.int64)
    gid = np.clip(gid, 0, res - 1)
    key = (gid[:, 0] * res + gid[:, 1]) * res + gid[:, 2]
    uniq, cluster = np.unique(key, return_inverse=True)
    n_clusters = len(uniq)

    # --- per-cluster mean position / color -------------------------------
    cnt = np.bincount(cluster, minlength=n_clusters).astype(np.float64)
    mean = np.stack(
        [np.bincount(cluster, verts[:, i], minlength=n_clusters) for i in range(3)],
        axis=-1,
    ) / cnt[:, None]
    col = np.stack(
        [np.bincount(cluster, colors[:, i], minlength=n_clusters) for i in range(3)],
        axis=-1,
    ) / cnt[:, None]

    # --- per-cluster plane quadrics (area-weighted) -----------------------
    # Q = sum_f w_f * [nn^T, d*n; d*n^T, d^2] over faces touching the cluster.
    A = np.zeros((n_clusters, 3, 3), np.float64)
    b = np.zeros((n_clusters, 3), np.float64)
    if len(faces):
        p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        n = np.cross(p1 - p0, p2 - p0)
        area2 = np.linalg.norm(n, axis=-1)
        w = area2 / 2.0
        n = n / np.maximum(area2[:, None], 1e-20)
        d = -np.einsum("fi,fi->f", n, p0)
        fA = w[:, None, None] * n[:, :, None] * n[:, None, :]   # (F,3,3)
        fb = w[:, None] * d[:, None] * n                        # (F,3)
        for corner in range(3):
            cidx = cluster[faces[:, corner]]
            np.add.at(A, cidx, fA)
            np.add.at(b, cidx, fb)

    # --- quadric-optimal placement, guarded ------------------------------
    # Minimize x^T A x + 2 b^T x  =>  A x = -b; regularize toward the mean so
    # flat/degenerate quadrics stay put: (A + eps*tr(A)/3 I)(x - m) = -(b + A m).
    tr = np.trace(A, axis1=1, axis2=2)
    eps = 1e-3 * np.maximum(tr, 1e-20) / 3.0
    Areg = A + eps[:, None, None] * np.eye(3)
    rhs = -(b + np.einsum("cij,cj->ci", A, mean))
    try:
        delta = np.linalg.solve(Areg, rhs[..., None])[..., 0]
    except np.linalg.LinAlgError:
        delta = np.zeros_like(mean)
    # Keep the solution inside its cell neighborhood (guards sliver quadrics).
    delta = np.clip(delta, -cell, cell)
    pos = np.where(np.isfinite(delta).all(-1, keepdims=True), mean + delta, mean)

    # --- remap faces, drop degenerates, dedup -----------------------------
    if len(faces):
        fmap = cluster[faces]
        nondeg = (
            (fmap[:, 0] != fmap[:, 1])
            & (fmap[:, 1] != fmap[:, 2])
            & (fmap[:, 0] != fmap[:, 2])
        )
        fmap = fmap[nondeg]
        srt = np.sort(fmap, axis=1)
        _, first = np.unique(srt, axis=0, return_index=True)
        fmap = fmap[np.sort(first)]
    else:
        fmap = np.zeros((0, 3), np.int64)

    return TriMesh(
        pos.astype(np.float32),
        fmap.astype(np.int32),
        np.clip(col, 0.0, 1.0).astype(np.float32),
    )


def orient_faces_outward(mesh: TriMesh) -> TriMesh:
    """Repair face winding: consistent orientation per connected component,
    then flip components whose signed volume is negative (outward normals).

    Host-side, once at load. Enables the refiner's backface-culled raster
    sweep (`RefinerConfig.backface_cull`), which assumes consistently-wound
    outward faces. BFS over the shared-edge adjacency; O(F log F).
    """
    v = mesh.verts[: mesh.num_verts]
    f = mesh.faces[: mesh.num_faces].copy()
    F = len(f)
    if F == 0:
        return mesh

    # Edge -> incident faces map (undirected keys, directed use recorded).
    edge_faces = collections.defaultdict(list)
    for fi in range(F):
        a, b, c = f[fi]
        for (p, q) in ((a, b), (b, c), (c, a)):
            key = (p, q) if p < q else (q, p)
            edge_faces[key].append((fi, p < q))  # (face, used-in-key-order)

    visited = np.zeros(F, bool)
    flip = np.zeros(F, bool)

    for seed in range(F):
        if visited[seed]:
            continue
        comp = [seed]
        visited[seed] = True
        queue = collections.deque([seed])
        while queue:
            fi = queue.popleft()
            a, b, c = f[fi]
            tri = ((a, b), (b, c), (c, a))
            if flip[fi]:
                tri = ((b, a), (c, b), (a, c))
            for (p, q) in tri:
                key = (p, q) if p < q else (q, p)
                for fj, _ in edge_faces[key]:
                    if fj == fi or visited[fj]:
                        continue
                    aj, bj, cj = f[fj]
                    trij = ((aj, bj), (bj, cj), (cj, aj))
                    # Consistent orientation: the shared edge must appear in
                    # OPPOSITE directions in the two faces. (p, q) is fi's
                    # EFFECTIVE direction (flip-adjusted above), so fj flips
                    # iff its stored winding carries the edge the same way.
                    flip[fj] = (p, q) in trij
                    visited[fj] = True
                    comp.append(fj)
                    queue.append(fj)
        # Outward test per component: signed volume about the centroid.
        comp = np.asarray(comp)
        fc = f[comp]
        swap = flip[comp]
        p0, p1, p2 = v[fc[:, 0]], v[fc[:, 1]], v[fc[:, 2]]
        p1s = np.where(swap[:, None], p2, p1)
        p2s = np.where(swap[:, None], p1, p2)
        ctr = (p0.mean(0) + p1s.mean(0) + p2s.mean(0)) / 3.0
        vol = np.einsum(
            "fi,fi->f", p0 - ctr, np.cross(p1s - ctr, p2s - ctr)
        ).sum()
        if vol < 0:
            flip[comp] = ~flip[comp]

    out = f.copy()
    out[flip] = out[flip][:, [0, 2, 1]]
    return TriMesh(mesh.verts, out.astype(np.int32), mesh.vert_colors,
                   mesh.num_verts, mesh.num_faces)


def simplify_mesh(mesh: TriMesh, max_verts: int, max_faces: int) -> TriMesh:
    """Simplify to fit (max_verts, max_faces) via vertex clustering.

    Binary-searches the finest grid resolution whose clustered mesh fits both
    budgets, so the output uses as much of the budget as possible. Replaces
    the reference's implicit "rasterize the full mesh" (PyTorch3D handles
    arbitrary F) with a static face budget that keeps the surface
    watertight — no interior holes in the rendered mask.
    """
    v = mesh.verts[: mesh.num_verts]
    f = mesh.faces[: mesh.num_faces]
    c = mesh.vert_colors[: mesh.num_verts]
    if mesh.num_verts <= max_verts and mesh.num_faces <= max_faces:
        return TriMesh(v, f, c)

    lo_res, hi_res = 1, 512
    best: Optional[TriMesh] = None
    while lo_res <= hi_res:
        mid = (lo_res + hi_res) // 2
        out = _cluster_simplify_once(v, f, c, mid)
        if out.num_verts <= max_verts and out.num_faces <= max_faces:
            best = out
            lo_res = mid + 1
        else:
            hi_res = mid - 1
    if best is None:  # even res=1 over budget (can't happen for sane budgets)
        best = _cluster_simplify_once(v, f, c, 1)
    return best


def _morton_face_order(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Spatial (Morton/Z-curve) ordering of faces by centroid.

    The raster kernel culls faces in fixed chunks per pixel tile; with
    spatially-coherent face ids each chunk's screen bbox is tight, so a tile
    sweeps far fewer chunks. Subdivision or file order typically scatters
    nearby faces across the id space.
    """
    if len(faces) == 0:
        return np.arange(0, dtype=np.int64)
    cent = verts[faces].mean(axis=1)
    mn, mx = cent.min(0), cent.max(0)
    q = ((cent - mn) / np.maximum(mx - mn, 1e-9) * 1023.0).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x

    code = (
        (spread(q[:, 0]).astype(np.uint64) << 2)
        | (spread(q[:, 1]).astype(np.uint64) << 1)
        | spread(q[:, 2]).astype(np.uint64)
    )
    return np.argsort(code, kind="stable")


def pad_mesh(mesh: TriMesh, num_verts: int, num_faces: int) -> TriMesh:
    """Pad to static sizes. Padded faces are degenerate (all-zero index) and
    point at vertex 0; padded verts sit at the origin. If the vertex budget
    truncates the mesh, faces referencing dropped vertices are removed.
    Real faces are re-ordered along a Morton curve (see `_morton_face_order`)."""
    v = np.zeros((num_verts, 3), np.float32)
    c = np.zeros((num_verts, 3), np.float32)
    f = np.zeros((num_faces, 3), np.int32)
    nv = min(mesh.num_verts, num_verts)
    v[:nv] = mesh.verts[:nv]
    c[:nv] = mesh.vert_colors[:nv]
    faces_ok = mesh.faces[: mesh.num_faces]
    faces_ok = faces_ok[(faces_ok < nv).all(axis=1)]
    faces_ok = faces_ok[_morton_face_order(v, faces_ok)]
    nf = min(len(faces_ok), num_faces)
    f[:nf] = faces_ok[:nf]
    return TriMesh(v, f, c, nv, nf)
