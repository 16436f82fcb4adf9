"""Iso-surface extraction and mesh / volume export (torch-free numpy; the
port's own copy of ``sherf_tpu/geometry/shape.py``, which replaces the
reference's ``shape_utils.py``: ``skimage.measure.marching_cubes`` +
``plyfile`` + ``mrcfile``, none of which the port's machines have):

  * ``marching_tetrahedra`` — vectorized NumPy iso-surfacer.  Each grid cell
    is split into 6 tetrahedra around the (0,6) diagonal; every tetrahedron
    contributes 0-2 triangles with vertices linearly interpolated along the
    crossing edges.  Compared to classic marching cubes this needs no
    256-entry case table, has no ambiguous cases, and produces a watertight
    surface (at ~2x the triangle count).
  * ``convert_sdf_samples_to_ply`` — same contract as the reference
    (shape_utils.py:39-102): volume + origin + voxel size -> .ply on disk.
  * ``write_ply`` / ``read_ply`` / ``write_mrc`` / ``read_mrc`` — minimal
    binary writers and readers (PLY 1.0 binary_little_endian; MRC2014
    mode-2 float32).
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence, Tuple

import numpy as np

# Tetrahedral decomposition of the unit cube around the 0-6 diagonal.
# Corner numbering: bit 0 -> +x, bit 1 -> +y, bit 2 -> +z.
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], dtype=np.int64)
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
     [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], dtype=np.int64)

# Tet edges: pairs of local tet-vertex indices.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)

# mask (bit i set <=> tet vertex i below the iso level) -> triangles as
# triples of tet-edge ids.  Single-vertex cases emit one triangle, two-vertex
# cases emit the cut quad as two triangles.  Complement masks reuse the same
# edges with reversed winding.
_TET_TRIS = {
    0b0001: [[0, 1, 2]],
    0b0010: [[0, 4, 3]],
    0b0100: [[1, 3, 5]],
    0b1000: [[2, 5, 4]],
    0b0011: [[1, 2, 4], [1, 4, 3]],
    0b0101: [[0, 3, 5], [0, 5, 2]],
    0b1001: [[0, 4, 5], [0, 5, 1]],
    0b0110: [[0, 1, 5], [0, 5, 4]],
    0b1010: [[0, 2, 5], [0, 5, 3]],
    0b1100: [[1, 0, 4], [1, 4, 5]],
}
for _m in list(_TET_TRIS):
    _TET_TRIS[0b1111 ^ _m] = [t[::-1] for t in _TET_TRIS[_m]]


def marching_tetrahedra(volume: np.ndarray, level: float = 0.0,
                        spacing: Sequence[float] = (1.0, 1.0, 1.0),
                        origin: Sequence[float] = (0.0, 0.0, 0.0),
                        dedupe: bool = True,
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the ``volume == level`` iso-surface.

    volume: (nx, ny, nz) scalar field; axis i maps to coordinate
    origin[i] + index * spacing[i] (matching skimage.marching_cubes'
    spacing semantics used by the reference shape_utils.py:62-64).

    Returns (verts (V, 3) float32, faces (F, 3) int32).
    """
    volume = np.asarray(volume, np.float32)
    if volume.ndim != 3:
        raise ValueError(f"volume must be 3-D, got {volume.shape}")
    nx, ny, nz = volume.shape
    if min(nx, ny, nz) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # corner values for every cell: (nx-1, ny-1, nz-1, 8)
    ix, iy, iz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([ix, iy, iz], axis=-1).reshape(-1, 1, 3)  # (C, 1, 3)
    corners = base + _CUBE_CORNERS[None]                      # (C, 8, 3)
    vals = volume[corners[..., 0], corners[..., 1], corners[..., 2]]  # (C, 8)

    # drop cells the surface cannot cross
    crossing = (vals.min(1) < level) & (vals.max(1) >= level)
    corners, vals = corners[crossing], vals[crossing]
    if corners.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # expand to tets: (C, 6, 4) -> (C*6, 4)
    tet_vals = vals[:, _TETS].reshape(-1, 4)
    tet_pos = corners[:, _TETS, :].reshape(-1, 4, 3).astype(np.float32)

    below = tet_vals < level
    mask = (below * (1 << np.arange(4))).sum(1)              # (T,)

    tri_pts = []
    for m, tris in _TET_TRIS.items():
        rows = np.nonzero(mask == m)[0]
        if rows.size == 0:
            continue
        v, p = tet_vals[rows], tet_pos[rows]                  # (R,4) (R,4,3)
        # interpolated point on every tet edge (only crossed ones are used)
        a, b = _TET_EDGES[:, 0], _TET_EDGES[:, 1]
        va, vb = v[:, a], v[:, b]                             # (R, 6)
        denom = np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
        t = np.clip((level - va) / denom, 0.0, 1.0)[..., None]
        epts = p[:, a] * (1.0 - t) + p[:, b] * t              # (R, 6, 3)
        for tri in tris:
            tri_pts.append(epts[:, tri, :])                   # (R, 3, 3)

    tri = np.concatenate(tri_pts, axis=0)                     # (F, 3, 3)
    verts = tri.reshape(-1, 3)
    faces = np.arange(verts.shape[0], dtype=np.int32).reshape(-1, 3)
    if dedupe:
        # merge vertices shared between tets/cells (exact: interpolation on a
        # shared edge yields bit-identical coordinates)
        uniq, inv = np.unique(verts, axis=0, return_inverse=True)
        verts = uniq
        faces = inv.astype(np.int32).reshape(-1, 3)
        # drop degenerate triangles produced by t clipping at 0/1
        ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
              & (faces[:, 0] != faces[:, 2]))
        faces = faces[ok]

    verts = verts * np.asarray(spacing, np.float32) + np.asarray(origin,
                                                                 np.float32)
    return verts.astype(np.float32), faces


def write_ply(path: str, verts: np.ndarray,
              faces: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY (the format plyfile emits for the
    reference's meshes, shape_utils.py:85-101)."""
    verts = np.asarray(verts, np.float32)
    faces = np.zeros((0, 3), np.int32) if faces is None else np.asarray(
        faces, np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(verts.astype("<f4").tobytes())
        if len(faces):
            rec = np.empty(len(faces),
                           dtype=[("n", "u1"), ("idx", "<i4", (3,))])
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read back meshes written by :func:`write_ply` (test oracle)."""
    with open(path, "rb") as f:
        n_v = n_f = 0
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith(b"element face"):
                n_f = int(line.split()[-1])
            elif line == b"end_header":
                break
        verts = np.frombuffer(f.read(n_v * 12), "<f4").reshape(n_v, 3)
        rec = np.frombuffer(f.read(n_f * 13),
                            dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        return verts.copy(), rec["idx"].copy()


def convert_sdf_samples_to_ply(volume: np.ndarray,
                               voxel_grid_origin: Sequence[float],
                               voxel_size: float,
                               ply_filename_out: str,
                               offset: Optional[Sequence[float]] = None,
                               scale: Optional[float] = None,
                               level: float = 0.0) -> None:
    """Reference-compatible entry point (shape_utils.py:39-102): extract the
    level set of a density/SDF grid and write it as a .ply mesh."""
    verts, faces = marching_tetrahedra(np.asarray(volume), level=level,
                                       spacing=(voxel_size,) * 3,
                                       origin=voxel_grid_origin)
    if scale is not None:
        verts = verts / scale
    if offset is not None:
        verts = verts - np.asarray(offset, np.float32)
    write_ply(ply_filename_out, verts, faces)


# ---------------------------------------------------------------------------
# Minimal MRC2014 I/O (replaces mrcfile; reference writes density grids as
# .mrc in gen_samples.py/gen_videos.py --shapes and converts them via
# shape_utils.convert_mrc).
# ---------------------------------------------------------------------------

def write_mrc(path: str, volume: np.ndarray,
              voxel_size: float = 1.0) -> None:
    """MRC2014 mode-2 (float32) volume.  Data is stored z-fastest, so the
    (x, y, z)-indexed array is transposed on write — matching how the
    reference reads it back (shape_utils.py:105-107)."""
    vol = np.asarray(volume, np.float32)
    nx, ny, nz = vol.shape
    header = bytearray(1024)
    struct.pack_into("<3i", header, 0, nx, ny, nz)      # NX,NY,NZ (fast..slow)
    struct.pack_into("<i", header, 12, 2)               # MODE 2 = float32
    struct.pack_into("<3i", header, 28, nx, ny, nz)     # MX,MY,MZ
    struct.pack_into("<3f", header, 40, nx * voxel_size,
                     ny * voxel_size, nz * voxel_size)  # cell dims
    struct.pack_into("<3f", header, 52, 90.0, 90.0, 90.0)
    struct.pack_into("<3i", header, 64, 1, 2, 3)
    struct.pack_into("<3f", header, 76, float(vol.min()), float(vol.max()),
                     float(vol.mean()))
    struct.pack_into("<i", header, 88, 1)               # ISPG = 1 (volume)
    header[208:212] = b"MAP "
    header[212:216] = b"\x44\x44\x00\x00"               # little-endian stamp
    struct.pack_into("<f", header, 216, float(vol.std()))
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(np.transpose(vol, (2, 1, 0)).astype("<f4").tobytes())


def read_mrc(path: str) -> np.ndarray:
    """Read mode-2 volumes written by :func:`write_mrc`; returns (x, y, z)."""
    with open(path, "rb") as f:
        header = f.read(1024)
        nxf, nyf, nzf = struct.unpack_from("<3i", header, 0)
        mode, = struct.unpack_from("<i", header, 12)
        if mode != 2:
            raise ValueError(f"unsupported MRC mode {mode}")
        data = np.frombuffer(f.read(nzf * nyf * nxf * 4), "<f4")
    return np.transpose(data.reshape(nzf, nyf, nxf), (2, 1, 0)).copy()
