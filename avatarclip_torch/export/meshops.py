"""Host mesh utilities (twin of avatarclip_tpu/export/meshops.py): the
largest connected island, vertex-clustering decimation and the
nearest-vertex search, in ``csrc/host/mesh_ops.cpp`` (the port's copy of the
JAX package's native source) built with g++ at first use and loaded with
ctypes. They replace the reference's Open3D calls (drive.py:172-210 island
removal, Avatar2FBX/utils/ply_utils.py:16-19 simplification, drive.py:235-240
weight transfer)."""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build


def _lib():
    lib = _build.load_host("mesh_ops", "mesh_ops.cpp")
    if not getattr(lib, "_typed", False):
        fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        lib.largest_component.restype = ctypes.c_int
        lib.largest_component.argtypes = [ip, ctypes.c_int64, ctypes.c_int64,
                                          ctypes.POINTER(ctypes.c_uint8)]
        lib.cluster_simplify.restype = ctypes.c_int64
        lib.cluster_simplify.argtypes = [fp, ctypes.c_int64, ctypes.c_float, ip, fp]
        lib.nearest_neighbors.restype = None
        lib.nearest_neighbors.argtypes = [fp, ctypes.c_int64, fp, ctypes.c_int64, ip]
        lib._typed = True
    return lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def largest_component(vertices: np.ndarray, faces: np.ndarray, attrs: np.ndarray | None = None):
    """Keep only the biggest connected island (drive.py cleanup_mesh) ->
    (vertices, reindexed faces, attrs)."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    n = len(vertices)
    keep = np.zeros(n, np.uint8)
    _lib().largest_component(_ip(faces), len(faces), n,
                             keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    keep = keep.astype(bool)
    remap = -np.ones(n, np.int64)
    remap[keep] = np.arange(keep.sum())
    new_faces = remap[faces[keep[faces].all(axis=1)]].astype(np.int32)
    return vertices[keep], new_faces, attrs[keep] if attrs is not None else None


def cluster_simplify(vertices: np.ndarray, faces: np.ndarray, cell_size: float | None = None,
                     attrs: np.ndarray | None = None):
    """Vertex-clustering decimation (ply_utils.py:16-19: cell = bbox / 256) ->
    (vertices, faces, attrs): degenerate and duplicate faces dropped,
    attributes averaged per cluster."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if cell_size is None:
        cell_size = float((vertices.max(0) - vertices.min(0)).max()) / 256.0
    n = len(vertices)
    cluster_of = np.zeros(n, np.int32)
    out_verts = np.zeros((n, 3), np.float32)
    n_clusters = _lib().cluster_simplify(_fp(vertices), n, ctypes.c_float(cell_size),
                                         _ip(cluster_of), _fp(out_verts))
    nf = cluster_of[faces]
    good = (nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2]) & (nf[:, 0] != nf[:, 2])
    new_faces = nf[good].astype(np.int32)
    _, uniq = np.unique(np.sort(new_faces, axis=1), axis=0, return_index=True)
    new_faces = new_faces[np.sort(uniq)]
    new_attrs = None
    if attrs is not None:
        sums = np.zeros((n_clusters, attrs.shape[1]), np.float64)
        cnts = np.zeros(n_clusters, np.int64)
        np.add.at(sums, cluster_of, attrs)
        np.add.at(cnts, cluster_of, 1)
        new_attrs = (sums / cnts[:, None]).astype(attrs.dtype if attrs.dtype != np.uint8
                                                  else np.float64)
        if attrs.dtype == np.uint8:
            new_attrs = new_attrs.astype(np.uint8)
    return out_verts[:n_clusters].copy(), new_faces, new_attrs


def nearest_neighbors(ref: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Index of the nearest ``ref`` point for each ``query`` point (grid
    accelerated; drive.py find_nearest_ind)."""
    ref = np.ascontiguousarray(ref, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    out = np.zeros(len(query), np.int32)
    _lib().nearest_neighbors(_fp(ref), len(ref), _fp(query), len(query), _ip(out))
    return out
