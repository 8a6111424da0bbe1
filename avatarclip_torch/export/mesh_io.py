"""Mesh files without dependencies: OBJ reading and PLY writing (the port's own
copy of ``read_obj`` and ``write_ply`` from the JAX package's
``export/mesh_io.py``)."""

from __future__ import annotations

import numpy as np


def read_obj(path: str):
    """Read an OBJ file -> (V (n, 3) f32, F list[list[int]], Vt, Ft), the
    reference ``readOBJ`` contract (AvatarGen/ShapeGen/utils.py:60-87)."""
    V, Vt, F, Ft = [], [], [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                V.append([float(x) for x in line[2:].split()])
            elif line.startswith("vt "):
                Vt.append([float(x) for x in line[3:].split()])
            elif line.startswith("f "):
                idx = [tok.split("/") for tok in line[2:].split()]
                idx = [i for i in idx if i[0] != ""]
                F.append([int(i[0]) - 1 for i in idx])
                if "/" in line:
                    Ft.append([int(i[1]) - 1 for i in idx if len(i) > 1 and i[1]])
    Vtarr = np.array(Vt, np.float32) if Vt else None
    Ftout = Ft if Ft and len(Ft) == len(F) else None
    return np.array(V, np.float32), F, Vtarr, Ftout


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              vertex_colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY mesh with optional uint8 vertex colours, the
    format of the reference's trimesh export (main.py:915-916)."""
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(vertices)}",
              "property float x", "property float y", "property float z"]
    if vertex_colors is not None:
        vertex_colors = np.asarray(vertex_colors)
        if vertex_colors.dtype != np.uint8:
            vertex_colors = (np.clip(vertex_colors, 0, 1) * 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [f"element face {len(faces)}", "property list uchar int vertex_indices",
               "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if vertex_colors is not None:
            rec = np.zeros(len(vertices), dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = vertices
            rec["rgb"] = vertex_colors[:, :3]
            f.write(rec.tobytes())
        else:
            f.write(vertices.astype("<f4").tobytes())
        frec = np.zeros(len(faces), dtype=[("n", np.uint8), ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = faces
        f.write(frec.tobytes())
