"""Mesh files without dependencies: OBJ, PLY (binary and ASCII reading) and
``.pc2`` point caches (the port's own copy of the JAX package's
``export/mesh_io.py``)."""

from __future__ import annotations

import struct

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


def write_obj(path: str, V, F, Vt=None, Ft=None) -> None:
    """Write an OBJ file (vertices and optional UVs) in the reference layout."""
    with open(path, "w") as f:
        for v in np.asarray(V):
            f.write("v " + " ".join(str(float(x)) for x in v) + "\n")
        if Vt is not None:
            for vt in np.asarray(Vt):
                f.write("vt " + " ".join(str(float(x)) for x in vt) + "\n")
        for i, face in enumerate(F):
            if Ft is not None:
                toks = [f"{int(a) + 1}/{int(b) + 1}" for a, b in zip(face, Ft[i])]
            else:
                toks = [str(int(a) + 1) for a in face]
            f.write("f " + " ".join(toks) + "\n")


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


_PLY_TYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: str):
    """Read a triangle PLY (binary little-endian or ASCII) -> (vertices f32
    (n, 3), faces i32 (m, 3), uint8 colours (n, 3) or None)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError("not a PLY file")
    header = data[:end].decode("ascii").splitlines()
    body = data[end + len(b"end_header\n"):]
    fmt, n_vert, n_face, cur = "ascii", 0, 0, None
    vert_props: list[tuple[str, str]] = []
    for line in header:
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "format":
            fmt = toks[1]
        elif toks[0] == "element":
            cur = toks[1]
            if cur == "vertex":
                n_vert = int(toks[2])
            elif cur == "face":
                n_face = int(toks[2])
        elif toks[0] == "property" and cur == "vertex" and toks[1] != "list":
            vert_props.append((toks[2], toks[1]))
    names = [p[0] for p in vert_props]
    if fmt == "ascii":
        text = body.decode("ascii").split("\n")
        vals = np.array([[float(x) for x in text[i].split()] for i in range(n_vert)], np.float32)
        xyz = vals[:, [names.index(c) for c in "xyz"]]
        colors = None
        if "red" in names:
            colors = vals[:, [names.index(c) for c in ("red", "green", "blue")]].astype(np.uint8)
        faces = np.array([[int(x) for x in text[n_vert + i].split()[1:4]] for i in range(n_face)],
                         np.int32)
        return xyz.astype(np.float32), faces, colors
    dtype = np.dtype([(name, _PLY_TYPES[t]) for name, t in vert_props])
    vrec = np.frombuffer(body, dtype=dtype, count=n_vert)
    xyz = np.stack([vrec["x"], vrec["y"], vrec["z"]], axis=-1).astype(np.float32)
    colors = None
    if "red" in names:
        colors = np.stack([vrec["red"], vrec["green"], vrec["blue"]], axis=-1).astype(np.uint8)
    frec = np.frombuffer(body[dtype.itemsize * n_vert:],
                         dtype=np.dtype([("n", "u1"), ("idx", "<i4", 3)]), count=n_face)
    return xyz, frec["idx"].astype(np.int32), colors


def write_pc2(path: str, vertices_per_frame: np.ndarray, fps: float = 30.0) -> None:
    """Write a ``.pc2`` point cache (frames, V, 3): the reference writer's
    byte layout (drive.py:295-305), a 32-byte header then little-endian f32
    frames."""
    arr = np.asarray(vertices_per_frame, dtype="<f4")
    n_frames, n_points = arr.shape[0], arr.shape[1]
    with open(path, "wb") as f:
        f.write(struct.pack("<12siiffi", b"POINTCACHE2\0", 1, n_points, 0.0, 1.0 / fps * fps,
                            n_frames))
        f.write(arr.tobytes())
