"""Rigged avatar export: skeleton, GLB (glTF binary) and FBX ASCII.

Twin of avatarclip_tpu/export/rigged.py (reference: Avatar2FBX/
export_fbx.py:31-138, utils/fbx_utils.py): simplify the extracted mesh,
transfer SMPL blend weights, un-pose it to the rest pose (export/drive.py,
on ``device``: the card unless the caller asks for the CPU) and write a
rigged asset with the 24-joint mixamorig-named skeleton over the SMPL tree
(fbx_utils.py:12-63). The GLB can carry a baked motion (one rotation channel
a joint) and morph targets; the FBX ASCII 7.3 writer stands in for the
reference's C++ FBX SDK. Both writers are host serialization and write the
JAX package's files but for the generator name.
"""

from __future__ import annotations

import json
import struct
import time

import numpy as np
import torch

from .. import assets
from ..body import lbs as lbs_mod
from ..body import rotations
from ..body.smpl import SMPL_PARENTS
from ..utils import device as device_mod
from . import drive as drive_mod
from . import mesh_io, meshops

# mixamorig joint naming over the SMPL tree (fbx_utils.py:38-63)
MIXAMO_NAMES = [
    "mixamorig:Hips", "mixamorig:LeftUpLeg", "mixamorig:RightUpLeg",
    "mixamorig:Spine", "mixamorig:LeftLeg", "mixamorig:RightLeg",
    "mixamorig:Spine1", "mixamorig:LeftFoot", "mixamorig:RightFoot",
    "mixamorig:Spine2", "mixamorig:LeftToeBase", "mixamorig:RightToeBase",
    "mixamorig:Neck", "mixamorig:LeftShoulder", "mixamorig:RightShoulder",
    "mixamorig:Head", "mixamorig:LeftArm", "mixamorig:RightArm",
    "mixamorig:LeftForeArm", "mixamorig:RightForeArm", "mixamorig:LeftHand",
    "mixamorig:RightHand", "mixamorig:LeftHandMiddle1",
    "mixamorig:RightHandMiddle1",
]


def prepare_rigged_avatar(mesh_ply: str, smpl_path: str | None = None, simplify: bool = True,
                          device=None, timing: dict | None = None):
    """PLY -> (rest-pose verts, faces, colours, weights (V, 24), rest joints
    (24, 3)), as export_fbx.py:31-89: read, keep the largest island,
    simplify by vertex clustering, transfer weights from the stand-posed
    template, inverse LBS to the rest pose."""
    timing = {} if timing is None else timing
    t0 = time.perf_counter()
    verts, faces, colors = mesh_io.read_ply(mesh_ply)
    timing["mesh_vertices"] = len(verts)
    verts, faces, colors = meshops.largest_component(verts @ drive_mod.WORLD_TO_BODY.T, faces,
                                                     colors)
    if simplify:
        verts, faces, colors = meshops.cluster_simplify(verts, faces, attrs=colors)
    timing["read_cleanup_simplify_s"] = time.perf_counter() - t0
    timing["vertices"] = len(verts)
    smpl = assets.load_smpl(smpl_path)
    rest_rot = drive_mod._rot_mats(assets.load_stand_pose().reshape(1, 72))
    t0 = time.perf_counter()
    tpose, weights = drive_mod.retarget_mesh(verts, smpl, rest_rot, device=device, timing=timing)
    weights = weights.cpu().numpy()
    timing["retarget_s"] = time.perf_counter() - t0
    joints = lbs_mod.vertices2joints(smpl.J_regressor, smpl.v_template[None])[0].numpy()
    return tpose, faces, colors, weights, joints


def _top4_weights(weights: np.ndarray):
    """(V, 24) -> (joints (V,4) u16, weights (V,4) f32 normalized)."""
    idx = np.argsort(-weights, axis=1)[:, :4]
    w = np.take_along_axis(weights, idx, axis=1)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-9)
    return idx.astype(np.uint16), w.astype(np.float32)


# ---------------------------------------------------------------------------
# GLB writer
# ---------------------------------------------------------------------------


def write_glb(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None,
    weights: np.ndarray,
    joints_rest: np.ndarray,
    joint_names: list[str] = MIXAMO_NAMES,
    parents: np.ndarray = SMPL_PARENTS,
    motion_rots: np.ndarray | None = None,  # (T, 24, 3, 3) per-frame rotations
    fps: float = 30.0,
    blendshapes: list[tuple[str, np.ndarray]] | None = None,
) -> None:
    """Rigged GLB; with ``motion_rots`` the motion is baked in as a glTF
    animation (rotation channel per joint) — one self-contained animated
    avatar file, beyond the reference's static FBX + separate .pc2.

    ``blendshapes`` is a list of (name, (V, 3) position offsets) emitted as
    glTF morph targets — the counterpart of the reference's FBX blendshape
    channel (fbx_utils.py:277-292 AddShape)."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.uint32)
    j_idx, j_w = _top4_weights(weights)

    buffers = []

    def add(data: np.ndarray, target=None):
        data = np.ascontiguousarray(data)
        offset = sum(len(b) for b, _ in buffers)
        pad = (-offset) % 4
        if pad:
            buffers[-1] = (buffers[-1][0] + b"\x00" * pad, buffers[-1][1])
            offset += pad
        buffers.append((data.tobytes(), target))
        return len(buffers) - 1, offset, data.nbytes

    accessors = []
    buffer_views = []

    def accessor(data, ctype, comp, count, target=None, minmax=False):
        _, offset, nbytes = add(data, target)
        buffer_views.append(
            {
                "buffer": 0,
                "byteOffset": offset,
                "byteLength": nbytes,
                **({"target": target} if target else {}),
            }
        )
        acc = {
            "bufferView": len(buffer_views) - 1,
            "componentType": ctype,
            "count": count,
            "type": comp,
        }
        if minmax:
            acc["min"] = np.asarray(data).reshape(count, -1).min(0).tolist()
            acc["max"] = np.asarray(data).reshape(count, -1).max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    V = len(verts)
    a_pos = accessor(verts, 5126, "VEC3", V, target=34962, minmax=True)
    attr = {"POSITION": a_pos}
    if colors is not None:
        col = np.ascontiguousarray(
            np.asarray(colors, np.float32)[:, :3]
            / (255.0 if colors.dtype == np.uint8 else 1.0),
            np.float32,
        )
        attr["COLOR_0"] = accessor(col, 5126, "VEC3", V, target=34962)
    attr["JOINTS_0"] = accessor(j_idx, 5123, "VEC4", V, target=34962)
    attr["WEIGHTS_0"] = accessor(j_w, 5126, "VEC4", V, target=34962)
    a_idx = accessor(faces.reshape(-1), 5125, "SCALAR", faces.size, target=34963)

    # inverse bind matrices: translate(-joint) in column-major
    ibm = np.tile(np.eye(4, dtype=np.float32), (24, 1, 1))
    ibm[:, :3, 3] = -joints_rest
    ibm_cm = np.ascontiguousarray(np.transpose(ibm, (0, 2, 1)))
    a_ibm = accessor(ibm_cm, 5126, "MAT4", 24)

    # nodes: 0 = mesh, 1..24 = joints
    nodes = [{"name": "avatar", "mesh": 0, "skin": 0}]
    for j in range(24):
        p = parents[j]
        local = joints_rest[j] - (joints_rest[p] if p >= 0 else 0.0)
        nodes.append(
            {"name": joint_names[j], "translation": np.asarray(local, np.float64).tolist()}
        )
    for j in range(24):
        p = parents[j]
        if p >= 0:
            nodes[1 + p].setdefault("children", []).append(1 + j)

    animations = []
    if motion_rots is not None:
        T = motion_rots.shape[0]
        times = np.arange(T, dtype=np.float32) / fps
        a_time = accessor(times, 5126, "SCALAR", T, minmax=True)
        quats = rotations.matrix_to_quaternion(
            torch.as_tensor(np.asarray(motion_rots), dtype=torch.float32)
        ).numpy()  # (T, 24, 4) wxyz
        # glTF quaternions are xyzw
        quats = np.concatenate([quats[..., 1:], quats[..., :1]], axis=-1)
        channels, samplers = [], []
        for j in range(24):
            a_rot = accessor(
                np.ascontiguousarray(quats[:, j], np.float32), 5126, "VEC4", T
            )
            samplers.append(
                {"input": a_time, "output": a_rot, "interpolation": "LINEAR"}
            )
            channels.append(
                {
                    "sampler": len(samplers) - 1,
                    "target": {"node": 1 + j, "path": "rotation"},
                }
            )
        animations = [
            {"name": "motion", "channels": channels, "samplers": samplers}
        ]

    primitive = {"attributes": attr, "indices": a_idx, "mode": 4}
    mesh = {"primitives": [primitive]}
    if blendshapes:
        primitive["targets"] = [
            {
                "POSITION": accessor(
                    np.ascontiguousarray(off, np.float32), 5126, "VEC3", V,
                    target=34962, minmax=True,
                )
            }
            for _, off in blendshapes
        ]
        mesh["weights"] = [0.0] * len(blendshapes)
        mesh["extras"] = {"targetNames": [n for n, _ in blendshapes]}

    gltf = {
        "asset": {"version": "2.0", "generator": "avatarclip_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": nodes,
        "meshes": [mesh],
        "skins": [
            {
                "inverseBindMatrices": a_ibm,
                "joints": list(range(1, 25)),
                "skeleton": 1,
            }
        ],
        "accessors": accessors,
        "bufferViews": buffer_views,
    }
    if animations:
        gltf["animations"] = animations

    bin_data = b"".join(b for b, _ in buffers)
    bin_data += b"\x00" * ((-len(bin_data)) % 4)
    gltf["buffers"] = [{"byteLength": len(bin_data)}]

    json_data = json.dumps(gltf).encode()
    json_data += b" " * ((-len(json_data)) % 4)

    with open(path, "wb") as f:
        total = 12 + 8 + len(json_data) + 8 + len(bin_data)
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_data), 0x4E4F534A))
        f.write(json_data)
        f.write(struct.pack("<II", len(bin_data), 0x004E4942))
        f.write(bin_data)


def read_glb(path: str):
    """Parse a GLB back into (json_dict, bin_bytes) — used for validation."""
    with open(path, "rb") as f:
        magic, version, _ = struct.unpack("<III", f.read(12))
        assert magic == 0x46546C67 and version == 2
        ln, ty = struct.unpack("<II", f.read(8))
        assert ty == 0x4E4F534A
        js = json.loads(f.read(ln))
        ln, ty = struct.unpack("<II", f.read(8))
        assert ty == 0x004E4942
        bin_data = f.read(ln)
    return js, bin_data


# ---------------------------------------------------------------------------
# FBX ASCII writer (7.3 subset)
# ---------------------------------------------------------------------------


def write_fbx_ascii(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray,
    colors: np.ndarray | None,
    weights: np.ndarray,
    joints_rest: np.ndarray,
    joint_names: list[str] = MIXAMO_NAMES,
    parents: np.ndarray = SMPL_PARENTS,
    blendshapes: list[tuple[str, np.ndarray]] | None = None,
) -> None:
    """Minimal rigged FBX ASCII: mesh + per-vertex colors + LimbNode skeleton
    + skin clusters binding the SMPL weights (the fbx_utils.py:93-320 scene
    contract, serialized directly instead of through the C++ FBX SDK).

    ``blendshapes`` is a list of (channel name, (V, 3) position offsets)
    serialized as a BlendShape deformer with one BlendShapeChannel + Shape
    geometry per entry — the fbx_utils.py:277-292 ``AddShape`` contract
    (whose single channel carries all-zero offsets; pass
    ``[("ShapeChannel0", np.zeros((V, 3)))]`` for bit-parity)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    V, J = len(verts), 24

    uid = iter(range(1_000_000, 9_000_000))
    geom_id = next(uid)
    model_id = next(uid)
    skin_id = next(uid)
    joint_model_ids = [next(uid) for _ in range(J)]
    joint_attr_ids = [next(uid) for _ in range(J)]
    cluster_ids = [next(uid) for _ in range(J)]
    blendshapes = blendshapes or []
    bshape_id = next(uid) if blendshapes else None
    channel_ids = [next(uid) for _ in blendshapes]
    shape_geom_ids = [next(uid) for _ in blendshapes]

    def fmt_list(arr, per_line=12):
        arr = np.asarray(arr).reshape(-1)
        return ",".join(
            f"{x:.6f}" if isinstance(x, (float, np.floating)) else str(int(x))
            for x in arr
        )

    poly = faces.copy()
    poly[:, 2] = -poly[:, 2] - 1  # FBX end-of-polygon marker

    lines = []
    w = lines.append
    w("; FBX 7.3.0 project file")
    w("; generated by avatarclip_torch")
    w("FBXHeaderExtension:  {")
    w("\tFBXHeaderVersion: 1003")
    w("\tFBXVersion: 7300")
    w("}")
    w("GlobalSettings:  {")
    w("\tVersion: 1000")
    w("}")
    w("Definitions:  {")
    w("\tVersion: 100")
    w(f"\tCount: {2 + 2 * J + 2}")
    w("}")
    w("Objects:  {")

    # geometry
    w(f'\tGeometry: {geom_id}, "Geometry::avatar", "Mesh" {{')
    w(f"\t\tVertices: *{verts.size} {{")
    w(f"\t\t\ta: {fmt_list(verts.astype(np.float64))}")
    w("\t\t}")
    w(f"\t\tPolygonVertexIndex: *{poly.size} {{")
    w(f"\t\t\ta: {fmt_list(poly)}")
    w("\t\t}")
    w("\t\tGeometryVersion: 124")
    if colors is not None:
        col = np.asarray(colors, np.float64)[:, :3]
        if colors.dtype == np.uint8:
            col = col / 255.0
        rgba = np.concatenate([col, np.ones((V, 1))], axis=1)
        w("\t\tLayerElementColor: 0 {")
        w("\t\t\tVersion: 101")
        w('\t\t\tName: "VertexColors"')
        w('\t\t\tMappingInformationType: "ByVertice"')
        w('\t\t\tReferenceInformationType: "Direct"')
        w(f"\t\t\tColors: *{rgba.size} {{")
        w(f"\t\t\t\ta: {fmt_list(rgba)}")
        w("\t\t\t}")
        w("\t\t}")
        w("\t\tLayer: 0 {")
        w("\t\t\tVersion: 100")
        w("\t\t\tLayerElement:  {")
        w('\t\t\t\tType: "LayerElementColor"')
        w("\t\t\t\tTypedIndex: 0")
        w("\t\t\t}")
        w("\t\t}")
    w("\t}")

    # mesh model
    w(f'\tModel: {model_id}, "Model::avatar", "Mesh" {{')
    w("\t\tVersion: 232")
    w("\t}")

    # skeleton limb nodes with local translations
    for j in range(J):
        p = parents[j]
        local = joints_rest[j] - (joints_rest[p] if p >= 0 else 0.0)
        w(
            f'\tNodeAttribute: {joint_attr_ids[j]}, '
            f'"NodeAttribute::{joint_names[j]}", "LimbNode" {{'
        )
        w('\t\tTypeFlags: "Skeleton"')
        w("\t}")
        w(
            f'\tModel: {joint_model_ids[j]}, "Model::{joint_names[j]}", '
            '"LimbNode" {'
        )
        w("\t\tVersion: 232")
        w("\t\tProperties70:  {")
        w(
            f'\t\t\tP: "Lcl Translation", "Lcl Translation", "", "A",'
            f"{local[0]:.6f},{local[1]:.6f},{local[2]:.6f}"
        )
        w("\t\t}")
        w("\t}")

    # skin + clusters
    w(f'\tDeformer: {skin_id}, "Deformer::skin", "Skin" {{')
    w("\t\tVersion: 101")
    w("\t}")
    for j in range(J):
        wj = weights[:, j]
        idx = np.nonzero(wj > 1e-6)[0]
        w(
            f'\tDeformer: {cluster_ids[j]}, '
            f'"SubDeformer::{joint_names[j]}", "Cluster" {{'
        )
        w("\t\tVersion: 100")
        if len(idx):
            w(f"\t\tIndexes: *{len(idx)} {{")
            w(f"\t\t\ta: {fmt_list(idx)}")
            w("\t\t}")
            w(f"\t\tWeights: *{len(idx)} {{")
            w(f"\t\t\ta: {fmt_list(wj[idx].astype(np.float64))}")
            w("\t\t}")
        tf = np.eye(4)
        tf[:3, 3] = joints_rest[j]
        w(f"\t\tTransform: *16 {{")
        w(f"\t\t\ta: {fmt_list(np.linalg.inv(tf).T)}")
        w("\t\t}")
        w(f"\t\tTransformLink: *16 {{")
        w(f"\t\t\ta: {fmt_list(tf.T)}")
        w("\t\t}")
        w("\t}")

    # blendshape deformer (fbx_utils.py:277-292 AddShape): only vertices with
    # a nonzero offset are listed (FBX shapes are sparse); an all-zero channel
    # degenerates to an empty index list, exactly like the reference's stub
    if blendshapes:
        w(f'\tDeformer: {bshape_id}, "Deformer::BlendShapes", "BlendShape" {{')
        w("\t\tVersion: 100")
        w("\t}")
        for ci, (name, off) in enumerate(blendshapes):
            off = np.asarray(off, np.float64).reshape(V, 3)
            nz = np.nonzero(np.abs(off).sum(axis=1) > 0.0)[0]
            w(
                f'\tDeformer: {channel_ids[ci]}, "SubDeformer::{name}", '
                '"BlendShapeChannel" {'
            )
            w("\t\tVersion: 100")
            w("\t\tDeformPercent: 0")
            w("\t\tFullWeights: *1 {")
            w("\t\t\ta: 100")
            w("\t\t}")
            w("\t}")
            w(
                f'\tGeometry: {shape_geom_ids[ci]}, "Geometry::{name}", '
                '"Shape" {'
            )
            w("\t\tVersion: 100")
            w(f"\t\tIndexes: *{len(nz)} {{")
            w(f"\t\t\ta: {fmt_list(nz)}")
            w("\t\t}")
            w(f"\t\tVertices: *{3 * len(nz)} {{")
            w(f"\t\t\ta: {fmt_list(off[nz])}")
            w("\t\t}")
            w("\t}")
    w("}")

    # connections
    w("Connections:  {")
    w(f"\tC: \"OO\",{geom_id},{model_id}")
    w(f"\tC: \"OO\",{model_id},0")
    w(f"\tC: \"OO\",{joint_model_ids[0]},0")
    for j in range(J):
        w(f"\tC: \"OO\",{joint_attr_ids[j]},{joint_model_ids[j]}")
        p = parents[j]
        if p >= 0:
            w(f"\tC: \"OO\",{joint_model_ids[j]},{joint_model_ids[p]}")
    w(f"\tC: \"OO\",{skin_id},{geom_id}")
    for j in range(J):
        w(f"\tC: \"OO\",{cluster_ids[j]},{skin_id}")
        w(f"\tC: \"OO\",{joint_model_ids[j]},{cluster_ids[j]}")
    if blendshapes:
        w(f"\tC: \"OO\",{bshape_id},{geom_id}")
        for ci in range(len(blendshapes)):
            w(f"\tC: \"OO\",{channel_ids[ci]},{bshape_id}")
            w(f"\tC: \"OO\",{shape_geom_ids[ci]},{channel_ids[ci]}")
    w("}")

    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def export_rigged(mesh_ply: str, out_path: str, smpl_path: str | None = None,
                  simplify: bool = True, motion_npy: str | None = None, fps: float = 30.0,
                  blendshape_stub: bool = False, device=None, timing: dict | None = None):
    """PLY -> rigged .glb / .fbx (export_fbx.py:31-138). With ``motion_npy``
    (an AvatarAnimate motion) and a .glb target the motion is baked in as a
    glTF animation; ``blendshape_stub`` adds the reference's single
    zero-offset blendshape channel (fbx_utils.py:277-292 AddShape)."""
    if not out_path.endswith((".glb", ".fbx")):
        raise ValueError("out_path must end in .glb or .fbx")
    dev = device_mod.resolve(device, "rigged export")
    timing = {} if timing is None else timing
    tpose, faces, colors, weights, joints = prepare_rigged_avatar(
        mesh_ply, smpl_path=smpl_path, simplify=simplify, device=dev, timing=timing)
    blendshapes = None
    if blendshape_stub:
        blendshapes = [("ShapeChannel0", np.zeros((len(tpose), 3), np.float32))]
    t0 = time.perf_counter()
    if out_path.endswith(".glb"):
        motion_rots = None if motion_npy is None else drive_mod.read_motion_npy(motion_npy)
        write_glb(out_path, tpose, faces, colors, weights, joints, motion_rots=motion_rots,
                  fps=fps, blendshapes=blendshapes)
    else:
        write_fbx_ascii(out_path, tpose, faces, colors, weights, joints, blendshapes=blendshapes)
    timing["write_s"] = time.perf_counter() - t0
    return out_path


def main(argv=None) -> dict:
    """The CLI; returns the phase seconds and counts it prints."""
    import argparse

    parser = argparse.ArgumentParser(description="Avatar2FBX (PyTorch)")
    parser.add_argument("--ply", type=str, required=True)
    parser.add_argument("--out", type=str, required=True, help=".glb or .fbx")
    parser.add_argument("--smpl_model_folder", type=str, default=None)
    parser.add_argument("--no_simplify", action="store_true")
    parser.add_argument("--motion", type=str, default=None,
                        help="motion .npy to bake as a glTF animation")
    parser.add_argument("--fps", type=float, default=30.0)
    parser.add_argument("--blendshape_stub", action="store_true",
                        help="add the reference's zero-offset blendshape channel (fbx_utils.py AddShape)")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    timing: dict = {}
    export_rigged(args.ply, args.out, smpl_path=args.smpl_model_folder,
                  simplify=not args.no_simplify, motion_npy=args.motion, fps=args.fps,
                  blendshape_stub=args.blendshape_stub, device=args.device, timing=timing)
    print("[rigged] " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                  for k, v in timing.items()))
    return timing


if __name__ == "__main__":
    main()
