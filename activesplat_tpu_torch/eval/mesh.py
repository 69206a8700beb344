"""Scene meshes for the coverage judge's GT surface, read in numpy (the JAX
package loads them with trimesh, which the machine with the card lacks).

Read:
  * PLY, ascii and binary_little_endian: float or double vertex x, y, z;
    faces as lists (uchar/char/ushort/short/uint/int counts, uint/int
    indices, any other properties skipped); polygons fanned into triangles
    (v0, vi, vi+1) as trimesh does;
  * GLB (glTF 2.0 binary): triangle primitives (mode 4), float32 POSITION,
    ubyte/uint16/uint32 indices or none, the node matrices and TRS applied
    down the default scene's tree, every primitive concatenated (what
    `trimesh.load(path, force="mesh")` returns).

Refused with a message: a GLB with `extensionsRequired` (Draco and other
compression), sparse accessors, external buffers, primitive modes other than
triangles; PLY formats other than the two above.

`sample_mesh_surface` draws area-weighted samples, uniform in each
triangle, from `np.random.default_rng(0)`: the same distribution as
trimesh's `sample`, other draws.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _fan(polygons: List[np.ndarray]) -> np.ndarray:
    """(F, 3) triangles of polygons given as index arrays, fanned from each
    polygon's first vertex."""
    tris = [np.stack([p[np.zeros(len(p) - 2, int)], p[1:-1], p[2:]], axis=1)
            for p in polygons if len(p) >= 3]
    return np.concatenate(tris, 0) if tris else np.zeros((0, 3), np.int64)


def _ply_header(blob: bytes, path: str):
    end = blob.find(b"end_header")
    if not blob.startswith(b"ply") or end < 0:
        raise ValueError(f"{path} is not a PLY file")
    body_start = blob.index(b"\n", end) + 1
    fmt, elements = None, []  # [(name, count, [(name, dtype) | (name, (count dtype, item dtype))])]
    for line in blob[:end].decode("ascii", "replace").splitlines()[1:]:
        words = line.split()
        if not words or words[0] in ("comment", "obj_info"):
            continue
        if words[0] == "format":
            fmt = words[1]
        elif words[0] == "element":
            elements.append((words[1], int(words[2]), []))
        elif words[0] == "property":
            if words[1] == "list":
                elements[-1][2].append((words[4], (_PLY_TYPES[words[2]], _PLY_TYPES[words[3]])))
            else:
                elements[-1][2].append((words[2], _PLY_TYPES[words[1]]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: PLY format {fmt!r} is not read (ascii and "
                         f"binary_little_endian are)")
    return fmt, elements, body_start


def _ply_binary_element(blob: bytes, pos: int, count: int, props) -> Tuple[Dict, int]:
    """One element's properties from a little-endian body: scalars as
    arrays, lists as (count, k) arrays where every list has k items, else
    as lists of arrays."""
    if count == 0:
        return {name: np.zeros((0,)) for name, _ in props}, pos
    # guess each list's length from the first record, then check them all
    fields, p = [], pos
    for name, t in props:
        if isinstance(t, tuple):
            k = int(np.frombuffer(blob, "<" + t[0], 1, p)[0])
            fields += [(name + "#n", "<" + t[0]), (name, "<" + t[1], (k,))]
            p += np.dtype(t[0]).itemsize + k * np.dtype(t[1]).itemsize
        else:
            fields.append((name, "<" + t))
            p += np.dtype(t).itemsize
    dtype = np.dtype(fields)
    if pos + count * dtype.itemsize <= len(blob):
        rec = np.frombuffer(blob, dtype, count, pos)
        lists = [f for f in fields if f[0].endswith("#n")]
        if all((rec[n] == rec[n[:-2]].shape[1]).all() for n, _ in lists):
            return {name: rec[name] for name, _ in props}, pos + count * dtype.itemsize
    out = {name: [] for name, _ in props}  # lists of differing lengths: record by record
    for _ in range(count):
        for name, t in props:
            if isinstance(t, tuple):
                k = int(np.frombuffer(blob, "<" + t[0], 1, pos)[0])
                pos += np.dtype(t[0]).itemsize
                out[name].append(np.frombuffer(blob, "<" + t[1], k, pos))
                pos += k * np.dtype(t[1]).itemsize
            else:
                out[name].append(np.frombuffer(blob, "<" + t, 1, pos)[0])
                pos += np.dtype(t).itemsize
    return out, pos


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) float64, triangles (F, 3) int64)."""
    with open(path, "rb") as fh:
        blob = fh.read()
    fmt, elements, pos = _ply_header(blob, path)
    data = {}
    if fmt == "ascii":
        tokens = blob[pos:].split()
        at = 0
        for name, count, props in elements:
            values = {p: [] for p, _ in props}
            for _ in range(count):
                for p, t in props:
                    if isinstance(t, tuple):
                        k = int(tokens[at])
                        values[p].append(np.array(tokens[at + 1:at + 1 + k], np.int64))
                        at += 1 + k
                    else:
                        values[p].append(float(tokens[at]))
                        at += 1
            data[name] = values
    else:
        for name, count, props in elements:
            data[name], pos = _ply_binary_element(blob, pos, count, props)
    if "vertex" not in data or "face" not in data:
        raise ValueError(f"{path}: a PLY mesh needs vertex and face elements")
    vertex = data["vertex"]
    verts = np.stack([np.asarray(vertex[c], np.float64) for c in "xyz"], axis=1)
    face = data["face"]
    key = next((k for k in ("vertex_indices", "vertex_index") if k in face), None)
    if key is None:
        raise ValueError(f"{path}: the face element has no vertex_indices list")
    faces = face[key]
    if isinstance(faces, np.ndarray) and faces.ndim == 2 and faces.shape[1] >= 3:
        # every face has k vertices: fan all of them at once, face by face
        faces = faces.astype(np.int64)
        fan = [faces[:, [0, i, i + 1]] for i in range(1, faces.shape[1] - 1)]
        return verts, np.stack(fan, axis=1).reshape(-1, 3)
    return verts, _fan([np.asarray(f, np.int64) for f in faces])


_GLB_COMPONENTS = {5121: "u1", 5123: "u2", 5125: "u4", 5126: "f4"}
_GLB_WIDTH = {"SCALAR": 1, "VEC3": 3}


def _glb_accessor(gltf: dict, binary: bytes, index: int, path: str) -> np.ndarray:
    acc = gltf["accessors"][index]
    if "sparse" in acc:
        raise ValueError(f"{path}: sparse accessors are not read")
    if "bufferView" not in acc:
        raise ValueError(f"{path}: an accessor without a bufferView is not read")
    comp = _GLB_COMPONENTS.get(acc["componentType"])
    width = _GLB_WIDTH.get(acc["type"])
    if comp is None or width is None:
        raise ValueError(f"{path}: accessor component type {acc['componentType']} of type "
                         f"{acc['type']} is not read")
    view = gltf["bufferViews"][acc["bufferView"]]
    buffer = gltf["buffers"][view["buffer"]]
    if view["buffer"] != 0 or "uri" in buffer:
        raise ValueError(f"{path}: external buffers are not read (only the GLB's own chunk)")
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    item = np.dtype("<" + comp).itemsize * width
    stride = view.get("byteStride", item)
    count = acc["count"]
    raw = np.frombuffer(binary, np.uint8, (count - 1) * stride + item if count else 0, start)
    rows = np.lib.stride_tricks.as_strided(raw, (count, item), (stride, 1)) if count else raw
    return np.ascontiguousarray(rows).view("<" + comp).reshape(count, width)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T  # column-major
    t = np.eye(4)
    t[:3, 3] = node.get("translation", (0.0, 0.0, 0.0))
    x, y, z, w = node.get("rotation", (0.0, 0.0, 0.0, 1.0))
    r = np.eye(4)
    r[:3, :3] = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    s = np.diag([*node.get("scale", (1.0, 1.0, 1.0)), 1.0])
    return t @ r @ s


def read_glb(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(vertices (V, 3) float64, triangles (F, 3) int64) of every triangle
    primitive in the default scene, in world coordinates."""
    with open(path, "rb") as fh:
        blob = fh.read()
    magic, version, _ = struct.unpack_from("<4sII", blob, 0)
    if magic != b"glTF" or version != 2:
        raise ValueError(f"{path} is not a glTF 2.0 binary (GLB) file")
    pos, gltf, binary = 12, None, b""
    while pos + 8 <= len(blob):
        length, kind = struct.unpack_from("<II", blob, pos)
        chunk = blob[pos + 8:pos + 8 + length]
        if kind == 0x4E4F534A:  # JSON
            gltf = json.loads(chunk)
        elif kind == 0x004E4942:  # BIN
            binary = chunk
        pos += 8 + length
    if gltf is None:
        raise ValueError(f"{path} has no JSON chunk")
    if gltf.get("extensionsRequired"):
        raise ValueError(f"{path} requires the glTF extensions {gltf['extensionsRequired']} "
                         f"(compressed meshes such as Draco are not read)")
    scenes = gltf.get("scenes", [])
    nodes = gltf.get("nodes", [])
    if scenes:
        roots = scenes[gltf.get("scene", 0)].get("nodes", [])
    else:  # no scene: every node that is nobody's child
        children = {c for n in nodes for c in n.get("children", [])}
        roots = [i for i in range(len(nodes)) if i not in children]
    verts, tris, base = [], [], 0
    stack = [(i, np.eye(4)) for i in roots]
    while stack:
        index, parent = stack.pop(0)
        node = nodes[index]
        world = parent @ _node_matrix(node)
        stack += [(c, world) for c in node.get("children", [])]
        if "mesh" not in node:
            continue
        for prim in gltf["meshes"][node["mesh"]]["primitives"]:
            if prim.get("mode", 4) != 4:
                raise ValueError(f"{path}: primitive mode {prim['mode']} is not read (only "
                                 f"triangles, mode 4)")
            acc = gltf["accessors"][prim["attributes"]["POSITION"]]
            if acc["componentType"] != 5126 or acc["type"] != "VEC3":
                raise ValueError(f"{path}: POSITION must be float32 VEC3")
            p = _glb_accessor(gltf, binary, prim["attributes"]["POSITION"], path)
            p = p.astype(np.float64) @ world[:3, :3].T + world[:3, 3]
            if "indices" in prim:
                idx = _glb_accessor(gltf, binary, prim["indices"], path).astype(np.int64)
            else:
                idx = np.arange(len(p), dtype=np.int64)
            verts.append(p)
            tris.append(idx.reshape(-1, 3) + base)
            base += len(p)
    if not verts:
        raise ValueError(f"{path} holds no triangle mesh")
    return np.concatenate(verts, 0), np.concatenate(tris, 0)


def read_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        return read_ply(path)
    if ext == ".glb":
        return read_glb(path)
    raise ValueError(f"{path}: only .ply and .glb meshes are read")


def sample_triangles(verts: np.ndarray, tris: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """n points, area-weighted over the triangles and uniform in each, from
    np.random.default_rng(seed)."""
    a, b, c = (verts[tris[:, i]] for i in range(3))
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    if not area.sum() > 0:
        raise ValueError("the mesh has no area to sample")
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(tris), size=n, p=area / area.sum())
    r = rng.random((n, 2))
    flip = r.sum(1) > 1  # reflect the far half of the square into the triangle
    r[flip] = 1 - r[flip]
    return a[pick] + r[:, :1] * (b - a)[pick] + r[:, 1:] * (c - a)[pick]


def sample_mesh_surface(path: str, n: int) -> np.ndarray:
    """n GT surface samples of the mesh at `path` (float64, (n, 3))."""
    verts, tris = read_mesh(path)
    return sample_triangles(verts, tris, n)
