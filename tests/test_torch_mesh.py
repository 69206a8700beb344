"""The port's mesh reader and GT-surface sampler (eval/mesh.py), which stand
in for the JAX package's trimesh.load(..., force="mesh").sample(n).

A BoxWorld's faces (less those that overlap a room face), written by the
test as an ascii PLY (quads, fanned by
the reader), a binary PLY (quads, with extra vertex and face properties)
and GLBs (triangles; one under a node TRS below a parent matrix, one with
no indices): every sample lies on a face within 1e-6 m, and each face's
share of the samples is within 5 standard deviations of its share of the
area. The coverage judge's completeness_ratio with the mesh's GT samples is
within 0.01 of the one with the analytic samples, on the same actions
(200,000 samples each: the two draws differ, by about 0.002 at one standard
deviation). trimesh draws other points from the same distribution, so no
test holds the samples against it bitwise (and this host has no trimesh).
Refused: a GLB with extensionsRequired, sparse accessors, a primitive mode
other than triangles, a big-endian PLY."""

import json
import os
import struct

import numpy as np
import pytest

from activesplat_tpu_torch.eval import replay as treplay
from activesplat_tpu_torch.eval.mesh import read_mesh, sample_mesh_surface
from activesplat_tpu_torch.runtime.dataloader import RGBDSensor, SimAction, SyntheticDataset
from activesplat_tpu_torch.runtime.synthetic import BoxWorld

from torch_one_thread import one_torch_thread  # noqa: F401 (autouse)

WORLD = BoxWorld.two_room(seed=0)
N_SAMPLES = 20_000
ON_FACE_ATOL = 1e-6
SIGMAS = 5
COVERAGE_ATOL = 0.01


def rects(world, disjoint=False):
    """The world's rectangles (origin, (e1, e2), area). With `disjoint`,
    less the obstacle faces that lie in a room face's plane (a box's bottom
    on the floor, the dividing wall's top at the ceiling and its ends at the
    side walls), which overlap a room face: a sample there lies on two
    faces, and rounding alone would decide which one it is counted for."""
    faces = world.surface_area_faces()
    if not disjoint:
        return faces
    room = np.array(world.size, np.float64)

    def in_room_plane(origin, basis):
        normal = np.cross(*basis)
        axis = int(np.argmax(np.abs(normal)))
        return np.isclose(origin[axis], 0.0) or np.isclose(origin[axis], room[axis])

    return faces[:6] + [f for f in faces[6:] if not in_room_plane(f[0], f[1])]


def quads(world, disjoint=False):
    """(V, 3) corners and (F, 4) quads of the world's rectangles, wound
    origin, +e1, +e1+e2, +e2."""
    verts, faces = [], []
    for origin, basis, _ in rects(world, disjoint):
        e1, e2 = basis
        faces.append(len(verts) + np.arange(4))
        verts += [origin, origin + e1, origin + e1 + e2, origin + e2]
    return np.array(verts, np.float64), np.array(faces, np.int64)


def write_ply_ascii(path, verts, faces):
    lines = ["ply", "format ascii 1.0", "comment a BoxWorld", f"element vertex {len(verts)}",
             "property float x", "property float y", "property float z",
             f"element face {len(faces)}", "property list uchar int vertex_indices",
             "end_header"]
    lines += [f"{x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    lines += [f"{len(f)} " + " ".join(map(str, f)) for f in faces]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def write_ply_binary(path, verts, faces, endian="little"):
    head = (f"ply\nformat binary_{endian}_endian 1.0\nelement vertex {len(verts)}\n"
            "property double x\nproperty double y\nproperty double z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element face {len(faces)}\nproperty list uchar uint vertex_indices\n"
            "property int object_id\nend_header\n").encode()
    e = "<" if endian == "little" else ">"
    body = b"".join(struct.pack(e + "3d3B", *v, 200, 100, 50) for v in verts)
    body += b"".join(struct.pack(e + "B4Ii", 4, *f, i) for i, f in enumerate(faces))
    path.write_bytes(head + body)
    return str(path)


def trs_matrix(t, q_xyzw, s):
    x, y, z, w = q_xyzw
    r = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                  [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                  [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    m = np.eye(4)
    m[:3, :3] = r @ np.diag(s)
    m[:3, 3] = t
    return m


def write_glb(path, verts, tris, nodes=None, indexed=True, extra=None, mode=None):
    """A GLB of one triangle mesh; `nodes` (glTF node dicts, the last one
    holding the mesh) place it, and the stored positions are the world
    vertices taken back through the nodes' transforms."""
    nodes = nodes or [{"mesh": 0}]
    world = np.eye(4)
    for node in nodes:
        if "matrix" in node:
            world = world @ np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        elif {"translation", "rotation", "scale"} & node.keys():
            world = world @ trs_matrix(node.get("translation", (0, 0, 0)),
                                       node.get("rotation", (0, 0, 0, 1)),
                                       node.get("scale", (1, 1, 1)))
    local = (np.c_[verts, np.ones(len(verts))] @ np.linalg.inv(world).T)[:, :3]
    if not indexed:
        local, tris = local[tris.reshape(-1)], None
    pos = local.astype(np.float32).tobytes()
    idx = b"" if tris is None else tris.astype(np.uint32).tobytes()
    n_vert = len(local)
    prim = {"attributes": {"POSITION": 0}}
    if mode is not None:
        prim["mode"] = mode
    accessors = [{"bufferView": 0, "componentType": 5126, "count": n_vert, "type": "VEC3"}]
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": len(pos)}]
    if tris is not None:
        prim["indices"] = 1
        accessors.append({"bufferView": 1, "componentType": 5125, "count": tris.size,
                          "type": "SCALAR"})
        views.append({"buffer": 0, "byteOffset": len(pos), "byteLength": len(idx)})
    gltf_nodes = [dict(n) for n in nodes]
    for i in range(len(gltf_nodes) - 1):
        gltf_nodes[i]["children"] = [i + 1]
    gltf_nodes[-1]["mesh"] = 0
    gltf = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
            "nodes": gltf_nodes, "meshes": [{"primitives": [prim]}], "accessors": accessors,
            "bufferViews": views, "buffers": [{"byteLength": len(pos) + len(idx)}],
            **(extra or {})}
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    binary = pos + idx
    binary += b"\0" * (-len(binary) % 4)
    body = (struct.pack("<II", len(js), 0x4E4F534A) + js
            + struct.pack("<II", len(binary), 0x004E4942) + binary)
    path.write_bytes(struct.pack("<4sII", b"glTF", 2, 12 + len(body)) + body)
    return str(path)


def rect_distances(points, world, disjoint=True):
    """(n, F) distance of each point to each of the world's rectangles."""
    out = []
    for origin, (e1, e2), _ in rects(world, disjoint):
        d = points - origin
        u = np.clip(d @ e1 / (e1 @ e1), 0, 1)
        v = np.clip(d @ e2 / (e2 @ e2), 0, 1)
        nearest = origin + u[:, None] * e1 + v[:, None] * e2
        out.append(np.linalg.norm(points - nearest, axis=1))
    return np.stack(out, axis=1)


def mesh_files(tmp_path, disjoint=True):
    verts, faces = quads(WORLD, disjoint)
    tris = np.concatenate([faces[:, [0, 1, 2]], faces[:, [0, 2, 3]]])
    parent = {"matrix": trs_matrix((1.0, -2.0, 0.5), (0, np.sin(0.3), 0, np.cos(0.3)),
                                   (1, 1, 1)).T.reshape(-1).tolist()}
    child = {"translation": [0.25, 0.5, -1.0], "rotation": [np.sin(0.2), 0, 0, np.cos(0.2)],
             "scale": [2.0, 0.5, 1.0]}
    return {
        "ascii.ply": write_ply_ascii(tmp_path / "ascii.ply", verts, faces),
        "binary.ply": write_ply_binary(tmp_path / "binary.ply", verts, faces),
        "plain.glb": write_glb(tmp_path / "plain.glb", verts, tris),
        "trs.glb": write_glb(tmp_path / "trs.glb", verts, tris, nodes=[parent, child]),
        "unindexed.glb": write_glb(tmp_path / "unindexed.glb", verts, tris, indexed=False),
    }


@pytest.mark.parametrize("name", ["ascii.ply", "binary.ply", "plain.glb", "trs.glb",
                                  "unindexed.glb"])
def test_samples_on_faces_and_area_weighted(tmp_path, name):
    path = mesh_files(tmp_path)[name]
    verts, tris = read_mesh(path)
    assert tris.shape == (2 * len(rects(WORLD, disjoint=True)), 3)
    pts = sample_mesh_surface(path, N_SAMPLES)
    assert pts.shape == (N_SAMPLES, 3) and pts.dtype == np.float64
    np.testing.assert_array_equal(pts, sample_mesh_surface(path, N_SAMPLES))  # seeded
    dist = rect_distances(pts, WORLD)
    assert dist.min(axis=1).max() < ON_FACE_ATOL
    areas = np.array([a for _, _, a in rects(WORLD, disjoint=True)])
    p = areas / areas.sum()
    counts = np.bincount(dist.argmin(axis=1), minlength=len(areas))
    sigma = np.sqrt(N_SAMPLES * p * (1 - p))
    assert (np.abs(counts - N_SAMPLES * p) <= SIGMAS * sigma).all(), (counts, N_SAMPLES * p)


def test_coverage_with_mesh_gt_matches_analytic_gt(tmp_path):
    path = mesh_files(tmp_path, disjoint=False)["trs.glb"]  # the analytic sampler's faces

    class MeshDataset:  # a dataset with a scene mesh and no analytic world
        scene_mesh_url = path

    mesh_gt = treplay.sample_gt_surface(MeshDataset(), 200_000)
    sensor = RGBDSensor.from_fov(32, 32, 90.0, depth_min=0.0, depth_max=10.0)

    def dataset(results_dir):
        return SyntheticDataset(WORLD, sensor, step_num=40, start_position=np.array([5.0, 0, 1.5]),
                                turn_angle_deg=30.0, results_dir=results_dir)

    ds = dataset(str(tmp_path / "rec"))
    for a in [SimAction.TURN_LEFT] * 12 + [SimAction.MOVE_FORWARD] * 15 + [SimAction.LOOK_DOWN]:
        ds.step(a)
    actions = str(tmp_path / "rec" / "actions.txt")
    analytic = treplay.eval_actions(dataset(None), actions, num_gt_samples=200_000)
    meshed = treplay.eval_actions(dataset(None), actions, gt_samples=mesh_gt)
    assert 0.05 < analytic.completeness_ratio < 0.95
    assert abs(meshed.completeness_ratio - analytic.completeness_ratio) < COVERAGE_ATOL
    assert abs(meshed.accuracy - analytic.accuracy) < 0.01


def test_refusals(tmp_path):
    verts, faces = quads(BoxWorld.single_room(seed=0))
    tris = np.concatenate([faces[:, [0, 1, 2]], faces[:, [0, 2, 3]]])
    draco = write_glb(tmp_path / "draco.glb", verts, tris,
                      extra={"extensionsRequired": ["KHR_draco_mesh_compression"],
                             "extensionsUsed": ["KHR_draco_mesh_compression"]})
    with pytest.raises(ValueError, match="KHR_draco_mesh_compression"):
        read_mesh(draco)
    lines = write_glb(tmp_path / "lines.glb", verts, tris, mode=1)
    with pytest.raises(ValueError, match="mode 1"):
        read_mesh(lines)
    sparse = tmp_path / "sparse.glb"
    blob = bytearray(open(write_glb(sparse, verts, tris), "rb").read())
    length = struct.unpack_from("<I", blob, 12)[0]
    gltf = json.loads(blob[20:20 + length])
    gltf["accessors"][0]["sparse"] = {"count": 1}
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    rest = blob[20 + length:]
    body = struct.pack("<II", len(js), 0x4E4F534A) + js + rest
    sparse.write_bytes(struct.pack("<4sII", b"glTF", 2, 12 + len(body)) + body)
    with pytest.raises(ValueError, match="sparse"):
        read_mesh(str(sparse))
    with pytest.raises(ValueError, match="big_endian"):
        read_mesh(write_ply_binary(tmp_path / "big.ply", verts, faces, endian="big"))
    with pytest.raises(ValueError, match=".obj"):
        read_mesh(str(tmp_path / "scene.obj"))
