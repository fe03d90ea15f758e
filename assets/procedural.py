"""Procedural glTF 2.0 scene generation (GLB writer + test scenes).

No glTF sample assets ship in this environment, so every BASELINE.json
config gets a procedurally generated stand-in that satisfies the
loader's strict attribute contract (indices + POSITION + NORMAL +
TANGENT + TEXCOORD_0 + material, triangles only — Scene.zig:176-182):

- ``make_box``        — config[0]: one cube, one material (Box sample analog)
- ``make_textured_sphere`` — config[1]: UV sphere with base-color /
  normal / metallic-roughness / emissive PNG textures (DamagedHelmet analog)
- ``make_cornell``    — config[3]: emissive interior box (deep-bounce scene)
- ``make_columns``    — config[2]: floor + grids of columns, many
  materials, parametric triangle count (Sponza stress analog)

The GLB writer emits spec-compliant binary glTF (JSON + BIN chunk)
and is itself exercised by the loader round-trip tests.
"""

from __future__ import annotations

import json
import math
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Mesh building blocks
# --------------------------------------------------------------------------
@dataclass
class PrimData:
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray    # (V, 3) f32
    tangents: np.ndarray   # (V, 4) f32
    uvs: np.ndarray        # (V, 2) f32
    indices: np.ndarray    # (3T,) uint32 (narrowed to u16 when possible)
    material: int = 0


@dataclass
class MaterialDesc:
    base_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 0.0
    roughness: float = 1.0
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    base_color_texture: Optional[int] = None
    metallic_roughness_texture: Optional[int] = None
    emissive_texture: Optional[int] = None
    normal_texture: Optional[int] = None


@dataclass
class NodeDesc:
    mesh: Optional[int] = None
    translation: Optional[Tuple[float, float, float]] = None
    rotation: Optional[Tuple[float, float, float, float]] = None  # xyzw
    scale: Optional[Tuple[float, float, float]] = None
    children: List[int] = field(default_factory=list)


def _quad(p0, p1, p2, p3, material: int) -> PrimData:
    """Two CCW triangles for the quad p0->p1->p2->p3 (viewed from the
    front face, i.e. the side the normal points to)."""
    p0, p1, p2, p3 = (np.asarray(p, dtype=np.float32) for p in (p0, p1, p2, p3))
    normal = np.cross(p1 - p0, p3 - p0)
    normal = normal / np.linalg.norm(normal)
    tangent = p1 - p0
    tangent = tangent / np.linalg.norm(tangent)
    positions = np.stack([p0, p1, p2, p3])
    normals = np.tile(normal.astype(np.float32), (4, 1))
    tangents = np.concatenate(
        [np.tile(tangent.astype(np.float32), (4, 1)), np.ones((4, 1), np.float32)],
        axis=1,
    )
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], dtype=np.uint32)
    return PrimData(positions, normals, tangents, uvs, indices, material)


def merge_prims(prims: List[PrimData], material: Optional[int] = None) -> PrimData:
    base = 0
    pos, nrm, tan, uv, idx = [], [], [], [], []
    for p in prims:
        pos.append(p.positions)
        nrm.append(p.normals)
        tan.append(p.tangents)
        uv.append(p.uvs)
        idx.append(p.indices + base)
        base += p.positions.shape[0]
    return PrimData(
        np.concatenate(pos), np.concatenate(nrm), np.concatenate(tan),
        np.concatenate(uv), np.concatenate(idx),
        material if material is not None else prims[0].material,
    )


def box_prim(center, size, material: int, inward: bool = False) -> PrimData:
    """Axis-aligned box; ``inward=True`` flips faces for interiors."""
    cx, cy, cz = center
    hx, hy, hz = (s * 0.5 for s in size)
    x0, x1 = cx - hx, cx + hx
    y0, y1 = cy - hy, cy + hy
    z0, z1 = cz - hz, cz + hz
    faces = [
        # +z
        ((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)),
        # -z
        ((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0)),
        # +x
        ((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1)),
        # -x
        ((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0)),
        # +y
        ((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0)),
        # -y
        ((x0, y0, z0), (x1, y0, z0), (x1, y0, z1), (x0, y0, z1)),
    ]
    quads = []
    for q in faces:
        if inward:
            q = (q[1], q[0], q[3], q[2])  # reverse winding, flip normal
        quads.append(_quad(*q, material=material))
    return merge_prims(quads, material)


def sphere_prim(center, radius: float, material: int,
                lat: int = 32, lon: int = 64) -> PrimData:
    """UV sphere with analytic normals/tangents."""
    cx, cy, cz = center
    thetas = np.linspace(0.0, math.pi, lat + 1)
    phis = np.linspace(0.0, 2.0 * math.pi, lon + 1)
    T, P = np.meshgrid(thetas, phis, indexing="ij")
    nx = np.sin(T) * np.cos(P)
    ny = np.cos(T)
    nz = np.sin(T) * np.sin(P)
    positions = np.stack(
        [cx + radius * nx, cy + radius * ny, cz + radius * nz], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    normals = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3).astype(np.float32)
    # Tangent along +phi.
    tx = -np.sin(P)
    tz = np.cos(P)
    tangents = np.stack(
        [tx, np.zeros_like(tx), tz, np.ones_like(tx)], axis=-1
    ).reshape(-1, 4).astype(np.float32)
    u = (P / (2.0 * math.pi)).reshape(-1)
    v = (T / math.pi).reshape(-1)
    uvs = np.stack([u, v], axis=-1).astype(np.float32)

    idx = []
    stride = lon + 1
    for i in range(lat):
        for j in range(lon):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            # CCW seen from outside (normals point outward).
            idx.extend([a, c, b, b, c, d])
    indices = np.asarray(idx, dtype=np.uint32)
    return PrimData(positions, normals, tangents, uvs, indices, material)


# --------------------------------------------------------------------------
# PNG texture generation
# --------------------------------------------------------------------------
def _png_bytes(rgba: np.ndarray) -> bytes:
    from vulkan_pathtracer_tpu.utils.png import encode_png

    return encode_png(rgba)


def checker_texture(size: int = 64, cells: int = 8,
                    c0=(255, 255, 255, 255), c1=(40, 40, 40, 255)) -> bytes:
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx * cells // size) + (yy * cells // size)) % 2 == 0
    img = np.where(mask[..., None], np.array(c0, np.uint8), np.array(c1, np.uint8))
    return _png_bytes(img.astype(np.uint8))


def normal_map_texture(size: int = 64, bump_cells: int = 4, strength: float = 0.5) -> bytes:
    """A sinusoidal bump normal map (tangent space, +z up)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size
    dx = strength * np.sin(2 * np.pi * bump_cells * xx)
    dy = strength * np.sin(2 * np.pi * bump_cells * yy)
    n = np.stack([-dx, -dy, np.ones_like(dx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    rgb = ((n * 0.5 + 0.5) * 255.0).astype(np.uint8)
    rgba = np.concatenate([rgb, np.full_like(rgb[..., :1], 255)], axis=-1)
    return _png_bytes(rgba)


def mr_texture(size: int = 64, roughness: float = 0.6, metallic: float = 0.9) -> bytes:
    img = np.zeros((size, size, 4), dtype=np.uint8)
    img[..., 1] = int(roughness * 255)
    img[..., 2] = int(metallic * 255)
    img[..., 3] = 255
    return _png_bytes(img)


# --------------------------------------------------------------------------
# GLB writer
# --------------------------------------------------------------------------
def write_glb(path: str, meshes: List[List[PrimData]],
              materials: List[MaterialDesc],
              nodes: Optional[List[NodeDesc]] = None,
              textures: Optional[List[bytes]] = None) -> None:
    """meshes: list of meshes, each a list of primitives."""
    textures = textures or []
    if nodes is None:
        nodes = [NodeDesc(mesh=i) for i in range(len(meshes))]

    bin_parts: List[bytes] = []
    buffer_views = []
    accessors = []

    def _align(n: int = 4):
        total = sum(len(p) for p in bin_parts)
        pad = (-total) % n
        if pad:
            bin_parts.append(b"\x00" * pad)

    def add_view(data: bytes, target: Optional[int] = None) -> int:
        _align(4)
        offset = sum(len(p) for p in bin_parts)
        bin_parts.append(data)
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, type_: str, component: int,
                     target: int, minmax: bool = False) -> int:
        view = add_view(arr.tobytes(), target)
        acc = {
            "bufferView": view,
            "componentType": component,
            "count": arr.shape[0],
            "type": type_,
        }
        if minmax:
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    gltf_meshes = []
    for prims in meshes:
        out_prims = []
        for p in prims:
            if p.positions.shape[0] <= 0xFFFF:
                idx = p.indices.astype(np.uint16)
                comp = 5123
            else:
                idx = p.indices.astype(np.uint32)
                comp = 5125
            prim = {
                "mode": 4,
                "material": p.material,
                "indices": add_accessor(idx.reshape(-1, 1), "SCALAR", comp, 34963),
                "attributes": {
                    "POSITION": add_accessor(
                        p.positions.astype(np.float32), "VEC3", 5126, 34962,
                        minmax=True,
                    ),
                    "NORMAL": add_accessor(
                        p.normals.astype(np.float32), "VEC3", 5126, 34962
                    ),
                    "TANGENT": add_accessor(
                        p.tangents.astype(np.float32), "VEC4", 5126, 34962
                    ),
                    "TEXCOORD_0": add_accessor(
                        p.uvs.astype(np.float32), "VEC2", 5126, 34962
                    ),
                },
            }
            out_prims.append(prim)
        gltf_meshes.append({"primitives": out_prims})

    gltf_images = []
    gltf_textures = []
    for png in textures:
        view = add_view(png)
        gltf_images.append({"bufferView": view, "mimeType": "image/png"})
        gltf_textures.append({"source": len(gltf_images) - 1, "sampler": 0})

    gltf_materials = []
    for m in materials:
        pbr = {
            "baseColorFactor": list(m.base_color),
            "metallicFactor": m.metallic,
            "roughnessFactor": m.roughness,
        }
        if m.base_color_texture is not None:
            pbr["baseColorTexture"] = {"index": m.base_color_texture}
        if m.metallic_roughness_texture is not None:
            pbr["metallicRoughnessTexture"] = {"index": m.metallic_roughness_texture}
        mat = {"pbrMetallicRoughness": pbr, "emissiveFactor": list(m.emissive)}
        if m.emissive_texture is not None:
            mat["emissiveTexture"] = {"index": m.emissive_texture}
        if m.normal_texture is not None:
            mat["normalTexture"] = {"index": m.normal_texture}
        gltf_materials.append(mat)

    gltf_nodes = []
    root_nodes = set(range(len(nodes)))
    for nd in nodes:
        node = {}
        if nd.mesh is not None:
            node["mesh"] = nd.mesh
        if nd.translation is not None:
            node["translation"] = list(nd.translation)
        if nd.rotation is not None:
            node["rotation"] = list(nd.rotation)
        if nd.scale is not None:
            node["scale"] = list(nd.scale)
        if nd.children:
            node["children"] = nd.children
            root_nodes -= set(nd.children)
        gltf_nodes.append(node)

    _align(4)
    binary = b"".join(bin_parts)

    gltf = {
        "asset": {"version": "2.0", "generator": "vulkan_pathtracer_tpu"},
        "scene": 0,
        "scenes": [{"nodes": sorted(root_nodes)}],
        "nodes": gltf_nodes,
        "meshes": gltf_meshes,
        "materials": gltf_materials,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(binary)}],
        "samplers": [{"magFilter": 9729, "minFilter": 9729,
                      "wrapS": 10497, "wrapT": 10497}],
    }
    if gltf_images:
        gltf["images"] = gltf_images
        gltf["textures"] = gltf_textures

    json_bytes = json.dumps(gltf, separators=(",", ":")).encode()
    json_bytes += b" " * ((-len(json_bytes)) % 4)
    total = 12 + 8 + len(json_bytes) + 8 + len(binary)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_bytes), 0x4E4F534A))
        f.write(json_bytes)
        f.write(struct.pack("<II", len(binary), 0x004E4942))
        f.write(binary)


# --------------------------------------------------------------------------
# Scenes (BASELINE.json config stand-ins)
# --------------------------------------------------------------------------
def make_box(path: str) -> None:
    """config[0]: one unit cube, single flat material."""
    cube = box_prim((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), material=0)
    write_glb(
        path,
        meshes=[[cube]],
        materials=[MaterialDesc(base_color=(0.8, 0.1, 0.1, 1.0),
                                metallic=0.0, roughness=0.6)],
    )


def make_cornell(path: str, light_emissive=(1.0, 1.0, 1.0)) -> None:
    """config[3]: emissive interior (Cornell-style), deep-bounce scene."""
    room = box_prim((0, 1.0, 0), (2.0, 2.0, 2.0), material=0, inward=True)
    left = _quad((-0.999, 0.0, 1.0), (-0.999, 0.0, -1.0),
                 (-0.999, 2.0, -1.0), (-0.999, 2.0, 1.0), material=1)
    right = _quad((0.999, 0.0, -1.0), (0.999, 0.0, 1.0),
                  (0.999, 2.0, 1.0), (0.999, 2.0, -1.0), material=2)
    light = _quad((-0.4, 1.998, 0.4), (0.4, 1.998, 0.4),
                  (0.4, 1.998, -0.4), (-0.4, 1.998, -0.4), material=3)
    tall = box_prim((-0.35, 0.6, -0.3), (0.55, 1.2, 0.55), material=0)
    short = box_prim((0.4, 0.3, 0.35), (0.55, 0.6, 0.55), material=4)
    write_glb(
        path,
        meshes=[[room, left, right, light, tall, short]],
        materials=[
            MaterialDesc(base_color=(0.73, 0.73, 0.73, 1.0), roughness=0.9),
            MaterialDesc(base_color=(0.65, 0.05, 0.05, 1.0), roughness=0.9),
            MaterialDesc(base_color=(0.12, 0.45, 0.15, 1.0), roughness=0.9),
            MaterialDesc(base_color=(0.0, 0.0, 0.0, 1.0),
                         emissive=light_emissive, roughness=1.0),
            MaterialDesc(base_color=(0.8, 0.8, 0.9, 1.0),
                         metallic=1.0, roughness=0.15),
        ],
    )


def make_textured_sphere(path: str, lat: int = 48, lon: int = 96) -> None:
    """config[1]: textured PBR sphere (DamagedHelmet stand-in)."""
    sphere = sphere_prim((0.0, 0.0, 0.0), 1.0, material=0, lat=lat, lon=lon)
    floor = _quad((-4, -1.2, 4), (4, -1.2, 4), (4, -1.2, -4), (-4, -1.2, -4),
                  material=1)
    write_glb(
        path,
        meshes=[[sphere, floor]],
        materials=[
            MaterialDesc(
                base_color=(1.0, 1.0, 1.0, 1.0),
                metallic=1.0, roughness=1.0,
                base_color_texture=0,
                metallic_roughness_texture=1,
                normal_texture=2,
                emissive=(0.1, 0.1, 0.1),
                emissive_texture=3,
            ),
            MaterialDesc(base_color=(0.5, 0.5, 0.5, 1.0), roughness=0.8),
        ],
        textures=[
            checker_texture(128, 8, (220, 180, 120, 255), (60, 60, 90, 255)),
            mr_texture(64, roughness=0.5, metallic=0.8),
            normal_map_texture(128, bump_cells=6, strength=0.6),
            checker_texture(64, 4, (255, 255, 255, 255), (0, 0, 0, 255)),
        ],
    )


def make_columns(path: str, grid: int = 8, segments: int = 6,
                 n_materials: int = 16) -> None:
    """config[2]: Sponza stand-in — floor + grid x grid segmented
    columns with many materials. Triangle count ~= grid^2 * segments
    * 12 + floor; grid=16, segments=18 gives ~55k tris; scale up via
    params for stress tests."""
    rng = np.random.default_rng(1234)
    meshes: List[List[PrimData]] = []
    nodes: List[NodeDesc] = []
    materials = [
        MaterialDesc(
            base_color=tuple(rng.uniform(0.2, 0.9, size=3)) + (1.0,),
            metallic=float(rng.uniform(0.0, 1.0)),
            roughness=float(rng.uniform(0.1, 0.9)),
        )
        for _ in range(n_materials)
    ]
    # One column mesh per material, instanced over the grid via nodes.
    for mi in range(n_materials):
        parts = []
        for s in range(segments):
            size = 0.3 + 0.1 * math.sin(s * 1.7)
            parts.append(
                box_prim((0.0, 0.25 + s * 0.5, 0.0), (size, 0.5, size), mi)
            )
        meshes.append([merge_prims(parts, mi)])
    floor = _quad((-20, 0, 20), (20, 0, 20), (20, 0, -20), (-20, 0, -20), 0)
    roof_lights = _quad((-6, 10.0, 6), (6, 10.0, 6), (6, 10.0, -6), (-6, 10.0, -6),
                        n_materials)
    materials.append(
        MaterialDesc(base_color=(0, 0, 0, 1), emissive=(1.0, 0.95, 0.8))
    )
    meshes.append([floor, roof_lights])

    node_index = 0
    for gx in range(grid):
        for gz in range(grid):
            x = (gx - grid / 2 + 0.5) * 2.0
            z = (gz - grid / 2 + 0.5) * 2.0
            nodes.append(
                NodeDesc(
                    mesh=(gx * grid + gz) % n_materials,
                    translation=(x, 0.0, z),
                )
            )
            node_index += 1
    nodes.append(NodeDesc(mesh=n_materials))  # floor + light
    write_glb(path, meshes=meshes, materials=materials, nodes=nodes)


def _panel_field(origin, du, dv, nu: int, nv: int, thickness: float,
                 normal_axis: int, normal_sign: float, mat_fn,
                 jitter: float = 0.0, rng=None) -> List[PrimData]:
    """Grid of nu x nv thin boxes tiling the rectangle origin + u*du +
    v*dv (du/dv are FULL edge vectors).  Each panel is extruded
    ``thickness`` along ``normal_axis`` (sign ``normal_sign``) with an
    optional random depth jitter — cheap Sponza-like relief detail."""
    origin = np.asarray(origin, np.float64)
    du = np.asarray(du, np.float64) / nu
    dv = np.asarray(dv, np.float64) / nv
    out = []
    for i in range(nu):
        for j in range(nv):
            c = origin + du * (i + 0.5) + dv * (j + 0.5)
            t = thickness * (1.0 + (rng.uniform(0, jitter) if jitter else 0))
            size = np.abs(du) * 0.94 + np.abs(dv) * 0.94
            size[normal_axis] = t
            center = c.copy()
            center[normal_axis] += normal_sign * t * 0.5
            out.append(box_prim(tuple(center), tuple(size), mat_fn(i, j)))
    return out


def make_atrium(path: str, detail: float = 1.0, n_materials: int = 32,
                mixed: bool = False) -> None:
    """config[2]: Sponza-class stand-in — an ENCLOSED two-story atrium
    (Sponza is an interior courtyard, not an open field): paneled
    floor/walls/ceiling with relief jitter, two colonnade levels
    around the court, a balustrade, scattered props, and a central
    ceiling opening that admits the sky (the only light, like the
    reference's sky-lit Sponza renders).  ``detail`` scales panel
    subdivision: detail=1.0 ~ 260k triangles (Sponza is ~262k).

    Interior-bench note: place the camera INSIDE (|x|<9, |z|<5,
    0.5<y<9); bench.py uses an interior orbit for BENCH_SCENE=atrium.

    ``mixed=True``: non-uniform tessellation like real Sponza —
    floors/walls/ceiling become LARGE panels (few huge triangles)
    while columns/props keep the ``detail`` tessellation.  Large
    polygons inflate BVH node overlap, which is exactly what triangle
    pre-splitting (VKPT_PRESPLIT) exists to fix; the uniform variant
    measured presplit as a no-op.
    """
    rng = np.random.default_rng(7)
    X, Z, H = 24.0, 14.0, 10.0   # hall half-extents 12 x 7, height 10
    hx, hz = X / 2, Z / 2
    materials = [
        MaterialDesc(
            base_color=tuple(rng.uniform(0.25, 0.8, size=3)) + (1.0,),
            metallic=float(rng.uniform(0.0, 0.3)),
            roughness=float(rng.uniform(0.3, 0.95)),
        )
        for _ in range(n_materials)
    ]

    def mat(i, j):
        return (i * 7 + j * 13) % n_materials

    s = math.sqrt(max(detail, 0.05))
    sp = 0.18 if mixed else s  # panel-field tessellation scale
    prims: List[PrimData] = []
    # Floor / ceiling panel fields (ceiling leaves a central opening).
    fnu, fnv = max(int(44 * sp), 3), max(int(26 * sp), 3)
    prims += _panel_field((-hx, 0, -hz), (X, 0, 0), (0, 0, Z), fnu, fnv,
                          0.06, 1, 1.0, mat, jitter=0.5, rng=rng)
    cnu, cnv = max(int(44 * sp), 5), max(int(26 * sp), 5)
    # Large central opening, like Sponza's court open to the sky.
    open_u = (0.2, 0.8)
    open_v = (0.16, 0.84)
    ceil = _panel_field((-hx, H, -hz), (X, 0, 0), (0, 0, Z), cnu, cnv,
                        0.06, 1, -1.0, mat, jitter=0.5, rng=rng)
    kept = []
    for idx, p in enumerate(ceil):
        i = idx // cnv
        j = idx % cnv
        if (open_u[0] < (i + 0.5) / cnu < open_u[1]
                and open_v[0] < (j + 0.5) / cnv < open_v[1]):
            continue
        kept.append(p)
    prims += kept
    # Walls (inward-extruded panels).
    wn_h = max(int(40 * sp), 3)
    wn_v = max(int(18 * sp), 3)
    prims += _panel_field((-hx, 0, -hz), (X, 0, 0), (0, H, 0), wn_h, wn_v,
                          0.08, 2, 1.0, mat, jitter=0.6, rng=rng)
    prims += _panel_field((-hx, 0, hz), (X, 0, 0), (0, H, 0), wn_h, wn_v,
                          0.08, 2, -1.0, mat, jitter=0.6, rng=rng)
    wn_h2 = max(int(24 * sp), 3)
    prims += _panel_field((-hx, 0, -hz), (0, 0, Z), (0, H, 0), wn_h2, wn_v,
                          0.08, 0, 1.0, mat, jitter=0.6, rng=rng)
    prims += _panel_field((hx, 0, -hz), (0, 0, Z), (0, H, 0), wn_h2, wn_v,
                          0.08, 0, -1.0, mat, jitter=0.6, rng=rng)

    # Two colonnade levels around the court ring.
    ring_x, ring_z = hx - 2.2, hz - 2.2
    seg = max(int(16 * s), 6)
    col_step = 1.6
    levels = [(0.0, 4.6), (5.0, 4.2)]
    xs = np.arange(-ring_x, ring_x + 1e-6, col_step)
    zs = np.arange(-ring_z, ring_z + 1e-6, col_step)
    positions = [(x, -ring_z) for x in xs] + [(x, ring_z) for x in xs] \
        + [(-ring_x, z) for z in zs[1:-1]] + [(ring_x, z) for z in zs[1:-1]]
    for ci, (cx, cz) in enumerate(positions):
        for li, (y0, ch) in enumerate(levels):
            parts = []
            for k in range(seg):
                r = 0.22 + 0.06 * math.sin(k * 1.3 + ci)
                parts.append(box_prim(
                    (cx, y0 + (k + 0.5) * ch / seg, cz),
                    (r, ch / seg, r), (ci + k + li) % n_materials))
            parts.append(box_prim((cx, y0 + ch + 0.1, cz),
                                  (0.5, 0.2, 0.5), ci % n_materials))
            prims += parts
    # Balustrade posts on level 2.
    post_step = 0.4
    xs2 = np.arange(-ring_x, ring_x + 1e-6, post_step)
    zs2 = np.arange(-ring_z, ring_z + 1e-6, post_step)
    ring2 = [(x, -ring_z) for x in xs2] + [(x, ring_z) for x in xs2] \
        + [(-ring_x, z) for z in zs2[1:-1]] + [(ring_x, z) for z in zs2[1:-1]]
    for pi, (px, pz) in enumerate(ring2):
        prims.append(box_prim((px, 5.0 + 0.35, pz), (0.08, 0.7, 0.08),
                              (pi * 3) % n_materials))
    # Level-2 walkway slabs between the colonnade ring and the walls.
    wnu = max(int(30 * sp), 3)
    prims += _panel_field((-hx, 4.9, -hz), (X, 0, 0), (0, 0, 2.2 - 0.1),
                          wnu, max(int(4 * s), 2), 0.1, 1, 1.0, mat,
                          rng=rng)
    prims += _panel_field((-hx, 4.9, hz - 2.1), (X, 0, 0), (0, 0, 2.0),
                          wnu, max(int(4 * s), 2), 0.1, 1, 1.0, mat,
                          rng=rng)
    # Floor props (crates/urns) in the court.
    n_props = int(120 * detail)
    for pi in range(n_props):
        px = rng.uniform(-ring_x + 1, ring_x - 1)
        pz = rng.uniform(-ring_z + 1, ring_z - 1)
        w = rng.uniform(0.25, 0.8)
        h = rng.uniform(0.25, 1.2)
        prims.append(box_prim((px, h / 2 + 0.08, pz), (w, h, w),
                              int(rng.integers(0, n_materials))))

    # Group prims into meshes by material (multi-primitive meshes).
    by_mat: dict = {}
    for p in prims:
        by_mat.setdefault(p.material, []).append(p)
    meshes = [[merge_prims(ps, m)] for m, ps in sorted(by_mat.items())]
    nodes = [NodeDesc(mesh=i) for i in range(len(meshes))]
    write_glb(path, meshes=meshes, materials=materials, nodes=nodes)
