"""Flattened device scene: world-space SoA arrays for the device.

The reference hands its geometry to the Vulkan driver as BLAS/TLAS
(RaytracingPass.zig:224-488, Tlas.zig) and fetches attributes in the
hit shader via buffer device addresses (triangle.glsl:46-112).  The
design here instead *bakes* the instance transforms at load
time, producing one flat world-space triangle soup plus per-vertex
attribute arrays — a single-level BVH over everything, the best-case
layout for per-ray traversal (no per-instance transform in the hot
loop).  Per-frame animation re-bakes transforms + refits the BVH (the
TLAS-refit analog).

Numeric parity notes (all mirroring triangle.glsl):

- The hit shader transforms normals/tangents by
  ``v * transpose(inverse(mat3(object_to_world)))`` — row-vector
  semantics, i.e. column-convention ``inverse(A) @ v``
  (triangle.glsl:79-97).  We bake exactly that per vertex,
  unnormalized, so interpolate-then-normalize matches the shader.
- The geometric normal is ``normalize(cross(p1-p0, p2-p0) * M)`` with
  *object-space* positions (triangle.glsl:99-107); we bake it per
  triangle since world-space edge cross products would differ under
  non-orthogonal transforms.
- Backface culling (gl_RayFlagsCullBackFacingTrianglesEXT,
  ray_gen.rgen:53) is applied in the intersector via the
  Möller–Trumbore determinant sign on *world-space* edges, which
  matches Vulkan's winding x transform-orientation rule.
- ``payload.primitive_index = instanceCustomIndex + geometryIndex``
  (closest_hit.rchit:12) with custom index = the mesh's first
  primitive (Tlas.zig:43-46): our per-triangle ``primitive`` id is the
  global primitive index, identical across instances of a mesh.

Arrays are padded to multiples of PAD with degenerate
triangles (zero edges -> det == 0 -> never hit).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from vulkan_pathtracer_tpu.models.gltf import (
    INVALID_TEXTURE_INDEX,
    Scene,
)

PAD = 128


def _pad_rows(arr: np.ndarray, multiple: int, fill=0.0) -> np.ndarray:
    n = arr.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad_shape = (target - n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)])


@jax.tree_util.register_pytree_node_class
@dataclass
class DeviceScene:
    """SoA device arrays. Registered as a pytree so it can be passed
    straight into jitted render functions."""

    # Triangles (world space)
    tri_v0: jnp.ndarray          # (T, 3) f32
    tri_e1: jnp.ndarray          # (T, 3) f32  v1 - v0
    tri_e2: jnp.ndarray          # (T, 3) f32  v2 - v0
    tri_gn: jnp.ndarray          # (T, 3) f32  baked geometric normal
    tri_index: jnp.ndarray       # (T, 3) int32 vertex attribute indices
    tri_material: jnp.ndarray    # (T,) int32
    tri_primitive: jnp.ndarray   # (T,) int32 global primitive id (payload parity)
    tri_local: jnp.ndarray       # (T,) int32 triangle index within primitive

    # Vertex attributes (flattened per instance)
    vert_normal: jnp.ndarray     # (V, 3) f32 inverse(A)-baked, unnormalized
    vert_tangent: jnp.ndarray    # (V, 4) f32 xyz baked, w passthrough
    vert_uv: jnp.ndarray         # (V, 2) f32

    # Materials (M,) uint32/int32 SoA — packing parity with material.glsl:7-16.
    mat_albedo_factor: jnp.ndarray
    mat_mr_factor: jnp.ndarray
    mat_emissive_factor: jnp.ndarray
    mat_albedo_tex: jnp.ndarray      # int32, remapped: 0 = dummy white
    mat_mr_tex: jnp.ndarray
    mat_emissive_tex: jnp.ndarray
    mat_normal_tex: jnp.ndarray
    mat_has_normal_tex: jnp.ndarray  # bool

    # Textures: one flat texel pool (uint8 RGBA), index 0 = 1x1 white.
    tex_texels: jnp.ndarray      # (P, 4) uint8
    tex_offset: jnp.ndarray      # (NT,) int32 into texel pool
    tex_width: jnp.ndarray       # (NT,) int32
    tex_height: jnp.ndarray      # (NT,) int32

    # BVH. Traversal arrays are stacked per direction octant when
    # bvh_orders == 8 (shape (orders*Nn, ...), skip pointers include
    # the per-octant offset); build-order arrays support device refit.
    bvh_bmin: Optional[jnp.ndarray] = None   # (orders*Nn, 3) f32
    bvh_bmax: Optional[jnp.ndarray] = None   # (orders*Nn, 3) f32
    bvh_skip: Optional[jnp.ndarray] = None   # (orders*Nn,) int32 escape
    bvh_leaf_first: Optional[jnp.ndarray] = None  # (orders*Nn,) int32
    bvh_leaf_count: Optional[jnp.ndarray] = None  # (orders*Nn,) int32
    bvh_left: Optional[jnp.ndarray] = None   # (Nn,) int32 build order
    bvh_right: Optional[jnp.ndarray] = None  # (Nn,) int32 build order
    bvh_leaf_first_build: Optional[jnp.ndarray] = None  # (Nn,) int32
    bvh_leaf_count_build: Optional[jnp.ndarray] = None  # (Nn,) int32
    bvh_perm: Optional[jnp.ndarray] = None   # (orders*Nn,) int32 -> build idx
    # Packed fast-path records (one gather each per traversal step):
    bvh_packed: Optional[jnp.ndarray] = None   # (orders*Nn, 8) f32:
    #   bmin.xyz, bmax.xyz, bitcast(skip), bitcast(leaf_first | -1)
    bvh_packed_tail: Optional[jnp.ndarray] = None  # (orders*Nn, 2) f32 static
    tri_blocks: Optional[jnp.ndarray] = None   # (n_leaves, block*9) f32
    # Shading fast path: everything a hit needs in ONE row per triangle
    # (3 vertex normals, 3 tangents, 3 uvs, geometric normal, material
    # id) and one row per material (factors + texture table).
    tri_attr: Optional[jnp.ndarray] = None     # (T, 34) f32
    mat_packed: Optional[jnp.ndarray] = None   # (M, 8) uint32

    # Two-level instancing (models/instanced_scene.py).  When
    # ``instanced`` is set, bvh leaf values pack (instance << mb_bits |
    # global mesh leaf block) and triangle arrays are OBJECT space,
    # shared by all instances.
    inst_inv: Optional[jnp.ndarray] = None       # (I, 16) invA|invT|detsign
    inst_nrm: Optional[jnp.ndarray] = None       # (I, 9) normal matrix
    asm_inst: Optional[jnp.ndarray] = None       # (orders*Nn,) int32, -1=top
    asm_src: Optional[jnp.ndarray] = None        # (orders*Nn,) mesh-box idx
    mesh_obj_bmin: Optional[jnp.ndarray] = None  # per-octant mesh node boxes
    mesh_obj_bmax: Optional[jnp.ndarray] = None
    inst_root_obj: Optional[jnp.ndarray] = None  # (I, 6) mesh root obj box
    top_left: Optional[jnp.ndarray] = None       # top tree (build order)
    top_right: Optional[jnp.ndarray] = None
    top_leaf_inst: Optional[jnp.ndarray] = None  # (Ntop,) instance | -1
    top_asm_pos: Optional[jnp.ndarray] = None    # (orders, Ntop)

    num_triangles: int = 0  # un-padded triangle count (static aux)
    bvh_depth: int = 0      # tree depth (static aux, bounds refit sweeps)
    max_leaf_size: int = 4  # static aux (leaf unroll factor)
    bvh_orders: int = 1     # 1 or 8 direction-octant linearizations
    has_textures: bool = False  # static: texel pool beyond the dummy
    instanced: bool = False  # static: two-level packed leaf values
    mb_bits: int = 0         # static: leaf-value mesh-block field width
    top_depth: int = 0       # static: TLAS depth (bounds refit sweeps)
    # Static: every material's emissive factor is zero (textures can't
    # resurrect it — they multiply the factor), so last-bounce
    # radiance reduces to the sky/miss decision and the wavefront may
    # use an any-hit query there (render/wavefront._any_hit).
    emissive_free: bool = False

    # -- pytree plumbing -----------------------------------------------------
    _ARRAY_FIELDS = (
        "tri_v0", "tri_e1", "tri_e2", "tri_gn", "tri_index", "tri_material",
        "tri_primitive", "tri_local", "vert_normal", "vert_tangent",
        "vert_uv", "mat_albedo_factor", "mat_mr_factor",
        "mat_emissive_factor", "mat_albedo_tex", "mat_mr_tex",
        "mat_emissive_tex", "mat_normal_tex", "mat_has_normal_tex",
        "tex_texels", "tex_offset", "tex_width", "tex_height",
        "bvh_bmin", "bvh_bmax", "bvh_skip", "bvh_leaf_first",
        "bvh_leaf_count", "bvh_left", "bvh_right",
        "bvh_leaf_first_build", "bvh_leaf_count_build", "bvh_perm",
        "bvh_packed", "bvh_packed_tail", "tri_blocks",
        "tri_attr", "mat_packed",
        "inst_inv", "inst_nrm", "asm_inst", "asm_src",
        "mesh_obj_bmin", "mesh_obj_bmax", "inst_root_obj",
        "top_left", "top_right", "top_leaf_inst", "top_asm_pos",
    )

    def tree_flatten(self):
        children = tuple(getattr(self, f) for f in self._ARRAY_FIELDS)
        return children, (self.num_triangles, self.bvh_depth,
                          self.max_leaf_size, self.bvh_orders,
                          self.has_textures, self.instanced,
                          self.mb_bits, self.top_depth,
                          self.emissive_free)

    @classmethod
    def tree_unflatten(cls, aux, children):
        kwargs = dict(zip(cls._ARRAY_FIELDS, children))
        return cls(num_triangles=aux[0], bvh_depth=aux[1],
                   max_leaf_size=aux[2], bvh_orders=aux[3],
                   has_textures=aux[4], instanced=aux[5],
                   mb_bits=aux[6], top_depth=aux[7],
                   emissive_free=aux[8], **kwargs)

    @property
    def has_bvh(self) -> bool:
        return self.bvh_bmin is not None


def _bake_instance(scene: Scene, inst, prims_out: dict, vert_base: int) -> int:
    """Append one instance's triangles/vertices in world space."""
    M = inst.transform.astype(np.float64)
    A = M[:3, :3]
    t = M[:3, 3]
    # triangle.glsl:79: normal_world_matrix as row-mult == inverse(A) @ v.
    N = np.linalg.inv(A)

    from vulkan_pathtracer_tpu.ops.native import (
        bake_triangles_native,
        transform_dirs_native,
    )

    mesh = scene.meshes[inst.mesh_index]
    for prim_global in range(mesh.start, mesh.end):
        prim = scene.primitives[prim_global]
        nrm_w = transform_dirs_native(prim.normals, N)
        if nrm_w is None:
            nrm_w = (prim.normals.astype(np.float64) @ N.T).astype(np.float32)
        tan_w = prim.tangents.copy()
        tan_xyz = transform_dirs_native(prim.tangents[:, :3], N)
        if tan_xyz is None:
            tan_xyz = (
                prim.tangents[:, :3].astype(np.float64) @ N.T
            ).astype(np.float32)
        tan_w[:, :3] = tan_xyz

        idx = prim.indices.reshape(-1, 3).astype(np.int64)
        # Native fast path (native/ingest.cpp, bit-identical rounding);
        # NumPy fallback below.
        baked = bake_triangles_native(prim.positions, idx, A, t, N)
        if baked is not None:
            v0, e1, e2, gn = baked
        else:
            pos_w = (
                prim.positions.astype(np.float64) @ A.T + t
            ).astype(np.float32)
            v0 = pos_w[idx[:, 0]]
            e1 = pos_w[idx[:, 1]] - v0
            e2 = pos_w[idx[:, 2]] - v0
            # Object-space edge cross, then inverse(A), per
            # triangle.glsl:99-107.
            obj = prim.positions.astype(np.float64)
            e1o = obj[idx[:, 1]] - obj[idx[:, 0]]
            e2o = obj[idx[:, 2]] - obj[idx[:, 0]]
            gn = np.cross(e1o, e2o) @ N.T
            norm = np.linalg.norm(gn, axis=1, keepdims=True)
            gn = (gn / np.maximum(norm, 1e-30)).astype(np.float32)

        tcount = idx.shape[0]
        prims_out["tri_v0"].append(v0)
        prims_out["tri_e1"].append(e1)
        prims_out["tri_e2"].append(e2)
        prims_out["tri_gn"].append(gn)
        prims_out["tri_index"].append((idx + vert_base).astype(np.int32))
        prims_out["tri_material"].append(
            np.full(tcount, prim.material_index, dtype=np.int32)
        )
        prims_out["tri_primitive"].append(
            np.full(tcount, prim_global, dtype=np.int32)
        )
        prims_out["tri_local"].append(np.arange(tcount, dtype=np.int32))
        prims_out["vert_normal"].append(nrm_w)
        prims_out["vert_tangent"].append(tan_w)
        prims_out["vert_uv"].append(prim.uvs)
        vert_base += prim.positions.shape[0]
    return vert_base


def bvh_with_leaf_blocks(tri_v0: np.ndarray, tri_e1: np.ndarray,
                         tri_e2: np.ndarray, max_leaf_size: int,
                         presplit: float = 0.0):
    """Build the BVH and rewrite its leaves to fixed-size blocks.

    Returns (bvh, slot_map) where slot_map (T',) maps padded leaf-block
    triangle slots to ORIGINAL (pre-Morton-sort) triangle indices, -1
    for padding.  Shared by the static bake and AnimatedScene so both
    produce identical orderings.

    ``presplit`` > 0 enables triangle pre-splitting with that budget
    factor (ops.bvh.presplit_triangle_refs): the tree is built over
    clipped triangle REFERENCES (duplicate slots for split triangles),
    which tightens node boxes around large architectural triangles.
    The builder never sees geometry — only reference AABBs — so this
    reuses the native SAH path unchanged via degenerate box-spanning
    "triangles"; slot_map composes reference -> original ids.
    """
    from vulkan_pathtracer_tpu.ops.bvh import (
        build_bvh_host,
        pad_leaves_to_blocks,
        presplit_triangle_refs,
    )

    if presplit > 0.0 and tri_v0.shape[0] >= 1024:
        lo, hi, ref_tri = presplit_triangle_refs(
            tri_v0, tri_e1, tri_e2, budget_factor=presplit
        )
        span = hi - lo
        bvh = build_bvh_host(lo, span, span, max_leaf_size=max_leaf_size)
        gmap = pad_leaves_to_blocks(bvh, block=max_leaf_size)
        slot_map = np.where(
            gmap >= 0, ref_tri[bvh.tri_order[np.maximum(gmap, 0)]], -1
        )
        return bvh, slot_map

    bvh = build_bvh_host(tri_v0, tri_e1, tri_e2, max_leaf_size=max_leaf_size)
    gmap = pad_leaves_to_blocks(bvh, block=max_leaf_size)
    slot_map = np.where(gmap >= 0, bvh.tri_order[np.maximum(gmap, 0)], -1)
    return bvh, slot_map


def apply_slot_map(arr: np.ndarray, slot_map: np.ndarray) -> np.ndarray:
    """Gather rows by slot_map; -1 slots become zero rows."""
    out = arr[np.maximum(slot_map, 0)]
    out[slot_map < 0] = 0
    return out


def build_device_scene(scene: Scene, build_bvh: bool = True,
                       max_leaf_size: int = 4,
                       octant_order: bool = True,
                       presplit: float = None) -> DeviceScene:
    """Bake a host Scene into device SoA arrays (and optionally a BVH).

    ``presplit``: triangle pre-splitting budget factor (see
    bvh_with_leaf_blocks); None reads VKPT_PRESPLIT (default off).
    """
    import os

    if presplit is None:
        presplit = float(os.environ.get("VKPT_PRESPLIT", "0"))
    acc = {k: [] for k in (
        "tri_v0", "tri_e1", "tri_e2", "tri_gn", "tri_index", "tri_material",
        "tri_primitive", "tri_local", "vert_normal", "vert_tangent",
        "vert_uv",
    )}
    vert_base = 0
    for inst in scene.instances:
        vert_base = _bake_instance(scene, inst, acc, vert_base)

    def cat(key, dtype, cols):
        if acc[key]:
            return np.concatenate(acc[key]).astype(dtype).reshape(-1, cols) \
                if cols > 1 else np.concatenate(acc[key]).astype(dtype)
        return (np.zeros((0, cols), dtype=dtype) if cols > 1
                else np.zeros((0,), dtype=dtype))

    tri_v0 = cat("tri_v0", np.float32, 3)
    tri_e1 = cat("tri_e1", np.float32, 3)
    tri_e2 = cat("tri_e2", np.float32, 3)
    tri_gn = cat("tri_gn", np.float32, 3)
    tri_index = cat("tri_index", np.int32, 3)
    tri_material = cat("tri_material", np.int32, 1)
    tri_primitive = cat("tri_primitive", np.int32, 1)
    tri_local = cat("tri_local", np.int32, 1)
    vert_normal = cat("vert_normal", np.float32, 3)
    vert_tangent = cat("vert_tangent", np.float32, 4)
    vert_uv = cat("vert_uv", np.float32, 2)

    num_triangles = tri_v0.shape[0]

    bvh = None
    if build_bvh and num_triangles > 0:
        bvh, slot_map = bvh_with_leaf_blocks(
            tri_v0, tri_e1, tri_e2, max_leaf_size, presplit=presplit
        )
        # Reorder triangles into fixed-size leaf-block order (padding
        # slots get degenerate rows) so a leaf visit is ONE packed-row
        # gather in traversal.
        tri_v0 = apply_slot_map(tri_v0, slot_map)
        tri_e1 = apply_slot_map(tri_e1, slot_map)
        tri_e2 = apply_slot_map(tri_e2, slot_map)
        tri_gn = apply_slot_map(tri_gn, slot_map)
        tri_index = apply_slot_map(tri_index, slot_map)
        tri_material = apply_slot_map(tri_material, slot_map)
        tri_primitive = apply_slot_map(tri_primitive, slot_map)
        tri_local = apply_slot_map(tri_local, slot_map)

    # Pad triangles with degenerates (zero edges => det == 0 => no hit).
    tri_v0 = _pad_rows(tri_v0, PAD)
    tri_e1 = _pad_rows(tri_e1, PAD)
    tri_e2 = _pad_rows(tri_e2, PAD)
    tri_gn = _pad_rows(tri_gn, PAD)
    tri_index = _pad_rows(tri_index, PAD)
    tri_material = _pad_rows(tri_material, PAD)
    tri_primitive = _pad_rows(tri_primitive, PAD)
    tri_local = _pad_rows(tri_local, PAD)

    if vert_normal.shape[0] == 0:
        vert_normal = np.zeros((1, 3), np.float32)
        vert_tangent = np.zeros((1, 4), np.float32)
        vert_uv = np.zeros((1, 2), np.float32)

    # Materials SoA; texture indices remapped (+1, 0 = dummy white).
    mats = scene.materials
    if len(mats) == 0:
        import numpy.lib.recfunctions  # noqa: F401
        from vulkan_pathtracer_tpu.models.gltf import MATERIAL_DTYPE

        mats = np.zeros(1, dtype=MATERIAL_DTYPE)
        mats["albedo_factor"] = 0x00FFFFFF
        mats["metal_roughness_factor"] = 0x00FFFF00
        mats["albedo_texture_index"] = INVALID_TEXTURE_INDEX
        mats["metal_roughness_texture_index"] = INVALID_TEXTURE_INDEX
        mats["emissive_texture_index"] = INVALID_TEXTURE_INDEX
        mats["normal_texture_index"] = INVALID_TEXTURE_INDEX

    def remap(field):
        raw = mats[field].astype(np.int64)
        return np.where(raw == INVALID_TEXTURE_INDEX, 0, raw + 1).astype(np.int32)

    # Host copies reused below for mat_packed (no device round trip).
    alb_tex_np = remap("albedo_texture_index")
    mr_tex_np = remap("metal_roughness_texture_index")
    emi_tex_np = remap("emissive_texture_index")
    nrm_tex_np = remap("normal_texture_index")
    has_nrm_np = (
        mats["normal_texture_index"].astype(np.int64)
        != INVALID_TEXTURE_INDEX
    )

    # Texel pool: dummy white first.
    texels = [np.full((1, 4), 255, dtype=np.uint8)]
    offsets = [0]
    widths = [1]
    heights = [1]
    cursor = 1
    for tex in scene.textures:
        flat = tex.data.reshape(-1, 4)
        texels.append(flat)
        offsets.append(cursor)
        widths.append(tex.width)
        heights.append(tex.height)
        cursor += flat.shape[0]
    tex_texels = np.concatenate(texels)

    dev = DeviceScene(
        tri_v0=jnp.asarray(tri_v0),
        tri_e1=jnp.asarray(tri_e1),
        tri_e2=jnp.asarray(tri_e2),
        tri_gn=jnp.asarray(tri_gn),
        tri_index=jnp.asarray(tri_index),
        tri_material=jnp.asarray(tri_material),
        tri_primitive=jnp.asarray(tri_primitive),
        tri_local=jnp.asarray(tri_local),
        vert_normal=jnp.asarray(vert_normal),
        vert_tangent=jnp.asarray(vert_tangent),
        vert_uv=jnp.asarray(vert_uv),
        mat_albedo_factor=jnp.asarray(mats["albedo_factor"].astype(np.uint32)),
        mat_mr_factor=jnp.asarray(
            mats["metal_roughness_factor"].astype(np.uint32)
        ),
        mat_emissive_factor=jnp.asarray(
            mats["emissive_factor"].astype(np.uint32)
        ),
        mat_albedo_tex=jnp.asarray(alb_tex_np),
        mat_mr_tex=jnp.asarray(mr_tex_np),
        mat_emissive_tex=jnp.asarray(emi_tex_np),
        mat_normal_tex=jnp.asarray(nrm_tex_np),
        mat_has_normal_tex=jnp.asarray(has_nrm_np),
        tex_texels=jnp.asarray(tex_texels),
        tex_offset=jnp.asarray(np.asarray(offsets, dtype=np.int32)),
        tex_width=jnp.asarray(np.asarray(widths, dtype=np.int32)),
        tex_height=jnp.asarray(np.asarray(heights, dtype=np.int32)),
        num_triangles=num_triangles,
        # Emissive rgb rides the low 3 bytes of the packed factor
        # (unpack_unorm4x8 xyz); a zero factor zeroes the texture
        # product too, so the scene is statically emissive-free.
        emissive_free=bool(
            (mats["emissive_factor"].astype(np.uint32)
             & np.uint32(0x00FFFFFF) == 0).all()
        ),
    )

    dev.has_textures = len(scene.textures) > 0

    # Packed shading rows: one (34,) f32 gather per hit fetches all
    # three vertices' normals/tangents/uvs + the geometric normal +
    # material/primitive ids (render/shading.py fast path).
    i0, i1, i2 = tri_index[:, 0], tri_index[:, 1], tri_index[:, 2]
    attr = np.concatenate(
        [
            vert_normal[i0], vert_normal[i1], vert_normal[i2],      # 0:9
            vert_tangent[i0], vert_tangent[i1], vert_tangent[i2],   # 9:21
            vert_uv[i0], vert_uv[i1], vert_uv[i2],                  # 21:27
            tri_gn,                                                 # 27:30
            np.ascontiguousarray(tri_material).view(np.float32)[:, None],
            np.ascontiguousarray(tri_primitive).view(np.float32)[:, None],
            np.ascontiguousarray(tri_local).view(np.float32)[:, None],
            np.zeros((tri_gn.shape[0], 1), np.float32),             # pad: 34
        ],
        axis=1,
    ).astype(np.float32)
    dev.tri_attr = jnp.asarray(attr)

    mat_packed = np.stack(
        [
            mats["albedo_factor"].astype(np.uint32),
            mats["metal_roughness_factor"].astype(np.uint32),
            mats["emissive_factor"].astype(np.uint32),
            alb_tex_np.astype(np.uint32),
            mr_tex_np.astype(np.uint32),
            emi_tex_np.astype(np.uint32),
            nrm_tex_np.astype(np.uint32),
            has_nrm_np.astype(np.uint32),
        ],
        axis=1,
    )
    dev.mat_packed = jnp.asarray(mat_packed)

    if bvh is not None:
        from vulkan_pathtracer_tpu.ops.bvh import octant_orders, tree_depth

        dev.bvh_left = jnp.asarray(bvh.left_child)
        dev.bvh_right = jnp.asarray(bvh.right_child)
        dev.bvh_leaf_first_build = jnp.asarray(bvh.leaf_first)
        dev.bvh_leaf_count_build = jnp.asarray(bvh.leaf_count)
        dev.bvh_depth = tree_depth(bvh)
        dev.max_leaf_size = max_leaf_size
        if octant_order:
            skip8, leaf_first8, leaf_count8, perm8 = octant_orders(bvh)
            n_nodes = bvh.node_count
            # Globalize skip pointers: block o lives at [o*Nn, (o+1)*Nn).
            offsets = (np.arange(8, dtype=np.int32) * n_nodes)[:, None]
            skip_local = skip8.reshape(-1)
            skip_g = (skip8 + offsets).reshape(-1)
            lf = leaf_first8.reshape(-1)
            lc = leaf_count8.reshape(-1)
            dev.bvh_skip = jnp.asarray(skip_g)
            dev.bvh_leaf_first = jnp.asarray(lf)
            dev.bvh_leaf_count = jnp.asarray(lc)
            perm_flat = perm8.reshape(-1)
            dev.bvh_perm = jnp.asarray(perm_flat)
            bmin_s = bvh.bmin[perm_flat]
            bmax_s = bvh.bmax[perm_flat]
            dev.bvh_bmin = jnp.asarray(bmin_s)
            dev.bvh_bmax = jnp.asarray(bmax_s)
            dev.bvh_orders = 8
        else:
            skip_g = bvh.skip
            skip_local = bvh.skip
            lf = bvh.leaf_first
            lc = bvh.leaf_count
            bmin_s = bvh.bmin
            bmax_s = bvh.bmax
            dev.bvh_bmin = jnp.asarray(bmin_s)
            dev.bvh_bmax = jnp.asarray(bmax_s)
            dev.bvh_skip = jnp.asarray(skip_g)
            dev.bvh_leaf_first = jnp.asarray(lf)
            dev.bvh_leaf_count = jnp.asarray(lc)
            dev.bvh_perm = jnp.arange(bvh.node_count, dtype=jnp.int32)
            dev.bvh_orders = 1

        # Packed records: [bmin, bmax, bits(skip), bits(leaf_first|-1)].
        # Skip pointers are LOCAL to their octant block (traversal adds
        # the block base).
        tail = np.stack(
            [skip_local.astype(np.int32).view(np.float32),
             lf.astype(np.int32).view(np.float32)], axis=1,
        )
        dev.bvh_packed_tail = jnp.asarray(tail)
        dev.bvh_packed = jnp.asarray(
            np.concatenate([bmin_s, bmax_s, tail], axis=1).astype(np.float32)
        )
        # Host-side scene bounds (root AABB) for camera/orbit setup.
        # Plain attribute — does NOT survive pytree flatten/unflatten
        # (jit/replicate).
        dev.root_bounds_host = (
            np.asarray(bvh.bmin[0], np.float32).copy(),
            np.asarray(bvh.bmax[0], np.float32).copy(),
        )
        n_blocks = (bvh.leaf_first.max() // max_leaf_size) + 1
        flat = np.concatenate(
            [np.asarray(tri_v0), np.asarray(tri_e1), np.asarray(tri_e2)],
            axis=1,
        )[: n_blocks * max_leaf_size]
        dev.tri_blocks = jnp.asarray(
            flat.reshape(n_blocks, max_leaf_size * 9)
        )
    return dev
