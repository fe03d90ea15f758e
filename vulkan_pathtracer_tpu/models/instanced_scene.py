"""Two-level BVH / instancing: per-mesh BLAS + TLAS, geometry stored once.

The reference's TLAS references one BLAS per mesh — N instances share
geometry with only a 3x4 transform each (Tlas.zig:33-51,
RaytracingPass.zig:224-352, instance_custom_index = the mesh's first
primitive, Tlas.zig:43-46).  The equivalent built here:

- One object-space BLAS per MESH (binary skip-pointer tree + fixed
  leaf blocks, same machinery as the flat bake), triangles and vertex
  attributes stored ONCE regardless of instance count.
- A small top tree (TLAS) over conservative instance world AABBs.
- The two levels are SPLICED into one preorder skip-pointer array per
  direction octant: each TLAS instance-leaf is replaced by a copy of
  the mesh BLAS *nodes* with world-space conservative AABBs (the
  object box's 8 corners transformed).  Only nodes (32B each) are
  per-instance; triangle data is shared.
- Leaf records pack (instance, global mesh leaf-block) into one
  float-exact integer: ``inst << mb_bits | block`` (< 2^24).  Traversal
  transforms the ray into object space per leaf visit (affine: the
  world t parameter is preserved by NOT normalizing the object-space
  direction); backface culling multiplies the Möller–Trumbore
  determinant by sign(det(M)) to keep the reference's world-winding
  semantics under mirroring transforms.
- Animation: ``update_instance_transforms`` refreshes instance
  matrices + node AABBs entirely on device in O(total nodes) vector
  work — no host re-bake, no triangle work (the VERDICT round-1 gap:
  the flat bake re-baked ALL triangles per frame).

Shading parity: attribute rows are object-space; the hit decode
(render/shading.py) transforms interpolated normals/tangents and the
geometric normal by the instance normal matrix inverse(A) — linear, so
interpolate-then-transform equals the flat bake's
transform-then-interpolate up to f32 rounding.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from vulkan_pathtracer_tpu.models.device_scene import (
    DeviceScene,
    PAD,
    _pad_rows,
    build_device_scene,
    bvh_with_leaf_blocks,
    apply_slot_map,
)
from vulkan_pathtracer_tpu.models.gltf import Scene


LEAF_PACK_BITS = 24  # packed (inst, block) * leaf size must fit int32 hit ids


def _transform_aabb(bmin, bmax, A, t):
    """Conservative world AABB of an object AABB under x -> A@x + t.
    Vectorized over leading axes; classic Arvo corner trick."""
    c = (bmin + bmax) * 0.5
    e = (bmax - bmin) * 0.5
    wc = c @ A.T + t
    we = e @ np.abs(A).T
    return (wc - we).astype(np.float32), (wc + we).astype(np.float32)


def build_instanced_scene(scene: Scene, max_leaf_size: int = 8) -> DeviceScene:
    """Bake a host Scene into an instanced DeviceScene (geometry once,
    per-instance node copies; see module docstring)."""
    from vulkan_pathtracer_tpu.ops.bvh import build_bvh_host, octant_orders

    block = max_leaf_size
    n_inst = len(scene.instances)

    # ---- per-mesh object-space BLAS ----------------------------------------
    mesh_ids = sorted({inst.mesh_index for inst in scene.instances})
    mesh_slot = {m: i for i, m in enumerate(mesh_ids)}
    meshes = []
    vert_base = 0
    tri_arrays = {k: [] for k in (
        "tri_v0", "tri_e1", "tri_e2", "tri_gn", "tri_index",
        "tri_material", "tri_primitive", "tri_local",
    )}
    vert_arrays = {k: [] for k in ("vert_normal", "vert_tangent", "vert_uv")}
    mb_base = [0]
    for m in mesh_ids:
        mesh = scene.meshes[m]
        v0l, e1l, e2l, gnl, idxl, matl, priml, locl = \
            [], [], [], [], [], [], [], []
        for prim_global in range(mesh.start, mesh.end):
            prim = scene.primitives[prim_global]
            idx = prim.indices.reshape(-1, 3).astype(np.int64)
            pos = prim.positions.astype(np.float32)
            v0 = pos[idx[:, 0]]
            e1 = pos[idx[:, 1]] - v0
            e2 = pos[idx[:, 2]] - v0
            gn = np.cross(e1.astype(np.float64), e2.astype(np.float64))
            nrm = np.linalg.norm(gn, axis=1, keepdims=True)
            gn = (gn / np.maximum(nrm, 1e-30)).astype(np.float32)
            tcount = idx.shape[0]
            v0l.append(v0)
            e1l.append(e1)
            e2l.append(e2)
            gnl.append(gn)
            idxl.append((idx + vert_base).astype(np.int32))
            matl.append(np.full(tcount, prim.material_index, np.int32))
            priml.append(np.full(tcount, prim_global, np.int32))
            locl.append(np.arange(tcount, dtype=np.int32))
            vert_arrays["vert_normal"].append(prim.normals)
            vert_arrays["vert_tangent"].append(prim.tangents)
            vert_arrays["vert_uv"].append(prim.uvs)
            vert_base += prim.positions.shape[0]
        v0 = np.concatenate(v0l)
        e1 = np.concatenate(e1l)
        e2 = np.concatenate(e2l)
        bvh, slot_map = bvh_with_leaf_blocks(v0, e1, e2, block)
        arr = {
            "tri_v0": apply_slot_map(v0, slot_map),
            "tri_e1": apply_slot_map(e1, slot_map),
            "tri_e2": apply_slot_map(e2, slot_map),
            "tri_gn": apply_slot_map(np.concatenate(gnl), slot_map),
            "tri_index": apply_slot_map(np.concatenate(idxl), slot_map),
            "tri_material": apply_slot_map(np.concatenate(matl), slot_map),
            "tri_primitive": apply_slot_map(np.concatenate(priml), slot_map),
            "tri_local": apply_slot_map(np.concatenate(locl), slot_map),
        }
        for k in tri_arrays:
            tri_arrays[k].append(arr[k])
        n_blocks_m = arr["tri_v0"].shape[0] // block
        skip8, lf8, lc8, perm8 = octant_orders(bvh)
        meshes.append(dict(
            bvh=bvh, skip8=skip8, lf8=lf8, perm8=perm8,
            n_blocks=n_blocks_m, n_nodes=bvh.node_count,
        ))
        mb_base.append(mb_base[-1] + n_blocks_m)

    total_blocks = mb_base[-1]
    mb_bits = max(int(np.ceil(np.log2(max(total_blocks, 2)))), 1)
    if (n_inst << mb_bits) >= (1 << LEAF_PACK_BITS):
        raise ValueError(
            f"instanced scene too large to pack: {n_inst} instances x "
            f"{total_blocks} leaf blocks needs more than "
            f"{LEAF_PACK_BITS} bits"
        )

    # ---- instance transforms + world boxes ---------------------------------
    inst_mesh = np.array(
        [mesh_slot[inst.mesh_index] for inst in scene.instances], np.int32
    )
    M = np.stack([inst.transform for inst in scene.instances]).astype(
        np.float64
    )  # (I, 4, 4)
    A = M[:, :3, :3]
    t = M[:, :3, 3]
    inst_root_obj = np.stack([
        np.concatenate([meshes[mi]["bvh"].bmin[0], meshes[mi]["bvh"].bmax[0]])
        for mi in inst_mesh
    ]).astype(np.float32)  # (I, 6) mesh root object boxes
    root_bmin = np.empty((n_inst, 3), np.float32)
    root_bmax = np.empty((n_inst, 3), np.float32)
    for i in range(n_inst):
        root_bmin[i], root_bmax[i] = _transform_aabb(
            inst_root_obj[i, :3], inst_root_obj[i, 3:], A[i], t[i]
        )

    # ---- top tree (TLAS) over instance AABBs -------------------------------
    # Fake triangles whose AABBs equal the instance boxes (v0 = bmin,
    # e1 = extent, e2 = 0) feed the standard builder with 1-item leaves.
    top = build_bvh_host(root_bmin, root_bmax - root_bmin,
                         np.zeros_like(root_bmin), max_leaf_size=1,
                         use_native=False)
    top_skip8, top_lf8, _top_lc8, top_perm8 = octant_orders(top)
    n_top = top.node_count

    # ---- assembly: splice instance subtrees into the top preorder ----------
    orders = 8
    # Per-mesh per-octant precomputations shared by all instances:
    #   object boxes in octant order, leaf packed-block values, skips.
    mesh_oct = []
    for md in meshes:
        per_o = []
        for o in range(orders):
            perm = md["perm8"][o]
            obmin = md["bvh"].bmin[perm]
            obmax = md["bvh"].bmax[perm]
            lf = md["lf8"][o]
            skips = md["skip8"][o]
            per_o.append((obmin, obmax, lf, skips))
        mesh_oct.append(per_o)

    asm = {k: [] for k in ("bmin", "bmax", "skip", "leaf", "inst", "src")}
    top_asm_pos = np.zeros((orders, n_top), np.int32)
    mesh_obj_boxes = []   # per octant concat of mesh object boxes
    moct_base = np.zeros((orders, len(meshes)), np.int64)
    total_mesh_nodes = sum(md["n_nodes"] for md in meshes)

    for o in range(orders):
        # Octant-o mesh object-box table (refit gathers from this).
        base = 0
        obj_bmin_l, obj_bmax_l = [], []
        for mi, md in enumerate(meshes):
            moct_base[o, mi] = base
            obj_bmin_l.append(mesh_oct[mi][o][0])
            obj_bmax_l.append(mesh_oct[mi][o][1])
            base += md["n_nodes"]
        mesh_obj_boxes.append(
            (np.concatenate(obj_bmin_l), np.concatenate(obj_bmax_l))
        )

        # Assembled position of each top octant-order slot.
        sizes = np.ones(n_top, np.int64)
        for i in range(n_top):
            tlf = top_lf8[o, i]
            if tlf >= 0:
                inst = int(top.tri_order[tlf])
                sizes[i] = meshes[inst_mesh[inst]]["n_nodes"]
        pos = np.zeros(n_top + 1, np.int64)
        np.cumsum(sizes, out=pos[1:])
        total = pos[n_top]

        bmin_o = np.empty((total, 3), np.float32)
        bmax_o = np.empty((total, 3), np.float32)
        skip_o = np.empty(total, np.int64)
        leaf_o = np.full(total, -1.0, np.float64)
        inst_o = np.full(total, -1, np.int32)
        src_o = np.full(total, 0, np.int32)

        for i in range(n_top):
            p = pos[i]
            tlf = top_lf8[o, i]
            esc = pos[top_skip8[o, i]]
            bld = top_perm8[o, i]
            if tlf < 0:
                # top internal node
                bmin_o[p] = top.bmin[bld]
                bmax_o[p] = top.bmax[bld]
                skip_o[p] = esc
                # top_asm_pos is keyed by BUILD node id so the refit
                # sweep (build order) scatters directly.
                top_asm_pos[o, bld] = p
            else:
                inst = int(top.tri_order[tlf])
                mi = inst_mesh[inst]
                md = meshes[mi]
                obmin, obmax, lf, skips = mesh_oct[mi][o]
                nb, nB = _transform_aabb(obmin, obmax, A[inst], t[inst])
                nn = md["n_nodes"]
                bmin_o[p:p + nn] = nb
                bmax_o[p:p + nn] = nB
                # skips: mesh-local (0..nn) -> assembled; exits -> esc
                sk = skips.astype(np.int64) + p
                sk[skips >= nn] = esc
                skip_o[p:p + nn] = sk
                packed = np.where(
                    lf >= 0,
                    (np.int64(inst) << mb_bits)
                    | ((lf.astype(np.int64) // block) + mb_base[mi]),
                    -1,
                )
                leaf_o[p:p + nn] = packed.astype(np.float64)
                inst_o[p:p + nn] = inst
                # Index into the OCTANT-o slice of the concatenated
                # mesh object-box table (tables are stacked per octant
                # because node order is octant-permuted).
                src_o[p:p + nn] = (
                    o * total_mesh_nodes + moct_base[o, mi]
                    + np.arange(nn)
                ).astype(np.int32)
                top_asm_pos[o, bld] = p
        asm["bmin"].append(bmin_o)
        asm["bmax"].append(bmax_o)
        asm["skip"].append(skip_o)
        asm["leaf"].append(leaf_o)
        asm["inst"].append(inst_o)
        asm["src"].append(src_o)

    nn_total = asm["bmin"][0].shape[0]
    bmin_s = np.concatenate(asm["bmin"])
    bmax_s = np.concatenate(asm["bmax"])
    skip_local = np.concatenate(asm["skip"]).astype(np.int32)
    leaf_vals = np.concatenate(asm["leaf"]).astype(np.int32)
    asm_inst = np.concatenate(asm["inst"])
    asm_src = np.concatenate(asm["src"])

    # ---- device arrays ------------------------------------------------------
    tri = {k: np.concatenate(v) for k, v in tri_arrays.items()}
    num_triangles = tri["tri_v0"].shape[0]
    for k in tri:
        tri[k] = _pad_rows(tri[k], PAD)
    vert = {k: np.concatenate(v) for k, v in vert_arrays.items()}

    # Reuse the flat bake for materials/textures by building a minimal
    # DeviceScene from the SAME host scene with zero instances baked —
    # simplest: construct via the standard path on an empty-geometry
    # clone is awkward, so inline the material/texture packing here by
    # delegating to build_device_scene on the original scene with
    # build_bvh=False and overriding geometry/BVH fields.
    base_dev = build_device_scene(scene, build_bvh=False)

    i0, i1, i2 = tri["tri_index"][:, 0], tri["tri_index"][:, 1], \
        tri["tri_index"][:, 2]
    vn = vert["vert_normal"]
    vt = vert["vert_tangent"]
    vu = vert["vert_uv"]
    attr = np.concatenate(
        [
            vn[i0], vn[i1], vn[i2],
            vt[i0], vt[i1], vt[i2],
            vu[i0], vu[i1], vu[i2],
            tri["tri_gn"],
            np.ascontiguousarray(tri["tri_material"]).view(np.float32)[:, None],
            np.ascontiguousarray(tri["tri_primitive"]).view(np.float32)[:, None],
            np.ascontiguousarray(tri["tri_local"]).view(np.float32)[:, None],
            np.zeros((tri["tri_gn"].shape[0], 1), np.float32),
        ],
        axis=1,
    ).astype(np.float32)

    # Instance tables: inverse transform rows (object <- world) and the
    # normal matrix inv(A) (triangle.glsl row-vector quirk parity).
    Ainv = np.linalg.inv(A)                      # (I, 3, 3)
    inv_t = -np.einsum("ijk,ik->ij", Ainv, t)    # o' = Ainv o + inv_t
    det_sign = np.sign(np.linalg.det(A)).astype(np.float32)
    inst_inv = np.zeros((n_inst, 16), np.float32)
    inst_inv[:, 0:9] = Ainv.reshape(n_inst, 9)
    inst_inv[:, 9:12] = inv_t
    inst_inv[:, 12] = np.where(det_sign == 0, 1.0, det_sign)
    inst_nrm = Ainv.reshape(n_inst, 9).astype(np.float32)  # N = inv(A)

    from vulkan_pathtracer_tpu.ops.bvh import tree_depth

    dev = DeviceScene(
        tri_v0=jnp.asarray(tri["tri_v0"]),
        tri_e1=jnp.asarray(tri["tri_e1"]),
        tri_e2=jnp.asarray(tri["tri_e2"]),
        tri_gn=jnp.asarray(tri["tri_gn"]),
        tri_index=jnp.asarray(tri["tri_index"]),
        tri_material=jnp.asarray(tri["tri_material"]),
        tri_primitive=jnp.asarray(tri["tri_primitive"]),
        tri_local=jnp.asarray(tri["tri_local"]),
        vert_normal=jnp.asarray(vn),
        vert_tangent=jnp.asarray(vt),
        vert_uv=jnp.asarray(vu),
        mat_albedo_factor=base_dev.mat_albedo_factor,
        mat_mr_factor=base_dev.mat_mr_factor,
        mat_emissive_factor=base_dev.mat_emissive_factor,
        mat_albedo_tex=base_dev.mat_albedo_tex,
        mat_mr_tex=base_dev.mat_mr_tex,
        mat_emissive_tex=base_dev.mat_emissive_tex,
        mat_normal_tex=base_dev.mat_normal_tex,
        mat_has_normal_tex=base_dev.mat_has_normal_tex,
        tex_texels=base_dev.tex_texels,
        tex_offset=base_dev.tex_offset,
        tex_width=base_dev.tex_width,
        tex_height=base_dev.tex_height,
        num_triangles=num_triangles,
        max_leaf_size=block,
    )
    dev.has_textures = base_dev.has_textures
    dev.emissive_free = base_dev.emissive_free
    dev.mat_packed = base_dev.mat_packed
    dev.tri_attr = jnp.asarray(attr)

    dev.bvh_bmin = jnp.asarray(bmin_s)
    dev.bvh_bmax = jnp.asarray(bmax_s)
    offsets = (np.arange(orders, dtype=np.int64) * nn_total)[:, None]
    skip_g = (
        np.concatenate(asm["skip"]).reshape(orders, nn_total) + offsets
    ).reshape(-1).astype(np.int32)
    dev.bvh_skip = jnp.asarray(skip_g)
    dev.bvh_leaf_first = jnp.asarray(leaf_vals)
    dev.bvh_leaf_count = jnp.asarray(
        np.where(leaf_vals >= 0, block, 0).astype(np.int32)
    )
    dev.bvh_orders = orders
    dev.bvh_depth = tree_depth(top) + max(
        tree_depth(md["bvh"]) for md in meshes
    )
    tail = np.stack(
        [skip_local.view(np.float32), leaf_vals.view(np.float32)], axis=1
    )
    dev.bvh_packed_tail = jnp.asarray(tail)
    dev.bvh_packed = jnp.asarray(
        np.concatenate([bmin_s, bmax_s, tail], axis=1).astype(np.float32)
    )
    flat = np.concatenate(
        [tri["tri_v0"], tri["tri_e1"], tri["tri_e2"]], axis=1
    )[: total_blocks * block]
    dev.tri_blocks = jnp.asarray(flat.reshape(total_blocks, block * 9))

    # Instancing metadata.
    dev.instanced = True
    dev.mb_bits = mb_bits
    dev.inst_inv = jnp.asarray(inst_inv)
    dev.inst_nrm = jnp.asarray(inst_nrm)
    dev.asm_inst = jnp.asarray(asm_inst)
    dev.asm_src = jnp.asarray(asm_src)
    dev.mesh_obj_bmin = jnp.asarray(
        np.concatenate([b[0] for b in mesh_obj_boxes])
    )
    dev.mesh_obj_bmax = jnp.asarray(
        np.concatenate([b[1] for b in mesh_obj_boxes])
    )
    dev.inst_root_obj = jnp.asarray(inst_root_obj)
    dev.top_left = jnp.asarray(top.left_child)
    dev.top_right = jnp.asarray(top.right_child)
    top_leaf_inst = np.where(
        top.leaf_first >= 0,
        top.tri_order[np.maximum(top.leaf_first, 0)], -1,
    ).astype(np.int32)
    dev.top_leaf_inst = jnp.asarray(top_leaf_inst)
    dev.top_asm_pos = jnp.asarray(top_asm_pos)
    dev.top_depth = tree_depth(top)
    return dev


def update_instance_transforms(scene: DeviceScene, transforms) -> DeviceScene:
    """Return a copy of an instanced DeviceScene with new 4x4 instance
    transforms applied — pure device work, O(total nodes) vector math:

    1. instance inverse/normal matrices,
    2. per-instance node AABBs = conservative transform of the shared
       mesh OBJECT node boxes (one gather + corner arithmetic),
    3. top (TLAS) AABBs by a bottom-up sweep over the tiny top tree,
    4. repacked traversal arrays (bvh_packed).

    This replaces the flat bake's per-frame host re-bake of every
    triangle (models/animation.py) for instanced scenes.
    """
    import dataclasses

    transforms = jnp.asarray(transforms, jnp.float32)  # (I, 4, 4)
    A = transforms[:, :3, :3]
    t = transforms[:, :3, 3]
    Ainv = jnp.linalg.inv(A.astype(jnp.float64)).astype(jnp.float32)
    inv_t = -jnp.einsum("ijk,ik->ij", Ainv, t)
    det = jnp.linalg.det(A)
    det_sign = jnp.where(det < 0, -1.0, 1.0).astype(jnp.float32)
    inst_inv = jnp.concatenate(
        [Ainv.reshape(-1, 9), inv_t, det_sign[:, None],
         jnp.zeros((A.shape[0], 3), jnp.float32)], axis=1,
    )
    inst_nrm = Ainv.reshape(-1, 9)

    # --- per-node world boxes ---
    orders = scene.bvh_orders
    nn_total = scene.bvh_packed.shape[0] // orders
    inst_ids = jnp.maximum(scene.asm_inst, 0)
    is_inst = scene.asm_inst >= 0
    obmin = jnp.take(scene.mesh_obj_bmin, scene.asm_src, axis=0)
    obmax = jnp.take(scene.mesh_obj_bmax, scene.asm_src, axis=0)
    # asm_src already encodes the per-octant mesh-box-table base, so a
    # single gather covers all octants.
    Ai = jnp.take(A, inst_ids, axis=0)
    ti = jnp.take(t, inst_ids, axis=0)
    c = (obmin + obmax) * 0.5
    e = (obmax - obmin) * 0.5
    wc = jnp.einsum("njk,nk->nj", Ai, c) + ti
    we = jnp.einsum("njk,nk->nj", jnp.abs(Ai), e)
    nbmin = wc - we
    nbmax = wc + we
    bmin_s = jnp.where(is_inst[:, None], nbmin, scene.bvh_bmin)
    bmax_s = jnp.where(is_inst[:, None], nbmax, scene.bvh_bmax)

    # --- top tree sweep (build order) ---
    n_top = scene.top_left.shape[0]
    root_obj = scene.inst_root_obj  # (I, 6)
    rc = (root_obj[:, :3] + root_obj[:, 3:]) * 0.5
    re = (root_obj[:, 3:] - root_obj[:, :3]) * 0.5
    rwc = jnp.einsum("ijk,ik->ij", A, rc) + t
    rwe = jnp.einsum("ijk,ik->ij", jnp.abs(A), re)
    inst_wmin = rwc - rwe
    inst_wmax = rwc + rwe

    is_leaf_top = scene.top_leaf_inst >= 0
    li = jnp.maximum(scene.top_leaf_inst, 0)
    tb_min = jnp.where(is_leaf_top[:, None],
                       jnp.take(inst_wmin, li, axis=0),
                       jnp.float32(3e38))
    tb_max = jnp.where(is_leaf_top[:, None],
                       jnp.take(inst_wmax, li, axis=0),
                       jnp.float32(-3e38))
    lc = jnp.maximum(scene.top_left, 0)
    rcld = jnp.maximum(scene.top_right, 0)
    internal = (~is_leaf_top)[:, None]
    for _ in range(max(scene.top_depth - 1, 0)):
        cmin = jnp.minimum(jnp.take(tb_min, lc, axis=0),
                           jnp.take(tb_min, rcld, axis=0))
        cmax = jnp.maximum(jnp.take(tb_max, lc, axis=0),
                           jnp.take(tb_max, rcld, axis=0))
        tb_min = jnp.where(internal, cmin, tb_min)
        tb_max = jnp.where(internal, cmax, tb_max)

    # Scatter top boxes into the assembled arrays (internal top nodes
    # only; instance-root boxes were already written by the node pass
    # above... instance subtree ROOT rows are instance nodes ✓).
    flat_pos = (
        scene.top_asm_pos
        + (jnp.arange(orders, dtype=jnp.int32) * nn_total)[:, None]
    ).reshape(-1)
    top_internal = jnp.tile(~is_leaf_top, (orders,))
    src_min = jnp.tile(tb_min, (orders, 1))
    src_max = jnp.tile(tb_max, (orders, 1))
    # Leaf entries route to an out-of-bounds index and are dropped
    # (their assembled rows are instance-subtree roots, already updated
    # by the per-node pass above).
    oob = jnp.int32(orders * nn_total)
    keep_pos = jnp.where(top_internal, flat_pos, oob)
    bmin_s = bmin_s.at[keep_pos].set(src_min, mode="drop")
    bmax_s = bmax_s.at[keep_pos].set(src_max, mode="drop")

    updates = dict(
        inst_inv=inst_inv, inst_nrm=inst_nrm,
        bvh_bmin=bmin_s, bvh_bmax=bmax_s,
        bvh_packed=jnp.concatenate(
            [bmin_s, bmax_s, scene.bvh_packed_tail], axis=1
        ),
    )
    return dataclasses.replace(scene, **updates)
