"""glTF loader contract tests (Scene.zig parity)."""

import numpy as np
import pytest

from assets import procedural
from vulkan_pathtracer_tpu.models import gltf


def test_box_roundtrip(box_glb):
    scene = gltf.load(box_glb)
    assert len(scene.meshes) == 1
    assert len(scene.primitives) == 1
    prim = scene.primitives[0]
    assert prim.triangle_count == 12
    assert prim.positions.shape == (24, 3)
    assert prim.normals.shape == (24, 3)
    assert prim.tangents.shape == (24, 4)
    assert prim.uvs.shape == (24, 2)
    assert not prim.uint32_indices  # 24 verts -> u16
    assert prim.info == 0  # material 0, u16 flag clear
    assert len(scene.instances) == 1
    np.testing.assert_allclose(scene.instances[0].transform, np.eye(4))


def test_material_packing(box_glb):
    scene = gltf.load(box_glb)
    m = scene.materials[0]
    # base color (0.8, 0.1, 0.1): trunc(0.8*255)=204, trunc(0.1*255)=25
    assert m["albedo_factor"] == (204 | (25 << 8) | (25 << 16))
    # roughness 0.6 -> g, metallic 0 -> b
    assert m["metal_roughness_factor"] == (int(0.6 * 255) << 8)
    assert m["albedo_texture_index"] == gltf.INVALID_TEXTURE_INDEX


def test_textured_sphere_textures(sphere_glb):
    scene = gltf.load(sphere_glb)
    assert len(scene.textures) == 4
    for tex in scene.textures:
        assert tex.data.shape == (tex.height, tex.width, 4)
        assert tex.data.dtype == np.uint8
    m = scene.materials[0]
    assert m["albedo_texture_index"] == 0
    assert m["normal_texture_index"] == 2


def test_instancing_nodes(columns_glb):
    scene = gltf.load(columns_glb)
    assert len(scene.instances) == 17  # 4x4 columns + floor
    translations = {tuple(i.transform[:3, 3]) for i in scene.instances}
    assert len(translations) > 1


def test_missing_tangents_raises(tmp_path):
    # Build a GLB then strip TANGENT from the JSON chunk.
    import json
    import struct

    path = tmp_path / "box.glb"
    procedural.make_box(str(path))
    raw = path.read_bytes()
    json_len, _ = struct.unpack_from("<II", raw, 12)
    doc = json.loads(raw[20:20 + json_len])
    del doc["meshes"][0]["primitives"][0]["attributes"]["TANGENT"]
    new_json = json.dumps(doc, separators=(",", ":")).encode()
    new_json += b" " * ((-len(new_json)) % 4)
    rest = raw[20 + json_len:]
    total = 12 + 8 + len(new_json) + len(rest)
    out = struct.pack("<III", 0x46546C67, 2, total)
    out += struct.pack("<II", len(new_json), 0x4E4F534A) + new_json + rest
    bad = tmp_path / "bad.glb"
    bad.write_bytes(out)
    with pytest.raises(gltf.GltfNoTangents):
        gltf.load(str(bad))


def test_too_many_scenes_raises(tmp_path):
    import json
    import struct

    path = tmp_path / "box.glb"
    procedural.make_box(str(path))
    raw = path.read_bytes()
    json_len, _ = struct.unpack_from("<II", raw, 12)
    doc = json.loads(raw[20:20 + json_len])
    doc["scenes"].append({"nodes": []})
    new_json = json.dumps(doc, separators=(",", ":")).encode()
    new_json += b" " * ((-len(new_json)) % 4)
    rest = raw[20 + json_len:]
    total = 12 + 8 + len(new_json) + len(rest)
    out = struct.pack("<III", 0x46546C67, 2, total)
    out += struct.pack("<II", len(new_json), 0x4E4F534A) + new_json + rest
    bad = tmp_path / "two_scenes.glb"
    bad.write_bytes(out)
    with pytest.raises(gltf.TooManyScenes):
        gltf.load(str(bad))


def test_gltf_text_with_data_uri(tmp_path, box_glb):
    """.gltf with embedded base64 buffer parses identically."""
    import base64
    import json
    import struct

    raw = open(box_glb, "rb").read()
    json_len, _ = struct.unpack_from("<II", raw, 12)
    doc = json.loads(raw[20:20 + json_len])
    bin_off = 20 + json_len + 8
    binary = raw[bin_off:]
    doc["buffers"][0]["uri"] = (
        "data:application/octet-stream;base64,"
        + base64.b64encode(binary).decode()
    )
    p = tmp_path / "box.gltf"
    p.write_text(json.dumps(doc))
    scene = gltf.load(str(p))
    assert scene.primitives[0].triangle_count == 12


def test_atrium_scene_loads_and_builds(tmp_path):
    """Sponza-class stand-in: enclosed interior, multi-material,
    panel/colonnade geometry; loader + BVH invariants at low detail."""
    from assets.procedural import make_atrium
    from vulkan_pathtracer_tpu.models.device_scene import build_device_scene
    from vulkan_pathtracer_tpu.ops.bvh import build_bvh_host, validate_bvh

    path = str(tmp_path / "atrium.glb")
    make_atrium(path, detail=0.15, n_materials=8)
    scene = gltf.load(path)
    assert scene.triangle_count > 3000
    assert len(scene.materials) == 8
    dev = build_device_scene(scene, build_bvh=True, max_leaf_size=8)
    assert dev.bvh_packed is not None
    import numpy as np

    v0 = np.asarray(dev.tri_v0)[: dev.num_triangles]
    e1 = np.asarray(dev.tri_e1)[: dev.num_triangles]
    e2 = np.asarray(dev.tri_e2)[: dev.num_triangles]
    bvh = build_bvh_host(v0, e1, e2, max_leaf_size=8)
    validate_bvh(bvh, v0[bvh.tri_order], e1[bvh.tri_order],
                 e2[bvh.tri_order])
