"""OBJ/MTL loader vs the reference's parsing semantics."""

import numpy as np
import pytest

from raytracebvh_tpu.io.bmp import read_bmp, write_bmp
from raytracebvh_tpu.utils.assets import find_asset


def test_rect_obj(rect_scene):
    s = rect_scene
    # 12 faces (SURVEY.md section 2.4); Rect.obj's trailing Cube object has
    # verts but no faces
    assert s.num_faces == 12
    assert s.indices.shape == (36,)
    assert s.mat_index.shape == (12,)
    # dedup: 8 positions x varying normals/uv -> < 36 unique verts
    assert s.num_verts < 36
    m = s.materials
    assert m.count == 1
    np.testing.assert_allclose(m.shininess[0], 94.117647, rtol=1e-5)
    np.testing.assert_allclose(m.diffuse[0, :3], [0.64, 0.64, 0.64], rtol=1e-5)
    np.testing.assert_allclose(m.specular[0, :3], [0.5, 0.5, 0.5], rtol=1e-5)
    np.testing.assert_allclose(m.ambient[0, :3], [0.0, 0.0, 0.0], atol=1e-7)
    assert m.alpha[0] == 1.0
    # Balls.bmp is loadable -> texture id assigned
    assert m.tex_id[0] == 0
    assert s.textures.shape[0] == 1
    assert tuple(s.tex_hw[0]) == (1000, 1600)


def test_test_obj_counts(test_scene):
    s = test_scene
    assert s.num_faces == 1952  # SURVEY.md section 2.4
    assert s.materials.count >= 3


def test_image_test_obj_counts():
    path = find_asset("Image_Test.obj")
    if path is None:
        pytest.skip("Image_Test.obj not available")
    from raytracebvh_tpu.io.obj import load_obj

    s = load_obj(path)
    assert s.num_faces == 3072
    assert s.materials.count == 1
    assert s.materials.tex_id[0] == 0


def test_bmp_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (33, 47, 3)).astype(np.uint8)
    p = str(tmp_path / "t.bmp")
    write_bmp(p, img)
    back = read_bmp(p)
    np.testing.assert_array_equal(img, back)


def test_read_reference_out_bmp():
    """The reference's committed output image parses (golden-image
    candidate; reference: out.bmp written by SaveBMP.cpp:3-62)."""
    p = find_asset("out.bmp")
    if p is None:
        pytest.skip("reference out.bmp not available")
    img = read_bmp(p)
    assert img.ndim == 3 and img.shape[2] == 3


def test_negative_relative_indices(tmp_path):
    """OBJ spec: negative indices are relative to the current end of the
    list (the reference's sscanf %i loader would misread these; we
    support them properly)."""
    p = tmp_path / "rel.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"
    )
    from raytracebvh_tpu.io.obj import load_obj

    scene = load_obj(str(p), backend="python")
    assert scene.num_faces == 1
    np.testing.assert_allclose(scene.verts[scene.indices.reshape(3)][1],
                               [1, 0, 0])


def test_out_of_range_index_raises(tmp_path):
    p = tmp_path / "bad.obj"
    p.write_text("v 0 0 0\nf 1 2 3\n")
    from raytracebvh_tpu.io.obj import load_obj

    with pytest.raises(ValueError, match="out of range"):
        load_obj(str(p), backend="python")


def test_empty_mesh_raises(tmp_path):
    p = tmp_path / "empty.obj"
    p.write_text("v 0 0 0\nv 1 0 0\n")
    from raytracebvh_tpu.io.obj import load_obj

    with pytest.raises(ValueError, match="no faces"):
        load_obj(str(p), backend="python")


def test_nonfinite_verts_raise(tmp_path):
    p = tmp_path / "nan.obj"
    p.write_text("v nan 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    from raytracebvh_tpu.io.obj import load_obj

    with pytest.raises(ValueError, match="non-finite"):
        load_obj(str(p), backend="python")
