"""Shadow rays (BASELINE.md config 3): any-hit traversal + golden parity.

The reference has no lights at all (its shading is ambient + diffuse*tex,
RayTraceRender.hlsl:16-29), so shadows are a beyond-reference capability;
the correctness anchor is the brute-force golden model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracebvh_tpu import Camera, RenderConfig, render_frame_jit
from raytracebvh_tpu.camera import camera_matrices
from raytracebvh_tpu.core.types import Rays, scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles
from raytracebvh_tpu.ops.traverse import traverse_any
from raytracebvh_tpu.pipeline import build_bvh
from raytracebvh_tpu.ref.golden import render_golden

EYE = np.array([0.0, 5.0, -100.0])
AT = np.zeros(3)
UP = np.array([0.0, 1.0, 0.0])
LIGHT = (10.0, 80.0, -40.0)


def _render_pair(scene_h, w, h, f64, shadows):
    dtype = jnp.float64 if f64 else jnp.float32
    cfg = RenderConfig(
        width=w, height=h, bounces=1,
        dtype="float64" if f64 else "float32",
        texture_dtype="float32",
        enable_shadows=shadows, light_pos=LIGHT,
    )
    scene = scene_to_device(scene_h, dtype=dtype)
    cam = Camera.default(dtype)
    img = np.asarray(render_frame_jit(scene, cam, cfg))
    gold = render_golden(
        scene_h, EYE, AT, UP, w, h, bounces=1,
        shadows=shadows, light_pos=LIGHT,
    )
    return img, gold


def test_shadows_f64_match_golden():
    scene_h = random_triangles(300, seed=7, with_texture=True)
    with jax.enable_x64(True):
        img, gold = _render_pair(scene_h, 48, 48, f64=True, shadows=True)
    np.testing.assert_allclose(img, gold, atol=1e-9)


def test_shadows_change_image():
    scene_h = random_triangles(300, seed=7, with_texture=True)
    img_on, _ = _render_pair(scene_h, 48, 48, f64=False, shadows=True)
    img_off, _ = _render_pair(scene_h, 48, 48, f64=False, shadows=False)
    assert np.abs(img_on - img_off).max() > 1e-4


def _any_hit_setup(n_tris=300, n_rays=512, seed=11):
    scene_h = random_triangles(n_tris, seed=seed)
    scene = scene_to_device(scene_h)
    cam = Camera.default()
    cfg = RenderConfig(width=8, height=8, bounces=0)
    wvp, wv = camera_matrices(cam, 8, 8)
    bvh = jax.jit(lambda s: build_bvh(s, wvp, wv, cfg))(scene)
    rng = np.random.default_rng(seed)
    origin = jnp.asarray(rng.uniform(-40, 40, (n_rays, 3)), jnp.float32)
    direction = rng.normal(size=(n_rays, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    rays = Rays(origin=origin, direction=jnp.asarray(direction, jnp.float32))
    max_t = jnp.asarray(rng.uniform(5.0, 300.0, n_rays), jnp.float32)
    return bvh, rays, max_t


def test_any_hit_vs_bruteforce():
    """traverse_any == brute-force 'any triangle in (eps, max_t)'."""
    from raytracebvh_tpu.ref.golden import mt_all

    bvh, rays, max_t = _any_hit_setup()
    occ = jax.jit(lambda b, r, m: traverse_any(b, r, 0.01, m))(
        bvh, rays, max_t
    )
    tris = np.asarray(bvh.tri_verts)[np.asarray(bvh.prim) >= 0]
    t_all = mt_all(
        np.asarray(rays.origin, np.float64),
        np.asarray(rays.direction, np.float64),
        tris.astype(np.float64),
    )
    brute = np.any((t_all > 0) & (t_all < np.asarray(max_t)[:, None]), axis=1)
    # f32 vs f64 can flip rays that graze max_t/epsilon boundaries;
    # everything else must agree exactly
    agree = np.asarray(occ) == brute
    assert agree.mean() > 0.99, f"agreement {agree.mean()}"


def test_shadow_grads_flow():
    """Gradients flow through shadowed shading (occlusion is stop-grad)."""
    scene_h = random_triangles(300, seed=7, with_texture=True)
    scene = scene_to_device(scene_h)
    cfg = RenderConfig(width=32, height=32, bounces=0,
                       enable_shadows=True, light_pos=LIGHT,
                       leaf_pad_multiple=64)
    cam = Camera.default()

    def loss(diffuse):
        s = scene.replace(
            materials=scene.materials.replace(diffuse=diffuse)
        )
        from raytracebvh_tpu.pipeline import render_frame

        return jnp.sum(render_frame(s, cam, cfg))

    g = jax.jit(jax.grad(loss))(scene.materials.diffuse)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).sum() > 0
