"""Differentiability: gradients w.r.t. vertices and materials.

A brand-new capability over the reference (forward-only renderer); the
contract comes from BASELINE.md: pixel gradients w.r.t. vertex positions,
normals, and material colors, verified against finite differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracebvh_tpu import Camera, RenderConfig, render_frame
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles

CFG = RenderConfig(width=24, height=24, bounces=1, dtype="float64",
                   texture_dtype="float32")


def _loss_fn(scene, cam, cfg, target):
    img = render_frame(scene, cam, cfg)
    return jnp.mean((img - target) ** 2)


def _setup():
    # extent/tri_size chosen so the 24x24 ortho window sees ~1/3 hit pixels.
    # with_texture matters: the reference's shading model is flat
    # (ambient + diffuse*tex, RayTraceRender.hlsl:28 — no N.L term), so
    # with fixed hit ids the pixel color depends on vertex positions ONLY
    # through the texture uv lookup; untextured scenes correctly have zero
    # vertex gradient away from silhouettes.
    scene_h = random_triangles(
        40, seed=11, extent=8.0, tri_size=2.0, with_texture=True
    )
    scene = scene_to_device(scene_h, dtype=jnp.float64)
    cam = Camera.default(jnp.float64)
    target = jnp.zeros((CFG.height, CFG.width, 4), jnp.float64)
    return scene, cam, target


def test_grad_materials_fd():
    with jax.enable_x64(True):
        scene, cam, target = _setup()

        def loss_of_diffuse(d):
            s = scene.replace(materials=scene.materials.replace(diffuse=d))
            return _loss_fn(s, cam, CFG, target)

        g = jax.grad(loss_of_diffuse)(scene.materials.diffuse)
        assert np.isfinite(np.asarray(g)).all()
        # finite differences on a few entries
        eps = 1e-6
        rng = np.random.default_rng(0)
        checked = 0
        for _ in range(6):
            i = rng.integers(0, g.shape[0])
            j = rng.integers(0, 3)
            d0 = scene.materials.diffuse
            dp = d0.at[i, j].add(eps)
            dm = d0.at[i, j].add(-eps)
            fd = (loss_of_diffuse(dp) - loss_of_diffuse(dm)) / (2 * eps)
            if abs(fd) < 1e-12:
                continue
            np.testing.assert_allclose(g[i, j], fd, rtol=1e-4)
            checked += 1
        assert checked >= 2


def test_grad_verts_fd():
    with jax.enable_x64(True):
        scene, cam, target = _setup()

        def loss_of_verts(v):
            return _loss_fn(scene.replace(verts=v), cam, CFG, target)

        g = jax.grad(loss_of_verts)(scene.verts)
        g = np.asarray(g)
        assert np.isfinite(g).all()
        assert np.abs(g).max() > 0

        # FD-check the 8 largest-magnitude gradient entries
        eps = 1e-7
        order = np.argsort(-np.abs(g).ravel())[:8]
        for k in order:
            i, j = divmod(int(k), 3)
            v0 = scene.verts
            fp = loss_of_verts(v0.at[i, j].add(eps))
            fm = loss_of_verts(v0.at[i, j].add(-eps))
            fd = (fp - fm) / (2 * eps)
            np.testing.assert_allclose(g[i, j], fd, rtol=1e-4)


def test_grad_normals_and_camera():
    with jax.enable_x64(True):
        scene, cam, target = _setup()

        g_n = jax.grad(
            lambda n: _loss_fn(scene.replace(normals=n), cam, CFG, target)
        )(scene.normals)
        assert np.isfinite(np.asarray(g_n)).all()

        g_eye = jax.grad(
            lambda e: _loss_fn(scene, cam.replace(eye=e), CFG, target)
        )(cam.eye.astype(jnp.float64))
        assert np.isfinite(np.asarray(g_eye)).all()
        assert np.abs(np.asarray(g_eye)).max() > 0


def test_train_step_lr_takes_effect():
    """--lr must actually change the step (a train_step that rebuilds
    the optimizer with the default lr inside jit silently
    ignores the CLI flag — adam's init is lr-independent, so only the
    update reveals the bug)."""
    from raytracebvh_tpu.models.inverse import (
        init_params,
        make_optimizer,
        train_step,
    )

    scene_h = random_triangles(
        12, seed=3, extent=8.0, tri_size=2.0, with_texture=True
    )
    scene = scene_to_device(scene_h)
    cam = Camera.default()
    cfg = RenderConfig(width=16, height=16, bounces=0)
    target = jnp.zeros((cfg.height, cfg.width, 4), jnp.float32)

    params = init_params(scene)
    opt_state = make_optimizer(1e-2).init(params)
    p_a, _, _ = train_step(params, opt_state, scene, cam, target, cfg, 1e-2)
    p_b, _, _ = train_step(params, opt_state, scene, cam, target, cfg, 1e-4)
    da = np.abs(np.asarray(p_a.diffuse) - np.asarray(params.diffuse)).max()
    db = np.abs(np.asarray(p_b.diffuse) - np.asarray(params.diffuse)).max()
    assert da > 0 and db > 0
    # adam's first step is ~lr * sign(g): the two lrs must differ ~100x
    assert da > db * 10


@pytest.mark.parametrize("dy", [1e-6, -1e-6])
def test_shade_keeps_edge_hits_on_the_triangle_plane(dy):
    """Whether a ray hits is traversal's decision.  The shading recompute
    puts a hit ray that passes just outside the triangle's edge (dy < 0,
    a hit only by the traversal's rounding) on the triangle's plane, like
    one just inside, and its gradients stay finite and of the same size."""
    from types import SimpleNamespace

    from raytracebvh_tpu.core.types import HitRecord
    from raytracebvh_tpu.pipeline import _shade_hit_soa

    with jax.enable_x64(True):
        scene = scene_to_device(
            random_triangles(1, seed=0, with_texture=True), dtype=jnp.float64)
        tri = jnp.array([[0.0, 0.0, 5.0], [1.0, 0.0, 5.0], [0.0, 1.0, 6.0]])
        nrm = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.6, -0.8], [0.6, 0.0, -0.8]])
        mat = jnp.zeros(16).at[15].set(-1.0)  # tex_id -1: untextured
        attrs = jnp.concatenate(
            [tri.ravel(), nrm.ravel(), jnp.zeros(6), mat])[None]
        one = jnp.ones(1, jnp.float64)
        rec = HitRecord(hit=jnp.array([True]), distance=5.0 * one,
                        leaf=jnp.array([0]))

        def shade(attrs, y):
            o3 = (0.3 * one, y * one, 0.0 * one)
            d3 = (0.0 * one, 0.0 * one, one)
            hit_loc, normal, *_ = _shade_hit_soa(
                scene, SimpleNamespace(leaf_attrs=attrs), o3, d3, rec)
            return hit_loc, normal

        hit_loc, normal = shade(attrs, dy)
        # the plane through the triangle: z = 5 + y
        np.testing.assert_allclose(float(hit_loc[2][0]), 5.0 + dy, rtol=1e-12)
        np.testing.assert_allclose(
            [float(c[0]) for c in normal], [0.0, 0.18, -0.94], atol=1e-5)

        def total(a, y):
            hl, n = shade(a, y)
            return sum(jnp.sum(c) for c in hl + n)

        g = np.asarray(jax.grad(total)(attrs, dy))
        g_in = np.asarray(jax.grad(total)(attrs, abs(dy)))
        assert np.isfinite(g).all()
        np.testing.assert_allclose(np.abs(g), np.abs(g_in), rtol=1e-4,
                                   atol=1e-4)
