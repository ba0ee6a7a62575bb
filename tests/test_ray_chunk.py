"""ray_chunk tiling must not change the image or the gradients."""

import jax
import numpy as np

from raytracebvh_tpu import Camera, RenderConfig, render_frame_jit
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.inverse import init_params, loss_fn
from raytracebvh_tpu.models.procedural import random_triangles


def test_ray_chunk_image_identical():
    scene = scene_to_device(random_triangles(150, seed=9, with_texture=True))
    cam = Camera.default()
    base = RenderConfig(width=32, height=32, bounces=2, ortho_scale=0.2)
    a = np.asarray(render_frame_jit(scene, cam, base))
    b = np.asarray(render_frame_jit(scene, cam, base.replace(ray_chunk=256)))
    # same math; XLA fuses the tiled map differently, so allow f32
    # reassociation noise
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_ray_chunk_grads_match():
    scene = scene_to_device(random_triangles(100, seed=10))
    cam = Camera.default()
    target = np.zeros((16, 16, 4), np.float32)
    base = RenderConfig(width=16, height=16, bounces=1, ortho_scale=0.2)

    params = init_params(scene)

    def grads(cfg):
        g = jax.grad(lambda p: loss_fn(p, scene, cam, target, cfg))(params)
        return jax.tree_util.tree_map(np.asarray, g)

    g0 = grads(base)
    g1 = grads(base.replace(ray_chunk=64))
    for a, b in zip(jax.tree_util.tree_leaves(g0), jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_cull_empty_chunks_identical():
    """Chunk culling must be invisible: same image and same grads as the
    unculled chunked path and the unchunked path, on a scene where many
    chunks are all-miss."""
    import jax.numpy as jnp

    scene = scene_to_device(random_triangles(60, seed=11, with_texture=True))
    cam = Camera.default()
    # small ortho_scale -> geometry covers a small part of the frame
    base = RenderConfig(width=32, height=32, bounces=2, ortho_scale=0.05,
                        enable_shadows=True)
    a = np.asarray(render_frame_jit(scene, cam, base))
    b = np.asarray(render_frame_jit(
        scene, cam, base.replace(ray_chunk=128, cull_empty_chunks=True)))
    c = np.asarray(render_frame_jit(
        scene, cam, base.replace(ray_chunk=128, cull_empty_chunks=False)))
    np.testing.assert_array_equal(b, c)
    np.testing.assert_allclose(a, b, atol=2e-5)

    params = init_params(scene)
    target = np.zeros((32, 32, 4), np.float32)

    def grads(cfg):
        g = jax.grad(lambda p: loss_fn(p, scene, cam, target, cfg))(params)
        return jax.tree_util.tree_map(np.asarray, g)

    g0 = grads(base.replace(ray_chunk=128, cull_empty_chunks=False))
    g1 = grads(base.replace(ray_chunk=128, cull_empty_chunks=True))
    for x, y in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-8)


def test_cull_bfloat16_branch_dtypes():
    """lax.cond branches must agree on dtype when the pipeline dtype is
    lower-precision than the (float32) texture table."""
    scene = scene_to_device(random_triangles(40, seed=12, with_texture=True))
    cam = Camera.default()
    cfg = RenderConfig(width=16, height=16, bounces=1, ortho_scale=0.1,
                       ray_chunk=64, dtype="bfloat16")
    img = np.asarray(render_frame_jit(scene, cam, cfg))
    assert np.isfinite(img.astype(np.float32)).all()


def test_unknown_traversal_backend_raises():
    import pytest

    from raytracebvh_tpu.pipeline import resolve_traversal_backend

    cfg = RenderConfig(width=8, height=8, traversal_backend="pallas_pre")
    with pytest.raises(ValueError, match="unknown traversal_backend"):
        resolve_traversal_backend(cfg)
