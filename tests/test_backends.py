"""The one backend resolver: what 'auto' picks per platform, and that a
backend that cannot run, or an unknown name, raises instead of falling
back."""

import jax.numpy as jnp
import pytest

from raytracebvh_tpu import Camera, RenderConfig
from raytracebvh_tpu.camera import camera_matrices
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles
from raytracebvh_tpu.pipeline import build_bvh, resolve_traversal_backend


@pytest.mark.parametrize("backend,platform,dtype,want", [
    ("auto", "cpu", "float32", "jnp"),
    ("auto", "gpu", "float32", "triton"),
    ("auto", "gpu", "float64", "jnp"),
    ("jnp", "gpu", "float32", "jnp"),
    ("triton", "gpu", "float32", "triton"),
])
def test_resolver_picks(backend, platform, dtype, want):
    cfg = RenderConfig(traversal_backend=backend, dtype=dtype)
    assert resolve_traversal_backend(cfg, platform) == want


def test_resolver_defaults_to_the_running_platform():
    # the tests run on the CPU: 'auto' is the XLA walk
    assert resolve_traversal_backend(RenderConfig()) == "jnp"


@pytest.mark.parametrize("backend,platform,dtype,match", [
    ("triton", "cpu", "float32", "cannot run on platform 'cpu'"),
    ("triton", "gpu", "float64", "float32 only"),
    ("pallas", "gpu", "float32", "unknown traversal_backend"),
    ("hbm", "cpu", "float32", "unknown traversal_backend"),
    ("jnp", "metal", "float32", "cannot run on platform 'metal'"),
])
def test_resolver_raises(backend, platform, dtype, match):
    cfg = RenderConfig(traversal_backend=backend, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        resolve_traversal_backend(cfg, platform)


@pytest.mark.parametrize("sort_backend", ["bitonic", "auto"])
def test_unknown_sort_backend_raises(sort_backend):
    scene = scene_to_device(random_triangles(20, seed=0))
    cfg = RenderConfig(width=8, height=8, sort_backend=sort_backend)
    wvp, wv = camera_matrices(Camera.default(), 8, 8)
    with pytest.raises(ValueError, match="unknown sort_backend"):
        build_bvh(scene, wvp, wv, cfg)


def test_triton_frame_on_cpu_raises():
    """An explicit GPU backend on the CPU fails at trace time, loudly."""
    from raytracebvh_tpu import render_frame

    scene = scene_to_device(random_triangles(20, seed=0))
    cfg = RenderConfig(width=8, height=8, bounces=0,
                       traversal_backend="triton")
    with pytest.raises(ValueError, match="cannot run on platform"):
        render_frame(scene, Camera.default(jnp.float32), cfg)


@pytest.mark.parametrize("tile,backend,platform,want", [
    (-1, "auto", "gpu", 8),
    (-1, "auto", "cpu", 0),
    (-1, "jnp", "gpu", 0),
    (16, "auto", "cpu", 16),
    (0, "auto", "gpu", 0),
])
def test_ray_tile_resolves(tile, backend, platform, want):
    """'auto' tile-orders the rays only for the GPU kernel; an explicit
    tile size is kept on every platform."""
    from raytracebvh_tpu.pipeline import resolve_ray_tile

    cfg = RenderConfig(ray_tile=tile, traversal_backend=backend)
    assert resolve_ray_tile(cfg, platform) == want
