"""Multi-device sharding on the virtual 8-device CPU mesh.

The sharded paths must produce the same image as the single-device
pipeline, and the shard_map training step must produce the same gradients
as plain jax.grad (collectives correctness)."""

import jax
import jax.numpy as jnp
import numpy as np

from raytracebvh_tpu import Camera, RenderConfig, render_frame_jit
from raytracebvh_tpu.core.types import scene_to_device
from raytracebvh_tpu.models.inverse import apply_params, init_params
from raytracebvh_tpu.models.procedural import random_triangles
from raytracebvh_tpu.parallel.mesh import make_mesh
from raytracebvh_tpu.parallel.render import (
    render_geo_sharded,
    render_sharded,
    train_step_sharded,
)


def _scene_cfg(ntris=16, h=32, w=16):
    scene = scene_to_device(
        random_triangles(ntris, seed=5, extent=8.0, tri_size=2.0,
                         with_texture=True)
    )
    cfg = RenderConfig(width=w, height=h, bounces=1, leaf_pad_multiple=32)
    return scene, Camera.default(), cfg


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_render_sharded_matches_single():
    scene, cam, cfg = _scene_cfg()
    mesh = make_mesh(8, geo=1)
    img_s = np.asarray(render_sharded(scene, cam, cfg, mesh))
    img_1 = np.asarray(render_frame_jit(scene, cam, cfg))
    np.testing.assert_allclose(img_s, img_1, atol=1e-6)


def test_render_geo_sharded_matches_single():
    # 16 tris -> 48 verts/indices divide geo=2; 32 rows divide rays=4
    scene, cam, cfg = _scene_cfg()
    mesh = make_mesh(8, geo=2)
    img_s = np.asarray(render_geo_sharded(scene, cam, cfg, mesh))
    img_1 = np.asarray(render_frame_jit(scene, cam, cfg))
    # the gathered-geometry program compiles differently, so f32
    # reassociation shifts a few boundary texels by ~1e-5
    np.testing.assert_allclose(img_s, img_1, atol=1e-3)


def test_train_step_sharded_grads_match():
    scene, cam, cfg = _scene_cfg()
    mesh = make_mesh(8, geo=2)
    params = init_params(scene)
    target = jnp.zeros((cfg.height, cfg.width, 4), jnp.float32)

    loss_s, grads_s = train_step_sharded(
        params, apply_params, scene, cam, target, cfg, mesh
    )

    from raytracebvh_tpu.models.inverse import loss_fn

    loss_1, grads_1 = jax.value_and_grad(loss_fn)(
        params, scene, cam, target, cfg
    )
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-6)
    for a, b in zip(
        jax.tree_util.tree_leaves(grads_s), jax.tree_util.tree_leaves(grads_1)
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_dryrun_multichip_entry(tmp_path, monkeypatch):
    """The multi-device dry run works on 8 virtual devices and writes
    nothing into the working directory."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "graft_entry",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.chdir(tmp_path)
    mod.dryrun_multichip(8)
    assert list(tmp_path.iterdir()) == []


def test_host_mesh_train_step_matches_flat():
    """('dcn','rays','geo') mesh (dcn=1 single-process) produces the same
    loss/grads as the flat ('rays','geo') mesh — validates the ray_axes
    spec plumbing and the per-axis gradient pmean chain."""
    from raytracebvh_tpu.parallel.mesh import make_host_mesh

    scene, cam, cfg = _scene_cfg()
    params = init_params(scene)
    target = jnp.zeros((cfg.height, cfg.width, 4), jnp.float32)

    flat = make_mesh(8, geo=2)
    host = make_host_mesh(geo=2)
    assert host.axis_names == ("dcn", "rays", "geo")
    assert host.devices.shape == (1, 4, 2)

    l1, g1 = train_step_sharded(params, apply_params, scene, cam, target,
                                cfg, flat)
    l2, g2 = train_step_sharded(params, apply_params, scene, cam, target,
                                cfg, host)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_host_mesh_geo_sharded_image():
    from raytracebvh_tpu.parallel.mesh import make_host_mesh

    scene, cam, cfg = _scene_cfg()
    host = make_host_mesh(geo=2)
    img_s = np.asarray(render_geo_sharded(scene, cam, cfg, host))
    img_1 = np.asarray(render_frame_jit(scene, cam, cfg))
    np.testing.assert_allclose(img_s, img_1, rtol=2e-5, atol=2e-5)


def test_grad_chunks_overlapped_psum_matches():
    """grad_chunks>1 (per-chunk psum inside lax.scan — the overlapped
    collective schedule) produces the same loss and gradients."""
    scene, cam, cfg = _scene_cfg()
    params = init_params(scene)
    target = jnp.zeros((cfg.height, cfg.width, 4), jnp.float32)
    mesh = make_mesh(8, geo=2)
    l1, g1 = train_step_sharded(params, apply_params, scene, cam, target,
                                cfg, mesh)
    l2, g2 = train_step_sharded(params, apply_params, scene, cam, target,
                                cfg, mesh, grad_chunks=4)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-7)


def test_geo_sharded_midsize_scene():
    """The sharded leaf stage beyond toy scale —
    4096 triangles (12288 sharded verts/indices per device pair), 128x128
    rays.  The geo all-gather ships ~344 kB of derived leaf arrays."""
    scene = scene_to_device(
        random_triangles(4096, seed=5, extent=40.0, tri_size=3.0,
                         with_texture=True)
    )
    cam = Camera.default()
    cfg = RenderConfig(width=128, height=128, bounces=0)
    mesh = make_mesh(8, geo=2)
    img_s = np.asarray(render_geo_sharded(scene, cam, cfg, mesh))
    img_1 = np.asarray(render_frame_jit(scene, cam, cfg))
    # a 4k-tri build reassociates more f32 math than the 16-tri case
    np.testing.assert_allclose(img_s, img_1, atol=5e-3)
    # the frame must actually exercise the scene (not background)
    assert (np.abs(img_1[..., 0] - 0.5) > 1e-6).sum() > 10000


def test_train_step_sharded_midsize_grads():
    """Distributed fwd+bwd at mid-size geometry: gradients from the
    geo-sharded + ray-sharded step match single-device jax.grad."""
    scene = scene_to_device(
        random_triangles(4096, seed=5, extent=40.0, tri_size=3.0,
                         with_texture=True)
    )
    cam = Camera.default()
    cfg = RenderConfig(width=64, height=64, bounces=0)
    mesh = make_mesh(8, geo=2)
    params = init_params(scene)
    target = jnp.zeros((cfg.height, cfg.width, 4), jnp.float32)
    loss_s, grads_s = train_step_sharded(
        params, apply_params, scene, cam, target, cfg, mesh
    )

    from raytracebvh_tpu.models.inverse import loss_fn

    loss_1, grads_1 = jax.value_and_grad(loss_fn)(
        params, scene, cam, target, cfg
    )
    np.testing.assert_allclose(float(loss_s), float(loss_1), rtol=1e-5)
    # f32 reassociation across the differently-compiled sharded program
    # shifts a handful of near-zero entries; the loss agrees to 1e-5
    for a, b in zip(jax.tree_util.tree_leaves(grads_s),
                    jax.tree_util.tree_leaves(grads_1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=3e-5)
