"""The per-ray GPU traversal kernel (ops/traverse_gpu.py).

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``)
and must return exactly what the XLA walk (ops/traverse.py) returns —
same ids, distances and occlusion — which in turn must agree with brute
force.  Tests marked ``gpu`` compile it for the card and skip elsewhere.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracebvh_tpu import Camera, RenderConfig
from raytracebvh_tpu.camera import camera_matrices
from raytracebvh_tpu.core.types import Rays, scene_to_device
from raytracebvh_tpu.models.procedural import random_triangles, sphere_grid
from raytracebvh_tpu.ops import traverse_gpu as tg
from raytracebvh_tpu.ops.traverse import traverse, traverse_any
from raytracebvh_tpu.pipeline import build_bvh
from raytracebvh_tpu.ref import golden

EPS = 0.01
SCENES = {
    "random50": lambda: random_triangles(50, seed=0),
    "random500": lambda: random_triangles(500, seed=1),
    "random2000": lambda: random_triangles(2000, seed=2),
    "sphere_grid": lambda: sphere_grid(nx=2, ny=2, subdiv=4),
}


@functools.lru_cache(maxsize=None)
def _setup(name):
    scene_h = SCENES[name]()
    cfg = RenderConfig(width=8, height=8)
    wvp, wv = camera_matrices(Camera.default(), 8, 8)
    bvh = jax.jit(lambda s: build_bvh(s, wvp, wv, cfg))(scene_to_device(scene_h))
    return bvh


def _rays(n, seed, spread=60.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Rays(origin=jnp.asarray(o), direction=jnp.asarray(d))


def _nearest(bvh, rays, max_steps=0):
    ref = traverse(bvh, rays, EPS, max_steps)
    got = tg.traverse_gpu(bvh, rays, EPS, max_steps, interpret=True)
    return ref, got


def _assert_same_record(ref, got):
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(got.leaf), np.asarray(ref.leaf))
    np.testing.assert_array_equal(np.asarray(got.distance),
                                  np.asarray(ref.distance))


def _brute(bvh, rays):
    tris = np.asarray(bvh.tri_verts, np.float64)[np.asarray(bvh.prim) >= 0]
    faces = np.asarray(bvh.prim)[np.asarray(bvh.prim) >= 0]
    o = np.asarray(rays.origin, np.float64)
    d = np.asarray(rays.direction, np.float64)
    return tris, faces, o, d


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_nearest_matches_xla_walk_and_brute_force(scene):
    bvh = _setup(scene)
    rays = _rays(384, seed=7)
    ref, got = _nearest(bvh, rays)
    _assert_same_record(ref, got)

    tris, faces, o, d = _brute(bvh, rays)
    bhit, bt, bface = golden.nearest_hit(o, d, tris, EPS)
    hit = np.asarray(got.hit)
    assert (hit == bhit).mean() > 0.99  # f32 vs f64 grazing edges
    both = hit & bhit
    prim = np.asarray(bvh.prim)[np.asarray(got.leaf)]
    agree = prim[both] == faces[bface[both]]
    assert agree.mean() > 0.99
    np.testing.assert_allclose(np.asarray(got.distance)[both][agree],
                               bt[both][agree], rtol=1e-3)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_any_hit_matches_xla_walk_and_brute_force(scene):
    bvh = _setup(scene)
    rays = _rays(384, seed=8)
    max_t = jnp.asarray(np.random.default_rng(9).uniform(5, 300, 384),
                        jnp.float32)
    ref = traverse_any(bvh, rays, EPS, max_t)
    got = tg.traverse_any_gpu(bvh, rays, EPS, max_t, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    tris, _, o, d = _brute(bvh, rays)
    t_all = golden.mt_all(o, d, tris, EPS)
    brute = np.any((t_all > 0) & (t_all < np.asarray(max_t)[:, None]), 1)
    assert (np.asarray(got) == brute).mean() > 0.99


@pytest.mark.parametrize("nrays", [1, 127, 129, 300])
def test_ray_count_not_a_multiple_of_the_block(nrays):
    bvh = _setup("random500")
    rays = _rays(nrays, seed=nrays)
    ref, got = _nearest(bvh, rays)
    assert got.hit.shape == got.leaf.shape == got.distance.shape == (nrays,)
    _assert_same_record(ref, got)
    max_t = jnp.full(nrays, 200.0, jnp.float32)
    occ = tg.traverse_any_gpu(bvh, rays, EPS, max_t, interpret=True)
    assert occ.shape == (nrays,) and occ.dtype == jnp.bool_
    np.testing.assert_array_equal(
        np.asarray(occ), np.asarray(traverse_any(bvh, rays, EPS, max_t)))


def test_all_miss_batch():
    bvh = _setup("random500")
    n = 200
    # every ray starts far outside the scene and points away from it
    o = jnp.tile(jnp.array([[500.0, 500.0, 500.0]], jnp.float32), (n, 1))
    d = jnp.tile(jnp.array([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
    rays = Rays(origin=o, direction=d)
    ref, got = _nearest(bvh, rays)
    assert not np.asarray(got.hit).any()
    _assert_same_record(ref, got)
    occ = tg.traverse_any_gpu(bvh, rays, EPS, 1e9, interpret=True)
    assert not np.asarray(occ).any()


def test_dead_lanes_at_far_origins():
    """The pipeline retires bounce/shadow lanes by moving their origin to
    1e30; they must miss without disturbing live lanes."""
    bvh = _setup("random2000")
    rays = _rays(256, seed=3)
    dead = np.arange(256) % 3 == 0
    o = jnp.where(jnp.asarray(dead)[:, None], 1.0e30, rays.origin)
    rays_d = Rays(origin=o, direction=rays.direction)
    ref, got = _nearest(bvh, rays_d)
    _assert_same_record(ref, got)
    assert not np.asarray(got.hit)[dead].any()
    live_ref = tg.traverse_gpu(bvh, rays, EPS, interpret=True)
    np.testing.assert_array_equal(np.asarray(got.leaf)[~dead],
                                  np.asarray(live_ref.leaf)[~dead])


@pytest.mark.parametrize("max_steps", [1, 4, 16])
def test_max_steps_truncates_like_the_xla_walk(max_steps):
    bvh = _setup("random2000")
    rays = _rays(256, seed=11)
    ref, got = _nearest(bvh, rays, max_steps)
    _assert_same_record(ref, got)
    max_t = jnp.full(256, 300.0, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(tg.traverse_any_gpu(bvh, rays, EPS, max_t, max_steps,
                                       interpret=True)),
        np.asarray(traverse_any(bvh, rays, EPS, max_t, max_steps)))


def test_scalar_and_zero_max_t():
    bvh = _setup("sphere_grid")
    rays = _rays(256, seed=12, spread=30.0)
    for max_t in (0.0, 40.0):
        np.testing.assert_array_equal(
            np.asarray(tg.traverse_any_gpu(bvh, rays, EPS, max_t,
                                           interpret=True)),
            np.asarray(traverse_any(bvh, rays, EPS, max_t)))
    assert not np.asarray(
        tg.traverse_any_gpu(bvh, rays, EPS, 0.0, interpret=True)).any()


def test_packed_rows():
    """Node rows hold bbox + the two links bit-cast; leaf rows v0|e1|e2."""
    bvh = _setup("random50")
    nodes = np.asarray(tg.pack_nodes(bvh)).reshape(-1, tg.NODE_W)
    np.testing.assert_array_equal(nodes[:, 0:3], np.asarray(bvh.bbmin))
    np.testing.assert_array_equal(nodes[:, 3:6], np.asarray(bvh.bbmax))
    links = nodes[:, 6:8].copy().view(np.int32)
    np.testing.assert_array_equal(links[:, 0], np.asarray(bvh.entry_link))
    np.testing.assert_array_equal(links[:, 1], np.asarray(bvh.skip_link))
    leaves = np.asarray(tg.pack_leaves(bvh)).reshape(-1, tg.LEAF_W)
    tv = np.asarray(bvh.tri_verts)
    np.testing.assert_array_equal(leaves[:, 0:3], tv[:, 0])
    np.testing.assert_array_equal(leaves[:, 3:6], tv[:, 1] - tv[:, 0])
    np.testing.assert_array_equal(leaves[:, 6:9], tv[:, 2] - tv[:, 0])


@pytest.mark.parametrize("shadows", [False, True])
def test_pipeline_image_and_grads_with_kernel(monkeypatch, shadows):
    """The whole frame and its gradients are the same when traversal runs
    through the kernel: its ids cross the same stop_gradient boundary."""
    from raytracebvh_tpu import pipeline
    from raytracebvh_tpu.models.inverse import init_params, loss_fn

    scene = scene_to_device(random_triangles(300, seed=7, with_texture=True))
    cfg = RenderConfig(width=24, height=24, bounces=1, enable_shadows=shadows,
                       leaf_pad_multiple=64)
    cam = Camera.default()
    params = init_params(scene)
    target = jnp.zeros((24, 24, 4), jnp.float32)
    run = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, scene, cam, target, cfg)))
    loss_x, g_x = run(params)

    monkeypatch.setattr(pipeline, "resolve_traversal_backend",
                        lambda cfg, platform=None: "triton")
    for name in ("traverse_gpu", "traverse_any_gpu"):
        monkeypatch.setattr(
            tg, name, functools.partial(getattr(tg, name), interpret=True))
    run_k = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, scene, cam, target, cfg)))
    loss_k, g_k = run_k(params)
    assert float(loss_k) == float(loss_x)
    for a, b in zip(jax.tree_util.tree_leaves(g_k),
                    jax.tree_util.tree_leaves(g_x)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["random2000", "sphere_grid"])
def test_compiled_kernel_matches_xla_walk_on_gpu(gpu, scene):
    bvh = _setup(scene)
    rays = _rays(4096, seed=21)
    ref = traverse(bvh, rays, EPS)
    got = tg.traverse_gpu(bvh, rays, EPS)
    # XLA and Triton may contract multiply-adds differently: ids agree
    # except at rare ties, distances to f32 rounding
    assert (np.asarray(got.leaf) == np.asarray(ref.leaf)).mean() > 0.999
    same = np.asarray(got.leaf) == np.asarray(ref.leaf)
    np.testing.assert_allclose(np.asarray(got.distance)[same],
                               np.asarray(ref.distance)[same], rtol=1e-5)
    max_t = jnp.full(4096, 200.0, jnp.float32)
    occ = tg.traverse_any_gpu(bvh, rays, EPS, max_t)
    assert (np.asarray(occ) == np.asarray(
        traverse_any(bvh, rays, EPS, max_t))).mean() > 0.999


@pytest.mark.gpu
def test_auto_selects_the_kernel_on_gpu(gpu):
    from raytracebvh_tpu.pipeline import resolve_traversal_backend

    assert resolve_traversal_backend(RenderConfig()) == "triton"
    assert resolve_traversal_backend(RenderConfig(dtype="float64")) == "jnp"
