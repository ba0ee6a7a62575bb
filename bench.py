#!/usr/bin/env python
"""Frame-pipeline benchmark on one NVIDIA GPU.

    python bench.py

Prints the sub-metrics on stdout as ``# ...`` lines — BVH builds/s,
forward, shadow and dense frames, the 800x800x3 interactive loop, and the
102,400-triangle scene — and, as the last line, ONE JSON object: the
fwd+bwd rays/s of a 1080p frame with one reflection bounce on the
procedural scene ``sphere_grid(4, 3, 8)`` (3,072 textured triangles), with
the device it ran on.  Every config
goes through the backend resolver ('auto').  The reference publishes no
numbers (BASELINE.md), so there is no baseline ratio.  Without a GPU the
script exits non-zero: it measures the card and has no CPU fallback.
"""

import json
import sys
import time

import numpy as np


def log(msg):
    print(f"# {msg}", flush=True)


def timed(fn, *args, warmup=1, iters=3):
    """Mean wall seconds of ``fn(*args)`` to completion after ``warmup``
    calls (the first compiles)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters


def builds_per_sec(scene, wvp, wv, cfg):
    """Marginal in-stream time of one full BVH rebuild: K rebuilds with
    distinct camera transforms inside ONE jitted scan, (t(9) - t(1)) / 8,
    so per-dispatch host overhead cancels."""
    import jax
    import jax.numpy as jnp

    from raytracebvh_tpu.pipeline import build_bvh

    def scan_k(k):
        @jax.jit
        def f(s):
            def step(acc, yaw):
                b = build_bvh(s, wvp.at[0, 0].mul(jnp.cos(yaw)), wv, cfg)
                return acc + b.bbmin[s.num_faces].sum() + b.skip_link.sum(), None
            return jax.lax.scan(step, jnp.float32(0.0),
                                jnp.linspace(0.0, 0.1, k))[0]
        return f

    t1 = timed(scan_k(1), scene, iters=5)
    t9 = timed(scan_k(9), scene, iters=5)
    return max((t9 - t1) / 8.0, 1e-9), t1


def main():
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"error: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2

    from raytracebvh_tpu import Camera, RenderConfig
    from raytracebvh_tpu.camera import camera_matrices, orbit
    from raytracebvh_tpu.core.types import scene_to_device
    from raytracebvh_tpu.models.inverse import init_params, loss_fn
    from raytracebvh_tpu.models.procedural import sphere_grid
    from raytracebvh_tpu.pipeline import render_frame, resolve_traversal_backend

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    width, height, bounces = 1920, 1080, 1
    cfg = RenderConfig(width=width, height=height, bounces=bounces)
    scene_name = "sphere_grid_4x3x8"
    scene = scene_to_device(sphere_grid(nx=4, ny=3, subdiv=8))
    cam = Camera.default()
    rays_per_frame = width * height * (1 + bounces)
    log(f"device {device}; scene {scene_name} ({scene.num_faces} tris); "
        f"traversal {resolve_traversal_backend(cfg)}")

    wvp, wv = camera_matrices(cam, width, height)
    t_build, t_build1 = builds_per_sec(scene, wvp, wv, cfg)
    log(f"bvh build: {t_build*1e3:.3f} ms in-stream ({t_build1*1e3:.2f} ms "
        f"standalone) -> {1.0/t_build:.1f} builds/s")

    def frame_ms(c, s=scene, rays=None):
        t = timed(jax.jit(lambda s_, k: render_frame(s_, k, c)), s, cam)
        rays = rays or c.width * c.height * (1 + c.bounces)
        return t * 1e3, rays / t

    ms, rps = frame_ms(cfg)
    log(f"forward frame: {ms:.2f} ms -> {rps/1e6:.2f} Mrays/s")
    cfg_sh = cfg.replace(bounces=0, enable_shadows=True)
    ms, rps = frame_ms(cfg_sh, rays=width * height * 2)
    log(f"shadow frame (primary + shadow rays): {ms:.2f} ms -> "
        f"{rps/1e6:.2f} Mrays/s")
    # dense: the subject fills the frame (ortho_scale 256)
    ms, rps = frame_ms(cfg.replace(ortho_scale=256.0))
    log(f"dense forward frame: {ms:.2f} ms -> {rps/1e6:.2f} Mrays/s")

    params = init_params(scene)
    target = jnp.zeros((height, width, 4), jnp.float32)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, scene, cam, target, cfg)))
    t_step = timed(grad_fn, params)
    _, grads = grad_fn(params)
    assert np.isfinite(np.asarray(grads.vert_offsets)).all()
    rays_per_sec = rays_per_frame / t_step
    log(f"fwd+bwd frame: {t_step*1e3:.2f} ms -> {rays_per_sec/1e6:.2f} "
        "Mrays/s")

    # interactive loop: 20-frame orbit at 800x800, 3 bounces, host
    # blocking on every frame
    cfg_i = RenderConfig(width=800, height=800, bounces=3)
    f_i = jax.jit(lambda s, c: render_frame(s, c, cfg_i))
    cams = [cam]
    for _ in range(20):
        cams.append(orbit(cams[-1], 0.1, 0.0))
    jax.block_until_ready(f_i(scene, cams[0]))
    fts = []
    for c in cams[1:]:
        t0 = time.perf_counter()
        jax.block_until_ready(f_i(scene, c))
        fts.append((time.perf_counter() - t0) * 1e3)
    log(f"interactive 800x800x3: p50 {np.percentile(fts, 50):.2f} ms, "
        f"p90 {np.percentile(fts, 90):.2f} ms")

    # 102,400-triangle scene
    scene_l = scene_to_device(sphere_grid(nx=4, ny=4, subdiv=40))
    t_build_l, _ = builds_per_sec(scene_l, wvp, wv, cfg)
    cfg_l = cfg.replace(bounces=0)
    ms, rps = frame_ms(cfg_l, s=scene_l)
    params_l = init_params(scene_l)
    grad_l = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, scene_l, cam, target, cfg_l)))
    t_gl = timed(grad_l, params_l)
    log(f"sphere_grid_4x4x40 ({scene_l.num_faces} tris): build "
        f"{t_build_l*1e3:.2f} ms in-stream, fwd {ms:.2f} ms "
        f"({rps/1e6:.2f} Mrays/s), fwd+bwd {t_gl*1e3:.2f} ms "
        f"({width*height/t_gl/1e6:.2f} Mrays/s)")

    print(json.dumps({
        "metric": f"rays_per_sec_fwd_bwd_1080p_{scene_name}",
        "value": rays_per_sec,
        "unit": "rays/s",
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
