"""Tracing / profiling subsystem.

The reference's entire observability story is a once-a-second FPS print
(reference: Graphics.cpp:17-19,65-92) plus a commented-out frame timer
(Window.cpp:88-93).  Here: the same FPS meter as a reusable class, a
per-stage wall-clock breakdown of the frame pipeline (each stage jitted
and timed separately), rays/sec + builds/sec meters, and a context
manager around ``jax.profiler.trace`` for real XLA traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import jax


class FpsMeter:
    """Once-a-second FPS print (reference: Graphics.cpp:65-92)."""

    def __init__(self, out=None):
        self._t0 = time.perf_counter()
        self._last = self._t0
        self._frames = 0
        self._out = out

    def tick(self) -> float:
        """Count one frame; prints 'FPS: x' once per second. Returns the
        running average FPS."""
        self._frames += 1
        now = time.perf_counter()
        fps = self._frames / (now - self._t0)
        if now - self._last >= 1.0:
            print(f"FPS: {fps:.2f}", file=self._out)
            self._last = now
        return fps


@contextlib.contextmanager
def trace(log_dir: str):
    """XLA profiler trace (view with tensorboard/xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _timed(fn, *args, iters: int = 5) -> float:
    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def stage_times(scene, camera, cfg, iters: int = 5) -> Dict[str, float]:
    """Wall-clock seconds per pipeline stage, each jitted separately.

    Stages mirror the reference's dispatch chain (Graphics.cpp:667-831):
    morton (CS_MORTON_CODES), sort (32x CS_RADIX_SORT_P1/P2), topology
    (CS_BVH_CONSTRUCTION_P1), fit+links (CS_BVH_CONSTRUCTION_P2), trace
    (CS_RAY_TRACE_LAUNCH + CS_RAY_TRACE_REFLECTION), and the whole fused
    frame.  Per-stage numbers include one device-memory round trip per boundary
    that the fused frame doesn't pay, so they overstate the fused cost —
    use them for ratios, not absolutes.
    """
    import jax.numpy as jnp

    from ..camera import camera_matrices, transform_normals, transform_points
    from ..ops import bvh as bvh_ops
    from ..ops import morton as morton_ops
    from ..ops import sort as sort_ops
    from ..pipeline import build_bvh, make_rays, render_frame, shade_rays

    dtype = jnp.dtype(cfg.dtype)
    wvp, wv = camera_matrices(camera, cfg.width, cfg.height)
    out: Dict[str, float] = {}

    @jax.jit
    def f_morton(scene):
        verts_t = transform_points(scene.verts.astype(dtype), wvp.astype(dtype))
        smin, smax = morton_ops.scene_aabb(verts_t)
        return morton_ops.triangle_leaves(verts_t, scene.indices, smin, smax)

    codes, lmin, lmax, _ = f_morton(scene)
    out["morton"] = _timed(f_morton, scene, iters=iters)

    sort_fn = (sort_ops.radix_sort_by_code if cfg.sort_backend == "radix"
               else sort_ops.sort_by_code)
    f_sort = jax.jit(sort_fn)
    sorted_codes, _ = f_sort(codes)
    out["sort"] = _timed(f_sort, codes, iters=iters)

    f_topo = jax.jit(bvh_ops.build_topology)
    topo = f_topo(sorted_codes)
    out["topology"] = _timed(f_topo, sorted_codes, iters=iters)

    f_fit = jax.jit(bvh_ops.fit_aabbs)
    out["fit"] = _timed(f_fit, topo.node_lo, topo.node_hi, lmin, lmax,
                        iters=iters)

    f_links = jax.jit(lambda t: bvh_ops.compute_links(t, lmin.shape[0]))
    out["links"] = _timed(f_links, topo, iters=iters)

    f_build = jax.jit(lambda s: build_bvh(s, wvp, wv, cfg))
    bvh = f_build(scene)
    out["build_total"] = _timed(f_build, scene, iters=iters)

    rays = make_rays(camera, cfg)
    f_shade = jax.jit(lambda s, b, r: shade_rays(s, b, r, cfg))
    out["trace_shade"] = _timed(f_shade, scene, bvh, rays, iters=iters)

    f_frame = jax.jit(lambda s, c: render_frame(s, c, cfg))
    out["frame_total"] = _timed(f_frame, scene, camera, iters=iters)
    return out


def print_stage_times(times: Dict[str, float], cfg, file=None) -> None:
    rays = cfg.width * cfg.height * (1 + cfg.bounces)
    print(f"{'stage':<12} {'ms':>10}", file=file)
    for k, v in times.items():
        print(f"{k:<12} {v * 1e3:>10.3f}", file=file)
    ft = times.get("frame_total")
    bt = times.get("build_total")
    if ft:
        print(f"rays/sec     {rays / ft:>10.3e}", file=file)
    if bt:
        print(f"builds/sec   {1.0 / bt:>10.1f}", file=file)
