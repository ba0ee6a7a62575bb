#!/usr/bin/env python
"""Smoke run of the frame pipeline on NVIDIA GPUs.

    python chip_smoke.py               # one card: the phases below
    python chip_smoke.py --devices 4   # only the four-card sharded path

Every phase drives the normal entry points (``build_bvh``,
``render_frame_jit``, ``models.inverse.train_step`` / ``loss_fn``,
``parallel.render``) at full width on the procedural scenes
``sphere_grid(4, 3, 8)`` (3,072 triangles) and ``sphere_grid(4, 4, 40)``
(102,400 triangles), checks its result against a plain reference, and
prints one JSON line.  A failed check raises, so the script exits non-zero
and prints no result.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

The script refuses to run without a GPU: the CPU serves only as a
reference inside comparisons.  One process drives the card(s).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

W, H = 1920, 1080
SMALL = (4, 3, 8)  # sphere_grid(nx, ny, subdiv): 3,072 triangles
LARGE = (4, 4, 40)  # 102,400 triangles
EPS = 0.01  # RenderConfig.epsilon
EYE, AT, UP = (0.0, 5.0, -100.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)


_phase_start = [time.perf_counter()]


def emit(phase, **fields):
    """One JSON line per phase, with the phase's wall time (compilation
    and host-side references included)."""
    seconds = time.perf_counter() - _phase_start[0]
    print(json.dumps({"phase": phase, **fields, "seconds": seconds}),
          flush=True)
    _phase_start[0] = time.perf_counter()


def median_ms(fn, *args, iters=5):
    """Median wall time of ``fn(*args)`` to completion, after one warm-up
    call (which compiles)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def scene(dims):
    from raytracebvh_tpu.core.types import scene_to_device
    from raytracebvh_tpu.models.procedural import sphere_grid

    nx, ny, sd = dims
    host = sphere_grid(nx=nx, ny=ny, subdiv=sd)
    return host, scene_to_device(host)


def golden_tris(host, width, height):
    """float64 ray-space triangles [F, 3, 3], transformed as
    ref/golden.render_golden does."""
    from raytracebvh_tpu.ref import golden

    wvp = golden.look_at_lh_np(EYE, AT, UP) @ golden.perspective_fov_lh_np(
        np.pi / 4, height / width, 0.1, 1000.0)
    v = np.asarray(host.verts, np.float64) @ wvp[:3, :3] + wvp[3, :3]
    return v[np.asarray(host.indices).reshape(-1, 3)]


def mt64(o, d, tri):
    """Moeller-Trumbore in float64 of rays [R, 3] against one triangle per
    ray [R, 3, 3]: (t, edge margin min(u, v, 1-u-v)); t = -1 on a miss."""
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    p = np.cross(d, e2)
    det = np.sum(e1 * p, -1)
    ok = np.abs(det) >= EPS
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = o - tri[:, 0]
    u = np.sum(tv * p, -1) * inv
    q = np.cross(tv, e1)
    v = np.sum(d * q, -1) * inv
    t = np.sum(e2 * q, -1) * inv
    ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > EPS)
    return np.where(ok, t, -1.0), np.minimum(np.minimum(u, v), 1 - u - v)


def check_hits_vs_brute_force(host, bvh, rays, rec, width, height, n=2048,
                              seed=0):
    """A seeded ``n``-ray subsample of a traversal result vs the
    brute-force float64 ``ref/golden.nearest_hit``.

    Tolerance: hit flag and face id equal, except at recorded ties — a
    ray whose disputed triangles lie within rtol 1e-4 in float64 depth,
    or that passes within 1e-4 (barycentric) of a disputed triangle's
    edge; at most 0.5% of the sample.  Distances rtol 1e-5 where the ids
    agree."""
    from raytracebvh_tpu.ref import golden

    tris = golden_tris(host, width, height)
    idx = np.random.default_rng(seed).choice(rays.origin.shape[0], n,
                                             replace=False)
    o = np.asarray(rays.origin, np.float64)[idx]
    d = np.asarray(rays.direction, np.float64)[idx]
    hit = np.asarray(rec.hit)[idx]
    face = np.asarray(bvh.prim)[np.asarray(rec.leaf)[idx]]
    dist = np.asarray(rec.distance, np.float64)[idx]
    bhit, bt, bface = golden.nearest_hit(o, d, tris, EPS, chunk=64)
    same = (hit == bhit) & (~hit | (face == bface))
    bad = np.flatnonzero(~same)
    ties = 0
    for i in bad:
        cand = [f for f, h in ((face[i], hit[i]), (bface[i], bhit[i])) if h]
        t_m = [mt64(o[i:i + 1], d[i:i + 1], tris[f:f + 1]) for f in cand]
        ts = [float(t[0]) for t, _ in t_m]
        graze = any(abs(float(m[0])) < 1e-4 for _, m in t_m)
        depth_tie = (len(ts) == 2 and min(ts) > 0
                     and abs(ts[0] - ts[1]) <= 1e-4 * abs(ts[1]))
        ties += bool(graze or depth_tie)
    assert ties == len(bad), f"{len(bad) - ties} id mismatches are not ties"
    assert len(bad) <= 0.005 * n, f"{len(bad)} ties in {n} rays"
    both = same & hit
    np.testing.assert_allclose(dist[both], bt[both], rtol=1e-5)
    return dict(sample=n, hits=int(bhit.sum()), ties=len(bad),
                tolerance="ids exact except recorded ties (<=0.5%); "
                          "distance rtol 1e-5 vs float64 brute force")


def grad_tolerance(vert_rel_l2):
    return (
        "per gradient, >= 99% of elements within rtol 1e-3 + atol "
        "1e-3*max|g|; relative L2 error <= 1e-3 for the material gradients "
        f"and <= {vert_rel_l2:g} for the vertex gradients")


def compare_grads(got, want, vert_rel_l2):
    """Per-field agreement of two InverseParams gradients (see
    grad_tolerance); raises on a breach, returns the statistics."""
    out = {}
    for name, a, b in zip(want._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        rel_l2 = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        close = float(np.isclose(a, b, rtol=1e-3,
                                 atol=1e-3 * np.abs(b).max()).mean())
        out[name] = dict(rel_l2=rel_l2, frac_close=close)
        bound = vert_rel_l2 if name == "vert_offsets" else 1e-3
        assert close >= 0.99 and rel_l2 <= bound, (name, out[name], bound)
    return out


def phase_build(dims):
    """build_bvh on the GPU and on the CPU from the same transformed
    vertices: codes, prim, topology and links exactly equal, boxes equal
    to f32 rounding."""
    import jax

    from raytracebvh_tpu import Camera, RenderConfig, build_bvh
    from raytracebvh_tpu.camera import (
        camera_matrices,
        transform_normals,
        transform_points,
    )

    _, sc = scene(dims)
    cfg = RenderConfig(width=W, height=H)
    wvp, wv = camera_matrices(Camera.default(), W, H)
    verts_t = jax.jit(transform_points)(sc.verts, wvp)
    normals_t = jax.jit(transform_normals)(sc.normals, wv)
    sc_t = jax.device_get(sc.replace(verts=verts_t, normals=normals_t))
    eye = np.eye(4, dtype=np.float32)

    def build(s, e):
        return build_bvh(s, e, e, cfg)

    cpu = jax.devices("cpu")[0]
    gpu_bvh = jax.device_get(jax.jit(build)(sc_t, eye))
    cpu_bvh = jax.device_get(
        jax.jit(build)(jax.device_put(sc_t, cpu), jax.device_put(eye, cpu)))
    for name in ("codes", "prim", "child_l", "child_r", "parent",
                 "entry_link", "skip_link"):
        np.testing.assert_array_equal(getattr(gpu_bvh, name),
                                      getattr(cpu_bvh, name), err_msg=name)
    box_diff = max(
        float(np.abs(np.asarray(getattr(gpu_bvh, k))
                     - np.asarray(getattr(cpu_bvh, k)))[:-1].max())
        for k in ("bbmin", "bbmax"))
    for k in ("bbmin", "bbmax"):
        np.testing.assert_allclose(getattr(gpu_bvh, k)[:-1],
                                   getattr(cpu_bvh, k)[:-1], rtol=1e-6)
    t_build = median_ms(jax.jit(build), jax.device_put(sc_t), eye)
    emit("build", tris=int(sc.num_faces), leaves=int(gpu_bvh.n_leaves),
         build_ms=t_build, box_max_abs_diff=box_diff,
         tolerance="codes/prim/topology/links exact; boxes rtol 1e-6")


def phase_forward(dims, golden_256=False):
    """1080p forward frame (1 bounce + shadows) through 'auto'; traversal
    ids vs float64 brute force; optionally a 256x256 frame vs
    render_golden."""
    import jax

    from raytracebvh_tpu import Camera, RenderConfig, render_frame_jit
    from raytracebvh_tpu.camera import camera_matrices
    from raytracebvh_tpu.pipeline import (
        _traverse_ids,
        build_bvh,
        make_rays,
        resolve_traversal_backend,
    )

    host, sc = scene(dims)
    cam = Camera.default()
    cfg = RenderConfig(width=W, height=H, bounces=1, enable_shadows=True)
    img = np.asarray(render_frame_jit(sc, cam, cfg))
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    bg = np.asarray(cfg.background)
    hit_frac = float(1.0 - (np.abs(img - bg) < 1e-6).all(-1).mean())
    assert hit_frac > 0.01, f"frame is background only ({hit_frac})"
    frame_ms = median_ms(render_frame_jit, sc, cam, cfg)

    wvp, wv = camera_matrices(cam, W, H)
    bvh = jax.jit(lambda s: build_bvh(s, wvp, wv, cfg))(sc)
    rays = make_rays(cam, cfg)
    rec = jax.jit(lambda b, r: _traverse_ids(b, r, cfg))(bvh, rays)
    out = dict(tris=int(sc.num_faces), backend=resolve_traversal_backend(cfg),
               width=W, height=H, bounces=1, shadows=True,
               frame_ms=frame_ms, pixels_hit=hit_frac,
               ids=check_hits_vs_brute_force(host, bvh, rays, rec, W, H))

    if golden_256:
        from raytracebvh_tpu.ref.golden import render_golden

        cfg_s = RenderConfig(width=256, height=256, bounces=3)
        img_s = np.asarray(render_frame_jit(sc, cam, cfg_s))
        gold = render_golden(host, EYE, AT, UP, 256, 256, bounces=3)
        diff = np.abs(img_s - gold)
        # the f32 tolerance of tests/test_pipeline.py::test_rect_f32_close
        assert diff.mean() < 0.02, diff.mean()
        assert (diff > 0.05).mean() < 0.02, (diff > 0.05).mean()
        out["golden_256"] = dict(
            mean_abs_diff=float(diff.mean()),
            frac_over_0_05=float((diff > 0.05).mean()),
            tolerance="mean |diff| < 0.02 and < 2% of values off by > 0.05 "
                      "vs float64 render_golden (3 bounces)")
    emit("forward", **out)


def _perturbed(params):
    return params._replace(diffuse=params.diffuse * 0.5)


def phase_training():
    """5 Adam steps at 1080p (3,072 tris), one value_and_grad at 1080p
    (102,400 tris), and GPU-vs-CPU gradients at 256x256."""
    import jax
    import jax.numpy as jnp

    from raytracebvh_tpu import Camera, RenderConfig, render_frame_jit
    from raytracebvh_tpu.models.inverse import (
        init_params,
        loss_fn,
        make_optimizer,
        train_step,
    )

    cam = Camera.default()
    _, sc = scene(SMALL)
    cfg = RenderConfig(width=W, height=H, bounces=1)
    target = render_frame_jit(sc, cam, cfg)
    params = _perturbed(init_params(sc))
    opt = make_optimizer(1e-2).init(params)
    losses, ts = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        params, opt, loss = train_step(params, opt, sc, cam, target, cfg, 1e-2)
        losses.append(float(loss))
        ts.append((time.perf_counter() - t0) * 1e3)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(params))

    _, sc_l = scene(LARGE)
    p_l = init_params(sc_l)
    target_l = jnp.zeros((H, W, 4), jnp.float32)
    vg = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, sc_l, cam, target_l, cfg)))
    loss_l, g_l = vg(p_l)
    assert np.isfinite(float(loss_l))
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(g_l))
    assert float(jnp.abs(g_l.vert_offsets).sum()) > 0
    grad_ms = median_ms(vg, p_l, iters=3)

    # GPU vs CPU gradients at 256x256 (camera matmuls at HIGHEST)
    cfg_s = RenderConfig(width=256, height=256, bounces=1)
    p_s = _perturbed(init_params(sc))
    tgt_s = render_frame_jit(sc, cam, cfg_s)

    @functools.partial(jax.jit, static_argnames="c")
    def vg_s(p, s, t, c):
        return jax.value_and_grad(lambda q: loss_fn(q, s, cam, t, c))(p)

    # the CPU reference traverses with the XLA walk
    cpu = jax.devices("cpu")[0]
    cfg_c = cfg_s.replace(traversal_backend="jnp")
    on_cpu = jax.device_put((p_s, sc, tgt_s), cpu)
    gl, gg = jax.device_get(vg_s(p_s, sc, tgt_s, cfg_s))
    cl, cg = jax.device_get(vg_s(*on_cpu, cfg_c))
    img_g = np.asarray(render_frame_jit(sc, cam, cfg_s))
    img_c = np.asarray(render_frame_jit(
        *jax.device_put((sc, cam), cpu), cfg_c))
    px_same = float((np.abs(img_g - img_c) <= 1e-4).all(-1).mean())
    np.testing.assert_allclose(gl, cl, rtol=1e-3)
    # the two traversals round differently, so a few edge pixels see
    # another triangle; CPU float32 vs float64 differs as much (8.7e-3)
    grads = compare_grads(gg, cg, vert_rel_l2=5e-2)
    emit("training", adam_losses=losses, adam_step_ms=ts,
         large_tris=int(sc_l.num_faces), large_loss=float(loss_l),
         large_value_and_grad_ms=grad_ms,
         gpu_vs_cpu_256=dict(pixels_equal=px_same, loss_gpu=float(gl),
                             loss_cpu=float(cl), grads=grads),
         tolerance="GPU vs CPU at 256x256, camera matmuls at HIGHEST: loss "
                   "rtol 1e-3; " + grad_tolerance(5e-2))


def phase_interactive():
    """20 frames at 800x800 with 3 bounces on a camera orbit."""
    import jax

    from raytracebvh_tpu import Camera, RenderConfig, render_frame_jit
    from raytracebvh_tpu.camera import orbit

    _, sc = scene(SMALL)
    cfg = RenderConfig(width=800, height=800, bounces=3)
    cams = [Camera.default()]
    for _ in range(20):
        cams.append(orbit(cams[-1], 0.1, 0.0))
    jax.block_until_ready(render_frame_jit(sc, cams[0], cfg))
    ts = []
    for c in cams[1:]:
        t0 = time.perf_counter()
        img = jax.block_until_ready(render_frame_jit(sc, c, cfg))
        ts.append((time.perf_counter() - t0) * 1e3)
    assert np.isfinite(np.asarray(img)).all()
    emit("interactive", width=800, height=800, bounces=3, frames=20,
         frame_ms_p50=float(np.percentile(ts, 50)),
         frame_ms_p90=float(np.percentile(ts, 90)))


def phase_kernel_vs_xla(dims):
    """The hand-written traversal kernel against XLA's while-loop walk at
    1080p: primary (nearest-hit), shadow (any-hit) and the full frame.
    Both walks get the rays in the tile order the frame gives the kernel
    (the XLA walk advances all rays in lock-step, so order is moot for
    it); each frame runs its backend's 'auto' tiling."""
    import jax
    import jax.numpy as jnp

    from raytracebvh_tpu import Camera, RenderConfig, render_frame_jit
    from raytracebvh_tpu.camera import (
        camera_matrices,
        structured_tile_shape,
        tile_rays,
    )
    from raytracebvh_tpu.core.types import Rays
    from raytracebvh_tpu.ops.traverse import traverse, traverse_any
    from raytracebvh_tpu.ops.traverse_gpu import traverse_any_gpu, traverse_gpu
    from raytracebvh_tpu.pipeline import (
        build_bvh,
        light_in_ray_space,
        make_rays,
        resolve_ray_tile,
    )

    _, sc = scene(dims)
    cam = Camera.default()
    cfg = RenderConfig(width=W, height=H, bounces=1, enable_shadows=True)
    wvp, wv = camera_matrices(cam, W, H)
    bvh = jax.jit(lambda s: build_bvh(s, wvp, wv, cfg))(sc)
    tile = resolve_ray_tile(cfg.replace(traversal_backend="triton"))
    rays = tile_rays(make_rays(cam, cfg), W, H,
                     *structured_tile_shape(W, H, tile))

    near = {"xla": jax.jit(lambda b, r: traverse(b, r, EPS)),
            "kernel": jax.jit(lambda b, r: traverse_gpu(b, r, EPS))}
    rec = {k: f(bvh, rays) for k, f in near.items()}
    leaf_agree = float((np.asarray(rec["kernel"].leaf)
                        == np.asarray(rec["xla"].leaf)).mean())
    assert leaf_agree > 0.9999, leaf_agree

    # shadow rays from the primary hits toward the light (as the pipeline)
    r0 = rec["xla"]
    light = jnp.stack(light_in_ray_space(cfg, wvp, jnp.float32))
    p = rays.origin + rays.direction * r0.distance[:, None]
    to_l = light - p
    dist = jnp.linalg.norm(to_l, axis=-1)
    dn = to_l / dist[:, None]
    so = jnp.where(r0.hit[:, None], p + dn * cfg.ray_offset, 1.0e30)
    shadow = Rays(origin=so, direction=dn)
    max_t = dist * (1.0 - 1e-4)
    anyf = {"xla": jax.jit(lambda b, r, m: traverse_any(b, r, EPS, m)),
            "kernel": jax.jit(lambda b, r, m: traverse_any_gpu(b, r, EPS, m))}
    occ = {k: np.asarray(f(bvh, shadow, max_t)) for k, f in anyf.items()}
    occ_agree = float((occ["kernel"] == occ["xla"]).mean())
    assert occ_agree > 0.9999, occ_agree

    out = dict(tris=int(sc.num_faces), ray_tile=tile, leaf_agree=leaf_agree,
               occlusion_agree=occ_agree)
    frames = {}
    for k, backend in (("xla", "jnp"), ("kernel", "triton")):
        cfg_k = cfg.replace(traversal_backend=backend)
        frames[k] = np.asarray(render_frame_jit(sc, cam, cfg_k))
        out[f"{k}_primary_ms"] = median_ms(near[k], bvh, rays)
        out[f"{k}_any_hit_ms"] = median_ms(anyf[k], bvh, shadow, max_t)
        out[f"{k}_frame_ms"] = median_ms(render_frame_jit, sc, cam, cfg_k)
    px_same = float((np.abs(frames["kernel"] - frames["xla"]) <= 1e-5)
                    .all(-1).mean())
    assert px_same > 0.9999, px_same
    out["frame_pixels_equal"] = px_same
    out["kernel_faster_end_to_end"] = out["kernel_frame_ms"] < out["xla_frame_ms"]
    emit("kernel_vs_xla", **out)


def phase_four_cards():
    """render_geo_sharded and train_step_sharded on a ('rays', 'geo') =
    (2, 2) mesh at 1080p (102,400 tris), each against one card."""
    import jax
    import jax.numpy as jnp

    from raytracebvh_tpu import Camera, RenderConfig, render_frame_jit
    from raytracebvh_tpu.models.inverse import apply_params, init_params, loss_fn
    from raytracebvh_tpu.parallel.mesh import make_mesh
    from raytracebvh_tpu.parallel.render import (
        render_geo_sharded,
        train_step_sharded,
    )

    assert len(jax.devices()) >= 4, f"need 4 GPUs, have {jax.devices()}"
    _, sc = scene(LARGE)
    cam = Camera.default()
    cfg = RenderConfig(width=W, height=H, bounces=1, enable_shadows=True)
    mesh = make_mesh(4, geo=2)

    img_1 = np.asarray(render_frame_jit(sc, cam, cfg))
    img_4 = np.asarray(render_geo_sharded(sc, cam, cfg, mesh))
    assert img_4.shape == img_1.shape and np.isfinite(img_4).all()
    px_same = float((np.abs(img_4 - img_1) <= 1e-4).all(-1).mean())
    assert px_same >= 0.9999, px_same

    params = init_params(sc)
    target = jnp.zeros((H, W, 4), jnp.float32)
    loss_4, g_4 = train_step_sharded(params, apply_params, sc, cam, target,
                                     cfg, mesh)
    vg_1 = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, sc, cam, target, cfg)))
    loss_1, g_1 = vg_1(params)
    np.testing.assert_allclose(float(loss_4), float(loss_1), rtol=1e-5)
    # the same kernel and hit ids on every card: only the summation order
    # of the gradient differs
    grads = compare_grads(g_4, g_1, vert_rel_l2=1e-2)
    emit("four_cards", mesh={"rays": 2, "geo": 2}, tris=int(sc.num_faces),
         image_pixels_equal=px_same, loss_4=float(loss_4),
         loss_1=float(loss_1), grads=grads,
         tolerance="pixels within 1e-4 on >= 99.99%; loss rtol 1e-5; "
                   + grad_tolerance(1e-2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4 = run only the four-card sharded path")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"error: no GPU (JAX backend {jax.default_backend()!r}); "
              "this smoke run measures the card and has no CPU fallback",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)

    t0 = _phase_start[0] = time.perf_counter()
    if args.devices == 4:
        phase_four_cards()
    else:
        phase_build(LARGE)
        phase_forward(SMALL, golden_256=True)
        phase_forward(LARGE)
        phase_training()
        phase_interactive()
        phase_kernel_vs_xla(SMALL)
        phase_kernel_vs_xla(LARGE)
    emit("done", total_seconds=time.perf_counter() - t0)
    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
