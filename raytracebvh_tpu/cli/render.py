"""CLI: render a scene to a BMP/PNG (replaces the reference's Win32 window
+ present pass; reference: Window.cpp, RayTraceBVHVS/PS.hlsl, SaveBMP.cpp).

Usage:
    python -m raytracebvh_tpu.cli.render [--obj Obj/Test.obj] [--out out.bmp]
        [--width 800] [--height 800] [--bounces 3] [--frames 1]
        [--orbit-yaw 0.1]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--obj", default="Test.obj",
                   help="OBJ file path or asset name (reference default "
                        "Obj/Test.obj, Graphics.cpp:364)")
    p.add_argument("--out", default="out.bmp")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--frames", type=int, default=1,
                   help="render N frames, orbiting the camera (FPS meter)")
    p.add_argument("--orbit-yaw", type=float, default=0.1,
                   help="per-frame yaw (reference arrow keys step .1 rad)")
    p.add_argument("--ray-chunk", type=int, default=-1,
                   help="shade-pipeline chunk size (enables chunk-level "
                        "empty culling; -1 = auto: the largest frame "
                        "divisor <= 32768 keeping >= 4 chunks, else 0)")
    p.add_argument("--camera", choices=["reference", "perspective"],
                   default="reference")
    p.add_argument("--backend",
                   choices=["auto", "jnp", "triton"],
                   default="auto",
                   help="traversal backend (default auto: the per-ray "
                        "triton kernel on a GPU, the XLA walk 'jnp' "
                        "elsewhere)")
    p.add_argument("--platform", choices=["default", "cpu", "gpu"],
                   default="default",
                   help="force the JAX platform (cpu = run the whole "
                        "pipeline on the host)")
    p.add_argument("--refract", action="store_true",
                   help="enable the refraction pass (the dispatch the "
                        "reference stubbed out, Graphics.cpp:805-809)")
    p.add_argument("--shadows", action="store_true",
                   help="fire shadow rays at --light from primary hits "
                        "(BASELINE.md config 3; beyond the reference)")
    p.add_argument("--light", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"),
                   help="world-space light position for --shadows")
    p.add_argument("--metrics", default=None,
                   help="append per-frame metrics as JSONL to this file "
                        "(implies --sync: per-frame times require the "
                        "per-frame host sync)")
    p.add_argument("--sync", action="store_true",
                   help="block on every frame (accurate per-frame "
                        "metrics).  Default is a pipelined loop: the "
                        "host enqueues frames ahead and drains the "
                        "in-order device queue about once a second, as "
                        "the reference keeps command lists in flight "
                        "(Graphics.cpp:667-831)")
    args = p.parse_args(argv)

    import os

    if args.platform != "default":
        # must happen before the first backend touch
        import jax as _jax

        _jax.config.update("jax_platforms", args.platform)

    import jax
    import numpy as np

    from raytracebvh_tpu import Camera, RenderConfig, render_frame_jit
    from raytracebvh_tpu.camera import orbit
    from raytracebvh_tpu.core.types import scene_to_device
    from raytracebvh_tpu.io.bmp import write_bmp
    from raytracebvh_tpu.io.obj import load_obj
    from raytracebvh_tpu.utils.assets import find_asset

    path = args.obj if os.path.isfile(args.obj) else find_asset(args.obj)
    if path is None:
        print(f"error: cannot find {args.obj}", file=sys.stderr)
        return 1
    scene = scene_to_device(load_obj(path))
    ray_chunk = args.ray_chunk
    if ray_chunk < 0:
        # auto: the largest divisor of the frame <= 32768 that keeps at
        # least 4 chunks (chunk culling needs granularity to win)
        r = args.width * args.height
        ray_chunk = 0
        for c in range(min(32768, r // 4), 0, -1):
            if r % c == 0:
                ray_chunk = c
                break
        if ray_chunk < 1024:  # too fine to be worth the scan
            ray_chunk = 0
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        bounces=args.bounces,
        ray_chunk=ray_chunk,
        camera_mode=args.camera,
        traversal_backend=args.backend,
        enable_refraction=args.refract,
        enable_shadows=args.shadows,
        **(dict(light_pos=tuple(args.light)) if args.light else {}),
    )
    cam = Camera.default()

    from raytracebvh_tpu.utils.logging import MetricsWriter

    rays_per_frame = cfg.width * cfg.height * (1 + cfg.bounces)
    if args.metrics and not args.sync:
        # per-frame rows need per-frame completion times
        print("note: --metrics implies --sync (per-frame timing)")
        args.sync = True
    img = None
    t0 = time.perf_counter()
    frames = 0
    last_print = t0
    last_t = t0
    with MetricsWriter(args.metrics) as mw:
        for i in range(args.frames):
            img = render_frame_jit(scene, cam, cfg)
            if args.sync or args.frames == 1:
                jax.block_until_ready(img)
                frames += 1
                now = time.perf_counter()
                mw.write("frame", frame=i, ms=(now - last_t) * 1e3,
                         mrays_per_sec=rays_per_frame
                         / max(now - last_t, 1e-9) / 1e6)
                last_t = now
            else:
                # pipelined: frames stay in flight; the device executes
                # in order, so fetching one texel of the LATEST enqueued
                # frame drains everything before it
                frames += 1
                now = time.perf_counter()
            # once-a-second FPS print (reference: Graphics.cpp:65-92)
            if now - last_print >= 1.0:
                if not args.sync:
                    np.asarray(img[0, 0])  # drain to here
                    now = time.perf_counter()
                print(f"FPS: {frames / (now - t0):.2f}")
                last_print = now
            if args.frames > 1:
                cam = orbit(cam, args.orbit_yaw, 0.0)
        if not (args.sync or args.frames == 1):
            np.asarray(img[0, 0])  # final drain
            mw.write("run", frames=args.frames,
                     ms=(time.perf_counter() - t0) * 1e3, pipelined=True)
    dt = time.perf_counter() - t0
    print(f"rendered {args.frames} frame(s) in {dt:.3f}s "
          f"({args.frames / dt:.2f} FPS)")

    arr = np.asarray(img)[..., :3]
    if args.out.lower().endswith((".png", ".jpg", ".jpeg")):
        try:
            from PIL import Image
        except ImportError:
            print("error: writing PNG/JPEG needs Pillow (pip install "
                  "pillow); use a .bmp output", file=sys.stderr)
            return 1

        Image.fromarray(
            (np.clip(arr, 0, 1) * 255 + 0.5).astype(np.uint8)
        ).save(args.out)
    else:
        write_bmp(args.out, arr)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
