"""CLI: per-stage pipeline timing breakdown.

Usage:
    python -m raytracebvh_tpu.cli.profile [--obj Test.obj] [--width 512]
        [--height 512] [--bounces 1] [--backend jnp] [--ray-chunk 0]
        [--trace xla-trace]

Replaces the reference's stdout FPS counter (reference:
Graphics.cpp:65-92) with a real breakdown of the dispatch chain.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--obj", default="Test.obj")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--bounces", type=int, default=1)
    p.add_argument("--backend",
                   choices=["auto", "jnp", "triton"], default="auto",
                   help="traversal backend (same choices as cli.render)")
    p.add_argument("--sort", choices=["lax", "radix"],
                   default="lax")
    p.add_argument("--ray-chunk", type=int, default=0)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--trace", default=None,
                   help="also capture an XLA profiler trace to this dir")
    p.add_argument("--platform", choices=["default", "cpu", "gpu"],
                   default="default",
                   help="force the JAX platform (see cli.render)")
    args = p.parse_args(argv)

    import os

    if args.platform != "default":
        import jax as _jax

        _jax.config.update("jax_platforms", args.platform)

    from raytracebvh_tpu import Camera, RenderConfig
    from raytracebvh_tpu.core.types import scene_to_device
    from raytracebvh_tpu.io.obj import load_obj
    from raytracebvh_tpu.utils.assets import find_asset
    from raytracebvh_tpu.utils.profiling import (
        print_stage_times,
        stage_times,
        trace,
    )

    path = args.obj if os.path.isfile(args.obj) else find_asset(args.obj)
    if path is None:
        print(f"error: cannot find {args.obj}", file=sys.stderr)
        return 1
    scene = scene_to_device(load_obj(path))
    cfg = RenderConfig(
        width=args.width, height=args.height, bounces=args.bounces,
        traversal_backend=args.backend, sort_backend=args.sort,
        ray_chunk=args.ray_chunk,
    )
    cam = Camera.default()
    times = stage_times(scene, cam, cfg, iters=args.iters)
    print_stage_times(times, cfg)
    if args.trace:
        from raytracebvh_tpu.pipeline import render_frame_jit
        import jax

        with trace(args.trace):
            jax.block_until_ready(render_frame_jit(scene, cam, cfg))
        print(f"trace written to {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
