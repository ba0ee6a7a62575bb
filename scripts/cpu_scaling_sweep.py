#!/usr/bin/env python
"""Weak-scaling sweep on a virtual 8-device CPU mesh; prints one line per
mesh size.

Run: python scripts/cpu_scaling_sweep.py [max_devices]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    from raytracebvh_tpu.parallel.scaling import weak_scaling_sweep

    records = weak_scaling_sweep(n)
    for r in records:
        print(
            f"d={r['devices']} mesh={r['mesh']} step={r['step_ms']:.1f}ms "
            f"ov={r['step_ms_overlapped']:.1f}ms "
            f"eff={r['weak_scaling_efficiency']:.3f}", flush=True,
        )


if __name__ == "__main__":
    main()
