"""Device mesh construction and sharding specs.

The reference has no distributed anything (single process, one GPU, one
queue; SURVEY.md section 2.3).  Its two data-parallel axes — pixels/rays
(15x15 threadgroup dispatch, Graphics.cpp:788-792) and triangles
(numGrps groups, Graphics.cpp:368) — become the two named mesh axes here:

  * ``rays``: the embarrassingly parallel axis; every device traces its
    tile of the image.  This is the framework's data-parallel axis.
  * ``geo``: geometry sharding; vertex/index arrays live sharded and are
    all-gathered over the device interconnect before traversal (BASELINE.md's
    "triangles replicated or sharded with an all-gather").

Multi-host: call ``initialize_distributed()`` first (wraps
jax.distributed.initialize), then ``make_mesh`` uses all global devices.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAYS_AXIS = "rays"
GEO_AXIS = "geo"
DCN_AXIS = "dcn"  # host boundary: collectives crossing it ride the host
# network, not the in-host device links (NVLink)


def initialize_distributed(**kwargs) -> None:
    """Multi-host init (no-op when single-process)."""
    if jax.process_count() > 1 or os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize(**kwargs)


def make_mesh(n_devices: Optional[int] = None, geo: int = 1) -> Mesh:
    """A ('rays', 'geo') mesh over the first ``n_devices`` devices.

    ``geo`` devices shard geometry; the remaining factor shards rays.
    """
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    assert n <= len(devs), f"need {n} devices, have {len(devs)}"
    assert n % geo == 0, f"{n} devices not divisible by geo={geo}"
    arr = np.array(devs[:n]).reshape(n // geo, geo)
    return Mesh(arr, (RAYS_AXIS, GEO_AXIS))


def make_host_mesh(geo: int = 1) -> Mesh:
    """A ('dcn', 'rays', 'geo') mesh: outer axis = host (process)
    boundary, inner axes = each host's local devices over NVLink.

    Layout rule (SURVEY.md section 2.3): the bandwidth-hungry collectives
    must stay inside a host, so 'geo' (geometry
    all-gather) and the first stage of the gradient reduction are inner
    axes; only the small cross-host gradient combine crosses 'dcn'.
    Rays shard over ('dcn', 'rays') together — embarrassingly parallel,
    so the host boundary costs nothing in the forward pass.
    """
    nproc = jax.process_count()
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n = len(devs)
    local = n // nproc
    assert local % geo == 0, f"{local} local devices not divisible by geo={geo}"
    arr = np.array(devs).reshape(nproc, local // geo, geo)
    return Mesh(arr, (DCN_AXIS, RAYS_AXIS, GEO_AXIS))


def ray_axes(mesh: Mesh):
    """The mesh axes the ray (data-parallel) dimension shards over:
    ('dcn', 'rays') on a host mesh, 'rays' on a flat mesh."""
    if DCN_AXIS in mesh.axis_names:
        return (DCN_AXIS, RAYS_AXIS)
    return RAYS_AXIS


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def ray_sharded(mesh: Mesh) -> NamedSharding:
    """Leading axis split over the rays axis."""
    return NamedSharding(mesh, P(RAYS_AXIS))


def geo_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(GEO_AXIS))


def pad_to_multiple(x, multiple: int, axis: int = 0, fill=0):
    """Pad a host array so axis length divides ``multiple``."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(x, pad_widths, constant_values=fill), n
