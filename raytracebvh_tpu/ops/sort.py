"""Sort leaves by morton code.

The reference implements a 32-pass 1-bit LSD radix sort as two compute
shaders per pass (block-local Blelloch scan + cross-group serial scan and
scatter; reference: RadixSortP1.hlsl, RadixSortP2.hlsl, dispatched 32x from
Graphics.cpp:735-754).  Here the idiomatic primitive is XLA's single
fused stable ``lax.sort``, so the 32 round trips through device memory
collapse into one op.
``radix_sort_by_code`` below keeps the reference's pass-for-pass algorithm
as a parity backend / semantic spec.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def sort_by_code(codes):
    """Stable-sort ``codes`` ascending; returns (sorted_codes, order).

    ``order[k]`` is the pre-sort leaf index that landed at slot ``k`` —
    the payload the reference carries by scattering whole 48-byte Nodes
    (reference: RadixSortP2.hlsl:55-60).  Stability gives ascending
    pre-sort indices within equal codes, which the Karras builder's
    index tie-break relies on (reference: BVHConstructP1.hlsl:61-72).
    """
    n = codes.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    sorted_codes, order = jax.lax.sort(
        (codes, idx), dimension=0, is_stable=True, num_keys=1
    )
    return sorted_codes, order


def radix_sort_by_code(codes, bits: int = 30):
    """The reference's 1-bit LSD radix sort, algorithm-for-algorithm.

    Per pass p (reference: RadixSortP1.hlsl + RadixSortP2.hlsl, dispatched
    32x from Graphics.cpp:735-754): read bit p, exclusive-scan the
    inverted bits (the Blelloch scan of P1 + the cross-group serial scan
    of P2 collapse into one ``cumsum`` — XLA's scan is already
    device-wide, so the threadgroup/group split disappears), then scatter
    zeros before ones at offset netOnes (the P2 scatter rule,
    RadixSortP2.hlsl:42-53).  Each pass is stable, so the result is the
    same permutation the reference produces.

    30 passes suffice for 30-bit morton codes; the reference runs 32
    because its pass counter is baked into a UAV loop (quirk Q8).
    ``sort_by_code`` (one fused lax.sort) is the production path — this
    exists for reference parity and as the semantic spec of the sort.
    """
    n = codes.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)

    def one_pass(p, state):
        codes, order = state
        bit = ((codes >> p) & 1).astype(jnp.int32)
        zeros_before = jnp.cumsum(1 - bit) - (1 - bit)  # exclusive scan
        net_zeros = zeros_before[-1] + (1 - bit[-1])
        dst = jnp.where(
            bit == 0, zeros_before, net_zeros + pos - zeros_before
        )
        codes = jnp.zeros_like(codes).at[dst].set(codes)
        order = jnp.zeros_like(order).at[dst].set(order)
        return codes, order

    codes, order = jax.lax.fori_loop(
        0, bits, one_pass, (codes, jnp.arange(n, dtype=jnp.int32))
    )
    return codes, order
