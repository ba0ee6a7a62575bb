"""LBVH construction: Karras-2012 hierarchy emit + AABB fit + skip links.

The reference builds the hierarchy with one thread per internal node
(reference: BVHConstructP1.hlsl:99-188, citing the Karras HPG 2012 paper)
and fits AABBs bottom-up with global atomics gating a per-node climb
(reference: BVHConstructP2.hlsl:11-36, self-described "HIGHLY DIVERGENT").

Data-parallel re-design (the whole build is loop-free in tree depth):
  * The Karras searches are vectorized over *all* internal nodes at once;
    the exponential/binary searches become fixed-trip-count ``fori_loop``s
    over gather + select — no divergence, no scalar threads.
  * Karras internal nodes cover *contiguous leaf ranges* [lo, hi] — the
    searches compute them anyway.  That makes the AABB fit a batch of
    range-min/max queries: build a sparse table (log2(n) rounds of
    shifted elementwise min — no gathers, no sequential tree-depth loop),
    then answer every internal node with TWO row gathers.  This replaces
    both the reference's atomic climb (BVHConstructP2.hlsl:11-36) and
    round 1's O(depth) level-synchronous ``while_loop``.
  * Skip links have a closed form in range space: the next subtree after
    node x in left-first DFS order is the *topmost* node whose range
    starts at hi(x)+1, and that node is always some parent's right child
    — so one scatter (right child -> its range start) plus one gather
    computes every link.  No loop.  (Threading equals the order the
    reference's stack traversal visits: RayTraceTraversal.hlsl:184-191
    pushes right, descends left.)

Node ids: leaf k in [0,n), internal i stored at id n+i, root = n
(reference numbering: BVHConstructP1.hlsl:152-163,178-187).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

BIG = 1.0e30  # empty-box sentinel: bbmin=+BIG, bbmax=-BIG (union identity)


class Topology(NamedTuple):
    """Tree topology arrays, all sized [2n] (slot 2n-1 unused).

    ``node_lo``/``node_hi`` are the contiguous leaf ranges each node
    covers (leaf k covers [k, k]); they drive the AABB fit and the link
    computation and are kept on the BVH for tests/debug.
    """

    child_l: Any  # int32, -1 for leaves
    child_r: Any  # int32, -1 for leaves
    parent: Any  # int32, -1 at root
    node_lo: Any  # int32 first leaf of the node's range
    node_hi: Any  # int32 last leaf of the node's range


def _clz32(x):
    return jax.lax.clz(x.astype(jnp.uint32)).astype(jnp.int32)


def make_delta(codes):
    """Returns delta(i, j) -> common-prefix length, vectorized.

    Matches the reference exactly (BVHConstructP1.hlsl:61-84): clz of the
    code XOR; when codes are equal, 32 + clz of the index XOR breaks the
    tie; out-of-range j gives -1.
    """
    n = codes.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        cj = codes[jnp.clip(j, 0, n - 1)]
        x = codes[i] ^ cj
        base = _clz32(x)
        tie = 32 + _clz32((i ^ j).astype(jnp.uint32))
        d = jnp.where(x == 0, tie, base)
        return jnp.where(valid, d, -1)

    return delta


def karras_children(codes):
    """Children and leaf ranges of every internal node (Karras emit).

    Args:
      codes: [n] uint32 *sorted* morton codes (duplicates allowed; the
        index tie-break makes keys effectively distinct).

    Returns:
      (child_l, child_r, lo, hi): [n-1] int32 each.  Children are node
      ids (leaf ids < n, internal ids >= n), matching reference
      BVHConstructP1.hlsl:152-163; [lo, hi] is the contiguous sorted-leaf
      range internal node i covers (lo = min(i, j), hi = max(i, j) in the
      paper's terms).
    """
    n = codes.shape[0]
    assert n >= 2, "karras_children needs at least 2 leaves"
    delta = make_delta(codes)
    i = jnp.arange(n - 1, dtype=jnp.int32)

    # direction: -1 iff delta(i,i+1) < delta(i,i-1)
    # (reference: BVHConstructP1.hlsl:104-105)
    d = jnp.where(delta(i, i + 1) < delta(i, i - 1), -1, 1).astype(jnp.int32)
    dmin = delta(i, i - d)

    # exponential upper bound: boundLen doubles while the prefix grows
    # (reference: BVHConstructP1.hlsl:108-116)
    n_double = max(2, int(math.ceil(math.log2(n))) + 2)

    def grow(_, state):
        lmax, stopped = state
        pred = (delta(i, i + lmax * d) > dmin) & ~stopped
        return jnp.where(pred, lmax << 1, lmax), stopped | ~pred

    lmax, _ = jax.lax.fori_loop(
        0,
        n_double,
        grow,
        (jnp.full(n - 1, 2, jnp.int32), jnp.zeros(n - 1, bool)),
    )

    n_halve = n_double + 2

    def halving_search(t0, threshold):
        """do { t=(t+1)>>1; if delta(i, i+(s+t)d) > threshold: s+=t; }
        while (1 < t);  (reference: BVHConstructP1.hlsl:123-131,141-148)"""

        def body(_, state):
            t, s, done = state
            t_new = jnp.where(done, t, (t + 1) >> 1)
            pred = (delta(i, i + (s + t_new) * d) > threshold) & ~done
            s = jnp.where(pred, s + t_new, s)
            done = done | (t_new <= 1)
            return t_new, s, done

        _, s, _ = jax.lax.fori_loop(
            0,
            n_halve,
            body,
            (t0, jnp.zeros(n - 1, jnp.int32), jnp.zeros(n - 1, bool)),
        )
        return s

    # other end of the range
    l = halving_search(lmax, dmin)
    j = i + l * d
    dnode = delta(i, j)

    # split position (reference: BVHConstructP1.hlsl:136-150)
    s = halving_search(l, dnode)
    gamma = i + s * d + jnp.minimum(d, 0)

    lo = jnp.minimum(i, j)
    hi = jnp.maximum(i, j)
    child_l = jnp.where(lo == gamma, gamma, gamma + n).astype(jnp.int32)
    child_r = jnp.where(hi == gamma + 1, gamma + 1, gamma + 1 + n).astype(jnp.int32)
    return child_l, child_r, lo, hi


def karras_children_rmq(codes):
    """Exact ``karras_children`` via range-min descent — 2.4x fewer
    device rounds than the reference-shaped searches.

    Key identity: for *sorted* codes with the reference's index tie-break
    (BVHConstructP1.hlsl:61-72), ``delta(i, j) = min(adelta[i..j-1])``
    where ``adelta[k] = delta(k, k+1)`` — the common-prefix length of any
    pair is the minimum over the adjacent pairs between them (the highest
    bit differing between i and j must flip at some adjacent step, and no
    higher bit can flip inside the range).  Every Karras search condition
    ``delta(i, i+l*d) > threshold`` therefore becomes "no entry <=
    threshold in the adjacent-delta range", and each search collapses to
    a single first/last-blocker query answered by binary descent over a
    sparse table of power-of-two block minima:

      * range end   (BVHConstructP1.hlsl:108-131): first k >= i with
        adelta[k] <= delta(i, i-d)   (d = +1), mirrored for d = -1
      * split gamma (BVHConstructP1.hlsl:136-150): first (d=+1) /
        last (d=-1) k in the range with adelta[k] <= delta(i, j) — i.e.
        the direction-sided argmin

    The tables are built with shifted elementwise mins (no gathers), and
    the descent is CHUNKED: one [*, 16]-row gather serves FOUR descent
    levels — the row holds the block-min probe for every step-combination
    of the chunk's levels (2^j probes for the j-th level), and the
    in-chunk walk is pure elementwise selects.  ~12 gathers total (2
    descents x ceil(18/4) chunks + a 2-gather RMQ) vs ~63 heavier rounds
    for the exponential+binary searches.

    Parity: bit-identical output to ``karras_children``
    (tests/test_bvh.py::test_rmq_matches_search).
    """
    n = codes.shape[0]
    assert n >= 2
    i32 = jnp.int32

    # adjacent deltas, index tie-break folded in; length n-1
    k = jnp.arange(n - 1, dtype=i32)
    x = codes[:-1] ^ codes[1:]
    adelta = jnp.where(
        x == 0, 32 + _clz32((k ^ (k + 1)).astype(jnp.uint32)), _clz32(x)
    ).astype(i32)

    # pad to a power of two with -1 = "blocks every threshold >= -1":
    # out-of-range delta is -1 in the reference (leadingPrefixBounds,
    # BVHConstructP1.hlsl:78-84), so searches stop at the array edge
    P = 1 << max(1, int(math.ceil(math.log2(max(n - 1, 2)))))
    levels = int(math.log2(P))
    a_pad = jnp.full(P, -1, i32).at[: n - 1].set(adelta)

    # M[L][p] = min(a[p .. p+2^L-1])  (right/prefix table)
    # N[L][p] = min(a[p-2^L+1 .. p])  (left/suffix table)
    # shifted-in fill = -2: a block crossing the array edge refuses the
    # step at that level; lower levels finish the walk
    Ms, Ns = [a_pad], [a_pad]
    for L in range(1, levels + 1):
        s = 1 << (L - 1)
        pm = Ms[-1]
        Ms.append(jnp.minimum(
            pm, jnp.concatenate([pm[s:], jnp.full(s, -2, i32)])))
        pn = Ns[-1]
        Ns.append(jnp.minimum(
            pn, jnp.concatenate([jnp.full(s, -2, i32), pn[:-s]])))
    # (min, first-argmin, last-argmin) rows for the dnode/split RMQ —
    # the split gamma is the direction-sided argmin of the range
    # (first blocker of delta(i,j) from the i side, see below), so the
    # SAME two row gathers that answer dnode also answer gamma and the
    # whole second descent disappears.  Built with shifted elementwise
    # combines, no gathers.
    iota = jnp.arange(P, dtype=i32)
    Avs, Afs, Als = [a_pad], [iota], [iota]
    for L in range(1, levels + 1):
        s = 1 << (L - 1)
        va, fa_, la_ = Avs[-1], Afs[-1], Als[-1]
        vb = jnp.concatenate([va[s:], jnp.full(s, -2, i32)])
        fb_ = jnp.concatenate([fa_[s:], jnp.full(s, 0, i32)])
        lb_ = jnp.concatenate([la_[s:], jnp.full(s, 0, i32)])
        Avs.append(jnp.minimum(va, vb))
        Afs.append(jnp.where(va <= vb, fa_, fb_))
        Als.append(jnp.where(vb <= va, lb_, la_))
    tblA = jnp.stack(
        [jnp.concatenate(Avs), jnp.concatenate(Afs),
         jnp.concatenate(Als), jnp.zeros((levels + 1) * P, i32)], -1
    )  # [(levels+1)*P, 4] rows (min, argfirst, arglast, pad)

    # chunk the descent levels in groups of 4; per chunk, a [2P, 16] row
    # table holds M/N[l_j][p +- off] for every step-combination `off` of
    # the chunk's earlier levels, so ONE row gather per chunk replaces 4
    # per-level gathers.  Column layout: (1 << j) - 1 + s, where s packs
    # the step bits taken so far within the chunk (MSB first).
    CHK = 4
    chunks = []  # (levels list, fused row table [2P, W])
    L = levels
    while L >= 0:
        ks = list(range(L, max(L - CHK, -1), -1))
        cols_r, cols_l = [], []
        for j, l in enumerate(ks):
            for s in range(1 << j):
                off = 0
                for m in range(j):
                    if (s >> (j - 1 - m)) & 1:
                        off += 1 << ks[m]
                if off >= P:  # whole column off-array -> refused
                    cols_r.append(jnp.full(P, -2, i32))
                    cols_l.append(jnp.full(P, -2, i32))
                    continue
                mm = Ms[l]
                cols_r.append(mm if off == 0 else jnp.concatenate(
                    [mm[off:], jnp.full(off, -2, i32)]))
                nn = Ns[l]
                cols_l.append(nn if off == 0 else jnp.concatenate(
                    [jnp.full(off, -2, i32), nn[:-off]]))
        R = jnp.concatenate(
            [jnp.stack(cols_r, -1), jnp.stack(cols_l, -1)], axis=0
        )  # [2P, 2^len-1]
        chunks.append((ks, R))
        L -= CHK

    i = jnp.arange(n - 1, dtype=i32)
    dleft = jnp.concatenate([jnp.full(1, -1, i32), adelta[:-1]])
    dright = adelta
    # direction (BVHConstructP1.hlsl:104-105): -1 iff delta(i,i+1) <
    # delta(i,i-1)
    pos_dir = dright >= dleft
    d = jnp.where(pos_dir, 1, -1).astype(i32)

    def blocker(start, T, pos_dir):
        """first (pos_dir) / last (!pos_dir) index p from ``start`` with
        a[p] <= T, walking away from the node.  Chunked vectorized binary
        descent; per-lane table half selected by direction.  Off-array
        probes read the -2 shifted-in fill and refuse the step."""
        pos = start
        for ks, R in chunks:
            ridx = jnp.clip(pos, 0, P - 1) + jnp.where(pos_dir, 0, P)
            rowv = R[ridx]  # [n-1, W]
            s = jnp.zeros_like(pos)
            for j, l in enumerate(ks):
                base = (1 << j) - 1
                col = base + s
                probe = rowv[:, base]
                for c in range(base + 1, base + (1 << j)):
                    probe = jnp.where(col == c, rowv[:, c], probe)
                can = (probe > T) & (pos >= 0) & (pos < P)
                step = jnp.where(pos_dir, 1 << l, -(1 << l))
                pos = jnp.where(can, pos + step, pos)
                s = 2 * s + can.astype(i32)
        return pos

    # range end: first blocker of threshold dmin = delta(i, i-d)
    T_range = jnp.where(pos_dir, dleft, dright)
    b = blocker(jnp.where(pos_dir, i, i - 1), T_range, pos_dir)
    # blocked AT b => delta(i, b+d) <= dmin => other end j = b (d=+1) /
    # b+1 (d=-1); a walk that fell off the left edge means the range
    # reaches leaf 0
    j = jnp.where(pos_dir, jnp.minimum(b, n - 1), jnp.maximum(b, -1) + 1)
    lo = jnp.minimum(i, j)
    hi = jnp.maximum(i, j)

    # dnode + split in one RMQ (2 row gathers): dnode = delta(i, j) =
    # min(adelta[lo .. hi-1]); the Karras split search (first/last k in
    # the range with adelta[k] <= dnode, BVHConstructP1.hlsl:136-150) is
    # the leftmost (d=+1) / rightmost (d=-1) argmin of the same range
    length = hi - lo  # >= 1 adjacent entries
    kL = 31 - _clz32(length)
    ra = tblA[kL * P + lo]  # covers [lo, lo + 2^kL)
    rb = tblA[kL * P + hi - (1 << kL).astype(i32)]  # [hi - 2^kL, hi)
    ma, mb = ra[:, 0], rb[:, 0]
    gfirst = jnp.where(ma <= mb, ra[:, 1], rb[:, 1])
    glast = jnp.where(mb <= ma, rb[:, 2], ra[:, 2])
    gamma = jnp.where(pos_dir, gfirst, glast)
    gamma = jnp.clip(gamma, lo, hi - 1)

    child_l = jnp.where(lo == gamma, gamma, gamma + n).astype(i32)
    child_r = jnp.where(hi == gamma + 1, gamma + 1, gamma + 1 + n).astype(i32)
    return child_l, child_r, lo, hi


def build_topology(codes) -> Topology:
    """Full tree topology, arrays sized [2n] (slot 2n-1 unused).

    parent[root] = -1 (reference: BVHConstructP1.hlsl:174-187 sets
    children, parents, and the root parent to UINT_MAX).
    """
    n = codes.shape[0]
    cl, cr, lo, hi = karras_children_rmq(codes)
    ids = jnp.arange(n - 1, dtype=jnp.int32) + n
    child_l = jnp.full(2 * n, -1, jnp.int32).at[ids].set(cl)
    child_r = jnp.full(2 * n, -1, jnp.int32).at[ids].set(cr)
    parent = jnp.full(2 * n, -1, jnp.int32)
    parent = parent.at[cl].set(ids)
    parent = parent.at[cr].set(ids)
    parent = parent.at[n].set(-1)  # root
    leaf_ids = jnp.arange(n, dtype=jnp.int32)
    node_lo = jnp.concatenate([leaf_ids, lo, jnp.zeros(1, jnp.int32)])
    node_hi = jnp.concatenate([leaf_ids, hi, jnp.zeros(1, jnp.int32)])
    return Topology(child_l, child_r, parent, node_lo, node_hi)


def fit_aabbs(node_lo, node_hi, leaf_bbmin, leaf_bbmax):
    """AABB fit as batched range-min/max queries over the leaf ranges.

    Replaces the reference's InterlockedAdd-gated climb
    (BVHConstructP2.hlsl:11-36) — and, unlike a level-synchronous sweep,
    has NO sequential dependence on tree depth: a sparse table of
    power-of-two range minima is built in ceil(log2(n)) rounds of shifted
    elementwise mins (no gathers), then every internal node is
    answered with two row gathers (RMQ: min of the two 2^k blocks
    covering [lo, hi]).  Max queries ride along negated so one table
    serves all six channels.

    Args:
      node_lo/node_hi: [2n] leaf ranges from ``build_topology``.
      leaf_bbmin/leaf_bbmax: [n, 3] leaf boxes in sorted (morton) order.

    Returns (bbmin, bbmax): [2n, 3]; box union = min/max of the range
    (minUnion/maxUnion semantics, RayTraceGlobal.hlsl:132-142).
    """
    n = leaf_bbmin.shape[0]
    dt = leaf_bbmin.dtype
    levels = max(1, int(math.ceil(math.log2(n))))

    # level 0: (minx,miny,minz,-maxx,-maxy,-maxz) so everything is a min
    tbl0 = jnp.concatenate([leaf_bbmin, -leaf_bbmax], axis=1)  # [n, 6]
    tables = [tbl0]
    for k in range(1, levels + 1):
        prev = tables[-1]
        s = 1 << (k - 1)
        shifted = jnp.concatenate(
            [prev[s:], jnp.full((s, 6), BIG, dt)], axis=0
        )
        tables.append(jnp.minimum(prev, shifted))
    stacked = jnp.concatenate(tables, axis=0)  # [(levels+1)*n, 6]

    lo = node_lo[n:-1]
    hi = node_hi[n:-1]
    length = hi - lo + 1  # >= 2 for internal nodes
    k = 31 - _clz32(length)
    a = stacked[k * n + lo]  # [n-1, 6]
    b = stacked[k * n + hi + 1 - (1 << k)]
    m = jnp.minimum(a, b)

    bbmin = jnp.concatenate(
        [leaf_bbmin, m[:, :3], jnp.full((1, 3), BIG, dt)]
    )
    bbmax = jnp.concatenate(
        [leaf_bbmax, -m[:, 3:], jnp.full((1, 3), -BIG, dt)]
    )
    return bbmin, bbmax


def fit_aabbs_levelsync(child_l, child_r, leaf_bbmin, leaf_bbmax):
    """Round-1 level-synchronous AABB fit, kept as an independent parity
    reference for ``fit_aabbs`` (tests assert they agree).

    Each round, every internal node whose two children are settled takes
    the union of their boxes; one tree level settles per round, so the
    loop runs depth(T) times — the direct de-atomic-ized analog of the
    reference's climb (BVHConstructP2.hlsl:11-36).
    """
    n = leaf_bbmin.shape[0]
    two_n = 2 * n
    is_internal = (jnp.arange(two_n) >= n) & (jnp.arange(two_n) < two_n - 1)

    dt = leaf_bbmin.dtype
    mins = tuple(
        jnp.full(two_n, BIG, dt).at[:n].set(leaf_bbmin[:, k]) for k in range(3)
    )
    maxs = tuple(
        jnp.full(two_n, -BIG, dt).at[:n].set(leaf_bbmax[:, k]) for k in range(3)
    )
    ready = jnp.arange(two_n) < n

    cl = jnp.maximum(child_l, 0)
    cr = jnp.maximum(child_r, 0)

    def cond(state):
        _, _, ready, it = state
        return (~ready[n]) & (it < two_n)

    def body(state):
        mins, maxs, ready, it = state
        settled = is_internal & ready[cl] & ready[cr]
        upd = settled & ~ready
        mins = tuple(
            jnp.where(upd, jnp.minimum(m[cl], m[cr]), m) for m in mins
        )
        maxs = tuple(
            jnp.where(upd, jnp.maximum(m[cl], m[cr]), m) for m in maxs
        )
        return mins, maxs, ready | settled, it + 1

    mins, maxs, _, _ = jax.lax.while_loop(
        cond, body, (mins, maxs, ready, jnp.int32(0))
    )
    return jnp.stack(mins, axis=-1), jnp.stack(maxs, axis=-1)


def compute_links(topo: Topology, n: int):
    """Skip links for stackless traversal — closed form, no loop.

    skip(root) = -1; skip(left child of p) = right child of p;
    skip(right child of p) = skip(p).  In leaf-range terms that chain
    collapses to: skip(x) = the TOPMOST node whose range starts at
    hi(x)+1 (or -1 when hi(x) is the last leaf).  The topmost node
    starting at any position s > 0 is always the unique *right child*
    whose range starts there, so one scatter of every right child to its
    range start plus one gather by hi+1 yields every link.  This threads
    the tree in the same left-first depth-first order the reference's
    stack traversal visits (reference: RayTraceTraversal.hlsl:184-191
    pushes right, descends left).

    Returns (entry_link, skip_link): [2n] int32; entry_link = left child
    for internal nodes, = skip for leaves.
    """
    two_n = 2 * n
    ids = jnp.arange(two_n, dtype=jnp.int32)

    cr = topo.child_r[n:-1]  # right child of each internal node
    cr_start = topo.node_lo[cr]  # where its range starts
    # topmost node starting at s: default = leaf s (covers the case where
    # no internal node starts at s; queried positions always have a
    # right-child writer, see docstring)
    topmost = jnp.arange(n, dtype=jnp.int32).at[cr_start].set(cr)

    nxt = jnp.minimum(topo.node_hi + 1, n - 1)
    skip = jnp.where(topo.node_hi >= n - 1, -1, topmost[nxt])
    entry = jnp.where(ids < n, skip, topo.child_l)
    return entry, skip


def preorder_ranks_from_ranges(node_lo, node_hi, n: int):
    """DFS pre-order ranks from the leaf ranges — ONE 2-key sort.

    In a left-first DFS over a leaf-range-partition tree, node u precedes
    node v iff lo(u) < lo(v), or lo(u) == lo(v) and u's range is larger
    (an ancestor on the same left spine).  Pre-order is therefore exactly
    the lexicographic sort by (lo ascending, hi descending) — no
    pointer-jumping over the entry links (``preorder_ranks``; that costs
    ceil(log2(2n)) rounds of two [2n] gathers).  (lo, hi) pairs are
    unique: ranges of distinct nodes are never identical.

    Returns (rank, inv): rank[id] = pre-order position, inv[r] = node id
    at rank r; the unused topology slot (id 2n-1) is pinned to rank 2n-1.

    Parity: identical to ``preorder_ranks(entry_link, n)``
    (tests/test_bvh.py).
    """
    two_n = 2 * n
    ids = jnp.arange(two_n, dtype=jnp.int32)
    # unused slot: lo = n sorts after every real lo (<= n-1)
    lo = node_lo.at[two_n - 1].set(n)
    hi = node_hi.at[two_n - 1].set(-1)
    _, _, inv = jax.lax.sort((lo, -hi, ids), num_keys=2)
    rank = jnp.zeros(two_n, jnp.int32).at[inv].set(ids)
    return rank, inv


def preorder_ranks(entry_link, n: int):
    """DFS pre-order rank of every node, loop-free in tree depth.

    The entry links already thread the tree in pre-order: for every node,
    ``entry`` is the next node the traversal visits when its box is hit
    (left child for internal nodes, skip for leaves — see
    ``compute_links``), so following ``entry`` from the root enumerates
    all 2n-1 nodes in exact pre-order.  Ranking that linked list is
    pointer doubling: ceil(log2(2n)) rounds of ``d += d[p]; p = p[p]``
    (two 1-D gathers per round), no O(depth) sweep.

    Rank space is what the Pallas traversal's preorder node table is laid
    out in: rank(root) = 0 and rank(left child) = rank(parent) + 1, which
    makes the descend step a simple ``+1`` (no entry-link storage).

    Returns [2n] int32 ranks in [0, 2n-1); the unused topology slot
    (id 2n-1) is pinned to rank 2n-1 so scatters by rank can't collide.
    """
    two_n = 2 * n
    sentinel = two_n - 1  # unused topology slot doubles as list terminator
    ids = jnp.arange(two_n, dtype=jnp.int32)
    nxt = jnp.where(entry_link < 0, sentinel, entry_link)
    nxt = nxt.at[sentinel].set(sentinel)  # self-loop terminator
    d = jnp.where(ids == sentinel, 0, 1).astype(jnp.int32)

    rounds = max(1, int(math.ceil(math.log2(two_n))))

    def body(_, state):
        d, p = state
        return d + d[p], p[p]

    d, _ = jax.lax.fori_loop(0, rounds, body, (d, nxt))
    # d(x) = hops from x to the terminator; the head (root) has the most
    rank = (two_n - 1) - d
    return rank.at[sentinel].set(sentinel)


def compute_links_levelsync(child_l, child_r, parent, n):
    """Round-1 top-down level-synchronous link computation, kept as an
    independent parity reference for ``compute_links``."""
    two_n = 2 * n
    ids = jnp.arange(two_n, dtype=jnp.int32)
    has_parent = parent >= 0
    p = jnp.maximum(parent, 0)

    skip = jnp.full(two_n, -1, jnp.int32)
    settled = ~has_parent

    def cond(state):
        _, settled, it = state
        return (~jnp.all(settled)) & (it < two_n)

    def body(state):
        skip, settled, it = state
        cand = jnp.where(ids == child_l[p], child_r[p], skip[p])
        newly = has_parent & settled[p] & ~settled
        skip = jnp.where(newly, cand, skip)
        return skip, settled | newly, it + 1

    skip, _, _ = jax.lax.while_loop(cond, body, (skip, settled, jnp.int32(0)))
    entry = jnp.where(ids < n, skip, child_l)
    return entry, skip
