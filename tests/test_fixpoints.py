"""The five dense fixpoint rules as XLA sweeps (models/turbo.py) against
plain NumPy per-step references (tests/fixpoint_ref.py).

The sweeps are the CPU path and the specification the GPU tile-pass
kernels are held to bit for bit, so they are checked here on the shapes
that stress a tiled implementation: heights and widths that are not
multiples of a tile, images several tiles high, the stripe pattern whose
wrap-around read once leaked a smaller label across a strip edge, random
multi-tile fields with extra allow bits, and a thin spiral whose flood
needs hundreds of steps.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from gseg.models import turbo
from gseg.ops import grid_graph as gg
from tests.fixpoint_ref import BIG, IMAX, fixpoint_np, shift

RULES = ("compmin", "label_dist", "label", "value", "subsum")
CASES = ("23x70", "37x150", "64x128", "stripes160x140", "fuzz170x230",
         "spiral33")


def _spiral(n):
    """n x n: a 1-wide spiral corridor (label 1) between walls (label 0).
    Corridor nodes sit at odd coordinates; consecutive nodes of a square
    spiral over them are joined, so rings never touch, even diagonally."""
    m = (n - 1) // 2
    path = []
    top, left, bot, right = 0, 0, m - 1, m - 1
    while top <= bot and left <= right:
        path += [(top, j) for j in range(left, right + 1)]
        path += [(i, right) for i in range(top + 1, bot + 1)]
        if top < bot:
            path += [(bot, j) for j in range(right - 1, left - 1, -1)]
        if left < right:
            path += [(i, left) for i in range(bot - 1, top, -1)]
        top, left, bot, right = top + 1, left + 1, bot - 1, right - 1
    a = np.zeros((n, n), np.int32)
    for (i0, j0), (i1, j1) in zip(path, path[1:] + path[-1:]):
        a[2 * i0 + 1, 2 * j0 + 1] = 1
        a[i0 + i1 + 1, j0 + j1 + 1] = 1
    return a


def _labels(case, rng):
    """(H, W) int32 label field of `case` and its fixpoint step budget."""
    if case.startswith("stripes"):
        h, w = 160, 140
        comp = (np.arange(w)[None, :] // 3) * 2 + (np.arange(h)[:, None] >= 100)
        return np.broadcast_to(comp, (h, w)).astype(np.int32), 4 * (h + w)
    if case.startswith("fuzz"):
        return rng.integers(0, 37, (170, 230)).astype(np.int32), 4 * 400
    if case.startswith("spiral"):
        a = _spiral(33)
        return a, a.size
    h, w = (int(v) for v in case.split("x"))
    return rng.integers(0, 7, (h, w)).astype(np.int32), 4 * (h + w)


def _canonical(L):
    """8-connected same-value components relabelled to their min flat id."""
    h, w = L.shape
    lab = np.arange(h * w, dtype=np.int32).reshape(h, w)
    nls = [shift(L, dy, dx, -1) for dy, dx in gg.DIRS8]
    while True:
        new = lab.copy()
        for (dy, dx), nl in zip(gg.DIRS8, nls):
            new = np.where(nl == L, np.minimum(new, shift(lab, dy, dx, IMAX)),
                           new)
        if np.array_equal(new, lab):
            return lab
        lab = new


def _allow_bits(L, rng, extra):
    """Same-label adjacency plus random in-bounds merge marks, both ways."""
    bits = np.zeros(L.shape, np.int32)
    for d, (dy, dx) in enumerate(gg.DIRS8):
        nl = np.asarray(gg.shift_plane(jnp.asarray(L), dy, dx, -1))
        bits |= (nl == L).astype(np.int32) << d
    for d in range(4):
        dy, dx = gg.DIRS8[d]
        inb = np.asarray(gg.valid_plane(*L.shape, dy, dx))
        m = (rng.uniform(0, 1, L.shape) < extra) & inb
        back = np.asarray(gg.shift_plane(jnp.asarray(m), -dy, -dx, False))
        bits |= m.astype(np.int32) << d
        bits |= back.astype(np.int32) << (d + 4)
    return bits


def _inputs(rule, case):
    rng = np.random.default_rng(sum(map(ord, rule + case)))
    L, steps = _labels(case, rng)
    h, w = L.shape
    extra = 0.0 if case.startswith(("stripes", "spiral")) else 0.04
    if rule == "compmin":
        return L, (rng.uniform(0, 1, (h, w)).astype(np.float32),
                   rng.integers(0, 10_000, (h, w)).astype(np.int32),
                   rng.integers(1, 9, (h, w)).astype(np.int32)), steps
    if rule in ("label", "label_dist"):
        allow = _allow_bits(L, rng, extra)
        if case.startswith("stripes"):  # labels decrease with depth
            lc = ((h - np.arange(h))[:, None] * 1000
                  + np.arange(w)[None, :]).astype(np.int32)
        else:
            lc = rng.integers(0, 1 << 20, (h, w)).astype(np.int32)
        idf = rng.uniform(0, 5, (h, w)).astype(np.float32)
        if rule == "label":
            return allow, (lc, idf), steps
        dist = np.where(rng.random((h, w)) < 0.05, 0, BIG).astype(np.int32)
        return allow, (lc, idf, dist), steps
    C = _canonical(L)
    roots = C == np.arange(h * w, dtype=np.int32).reshape(h, w)
    if rule == "value":
        seed = np.where(roots, rng.integers(0, 1 << 20, (h, w)), IMAX)
        return C, (seed.astype(np.int32),), steps
    # subsum: parent directions of the BFS tree from each component root.
    same = np.zeros((h, w), np.int32)
    for d, (dy, dx) in enumerate(gg.DIRS8):
        nl = np.asarray(gg.shift_plane(jnp.asarray(C), dy, dx, -1))
        same |= (nl == C).astype(np.int32) << d
    (_, _, dist), _ = fixpoint_np(
        "label_dist", same, (C, np.zeros((h, w), np.float32),
                             np.where(roots, 0, BIG).astype(np.int32)),
        h * w)
    pdir = np.asarray(turbo._parent_dirs(jnp.asarray(C), jnp.asarray(dist)))
    return pdir, (np.ones((h, w), np.int32),), steps


def _sweep(rule, ro, planes, steps):
    ro = jnp.asarray(ro)
    planes = [jnp.asarray(p) for p in planes]
    if rule in ("label", "label_dist"):
        allow8 = jnp.stack([((ro >> d) & 1) > 0 for d in range(8)])
    if rule == "compmin":
        return turbo._compmin_gossip(ro, *planes, steps)
    if rule == "label_dist":
        return turbo._label_gossip(planes[0], allow8, *planes[1:], steps)
    if rule == "label":
        return turbo._label_gossip_nd(planes[0], allow8, planes[1], steps)
    if rule == "value":
        return turbo._value_flood(ro, planes[0], steps)
    return turbo._subtree_sweeps(ro, planes[0], steps)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("rule", RULES)
def test_sweep_matches_numpy_reference(rule, case):
    ro, planes, steps = _inputs(rule, case)
    ref, ref_unconv = fixpoint_np(rule, ro, planes, steps)
    assert not ref_unconv
    *got, unconv = _sweep(rule, ro, planes, steps)
    assert not bool(unconv)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), r)
    if rule == "value":  # every pixel carries its component root's seed
        assert (np.asarray(got[0]) != IMAX).all()
    if rule == "subsum":  # the root's sum is its component's size
        C = _canonical(_labels(case, np.random.default_rng(
            sum(map(ord, rule + case))))[0])
        roots, counts = np.unique(C, return_counts=True)
        assert np.array_equal(np.asarray(got[0]).ravel()[roots], counts)
