"""Plain NumPy references for turbo's five dense fixpoint rules.

One step of each rule, written from the rule's definition in
models/turbo.py (8 neighbours in grid_graph.DIRS8 order, chained within a
step, out-of-image neighbours read as the fill), iterated to its fixpoint.
`tile_pass_np` emulates ops/tilepass.py's kernel pass: tiles with a
`steps`-cell halo, out-of-image cells pinned to the fill, interior written
back, one changed flag.
"""

import numpy as np

from gseg.ops import grid_graph as gg
from gseg.ops import tilepass

IMAX = np.iinfo(np.int32).max
BIG = 1 << 30


def shift(x, dy, dx, fill):
    """out[y, x] = x[y + dy, x + dx] in bounds, else fill."""
    h, w = x.shape
    out = np.full_like(x, fill)
    y0, y1 = max(-dy, 0), h - max(dy, 0)
    x0, x1 = max(-dx, 0), w - max(dx, 0)
    if y1 > y0 and x1 > x0:
        out[y0:y1, x0:x1] = x[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


def _nb(x, fill):
    return [shift(x, dy, dx, fill) for dy, dx in gg.DIRS8]


def compmin_step(L, planes):
    bw, be, sz = (p.copy() for p in planes)
    nL, nbw, nbe, nsz = (_nb(L, -1), _nb(planes[0], np.inf),
                         _nb(planes[1], IMAX), _nb(planes[2], 0))
    for d in range(8):
        same = nL[d] == L
        take = same & ((nbw[d] < bw) | ((nbw[d] == bw) & (nbe[d] < be)))
        bw = np.where(take, nbw[d], bw)
        be = np.where(take, nbe[d], be)
        sz = np.where(same & (nsz[d] > sz), nsz[d], sz)
    return bw, be, sz


def label_dist_step(allow, planes):
    lc, idf, dist = (p.copy() for p in planes)
    nl, nid, nds = (_nb(planes[0], IMAX), _nb(planes[1], 0.0),
                    _nb(planes[2], BIG))
    for d in range(8):
        a = ((allow >> d) & 1) > 0
        cand = np.where(nds[d] >= BIG, BIG, nds[d] + 1).astype(np.int32)
        adopt = a & (nl[d] < lc)
        relax = a & (nl[d] == lc) & (cand < dist)
        dist = np.where(adopt | relax, cand, dist)
        lc = np.where(adopt, nl[d], lc)
        idf = np.where(a & (nid[d] > idf), nid[d], idf)
    return lc, idf, dist


def label_step(allow, planes):
    lc, idf = (p.copy() for p in planes)
    nl, nid = _nb(planes[0], IMAX), _nb(planes[1], 0.0)
    for d in range(8):
        a = ((allow >> d) & 1) > 0
        lc = np.where(a & (nl[d] < lc), nl[d], lc)
        idf = np.where(a & (nid[d] > idf), nid[d], idf)
    return lc, idf


def value_step(L, planes):
    (val,) = planes
    nL, nv = _nb(L, -1), _nb(val, IMAX)
    out = val.copy()
    for d in range(8):
        out = np.where((nL[d] == L) & (nv[d] < out), nv[d], out)
    return (out,)


def subsum_step(pdir, planes):
    (s,) = planes
    npd, ns = _nb(pdir, 8), _nb(s, 0)
    total = np.ones_like(s)
    for d in range(8):
        total = total + np.where(npd[d] == (d + 4) % 8, ns[d], 0)
    return (total.astype(np.int32),)


# rule -> (step, read-only fill, read-write fills); mirrors tilepass.cu.
RULES = {
    "compmin": (compmin_step, -1, (np.inf, IMAX, 0)),
    "label_dist": (label_dist_step, 0, (IMAX, 0.0, BIG)),
    "label": (label_step, 0, (IMAX, 0.0)),
    "value": (value_step, -1, (IMAX,)),
    "subsum": (subsum_step, 8, (0,)),
}


def fixpoint_np(rule, ro, planes, max_steps):
    """Steps until one changes nothing. Returns (planes, unconverged)."""
    step = RULES[rule][0]
    planes = tuple(np.asarray(p) for p in planes)
    for _ in range(max_steps):
        new = step(ro, planes)
        if all(np.array_equal(a, b) for a, b in zip(new, planes)):
            return planes, False
        planes = new
    return planes, True


def tile_pass_np(rule, ro, planes, steps=tilepass.STEPS):
    """One kernel pass as the CUDA kernel computes it. Returns (changed,
    planes)."""
    step, ro_fill, fills = RULES[rule]
    ro = np.asarray(ro)
    planes = [np.asarray(p) for p in planes]
    h, w = ro.shape
    g = tilepass.geometry(h, w, len(planes), steps)
    ph, pw = g.grid[1] * g.tile_h + 2 * steps, g.grid[0] * g.tile_w + 2 * steps

    def pad(x, fill):
        out = np.full((ph, pw), fill, x.dtype)
        out[steps:steps + h, steps:steps + w] = x
        return out

    inside = pad(np.ones((h, w), bool), False)
    pro = pad(ro, ro_fill)
    pin = [pad(p, f) for p, f in zip(planes, fills)]
    pout = [p.copy() for p in pin]
    for by in range(g.grid[1]):
        for bx in range(g.grid[0]):
            ys = slice(by * g.tile_h, by * g.tile_h + g.tile_h + 2 * steps)
            xs = slice(bx * g.tile_w, bx * g.tile_w + g.tile_w + 2 * steps)
            keep = inside[ys, xs]
            tile = [p[ys, xs] for p in pin]
            for _ in range(steps):
                tile = [np.where(keep, t, np.asarray(f, t.dtype))
                        for t, f in zip(step(pro[ys, xs], tile), fills)]
            iy = slice(ys.start + steps, ys.stop - steps)
            ix = slice(xs.start + steps, xs.stop - steps)
            for out, t in zip(pout, tile):
                out[iy, ix] = t[steps:-steps, steps:-steps]
    new = [p[steps:steps + h, steps:steps + w] for p in pout]
    changed = any(not np.array_equal(a, b) for a, b in zip(new, planes))
    return changed, tuple(new)
