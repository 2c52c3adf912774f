"""Turbo path (staged gossip + compact rounds) vs sequential oracle.

Turbo uses canonical min-vertex-id labels, so equivalence is checked on the
canonical partition (representative-independent), unlike the atomic path's
exact root-id equality."""

import numpy as np
import pytest

import jax.numpy as jnp

from gseg.config import SegmentationConfig
from gseg.models.boruvka_cpu import segment_boruvka_np
from gseg.models.turbo import segment_turbo
from gseg.utils.labels import canonical_min_labels_np, num_components
from gseg.utils.synthetic import blobs_image, checkerboard_image, gradient_image


CASES = [
    dict(h=24, w=32, k=100.0, min_size=8, connectivity=8, seed=0),
    dict(h=33, w=17, k=300.0, min_size=20, connectivity=8, seed=1),
    dict(h=16, w=16, k=50.0, min_size=1, connectivity=4, seed=2),
    dict(h=1, w=37, k=100.0, min_size=5, connectivity=8, seed=3),
    dict(h=64, w=64, k=200.0, min_size=30, connectivity=8, seed=4),
]


@pytest.mark.parametrize("case", CASES)
def test_partition_matches_oracle(case):
    cfg = SegmentationConfig(
        k=case["k"], min_size=case["min_size"], connectivity=case["connectivity"]
    )
    img = blobs_image(case["h"], case["w"], 5, 6.0, case["seed"])
    expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    got = np.asarray(segment_turbo(jnp.asarray(img), cfg))
    assert np.array_equal(expected, got)


@pytest.mark.parametrize("gossip_rounds", [1, 2, 6])
def test_gossip_stage2_split_invariant(gossip_rounds):
    """The partition must not depend on where gossip hands off to stage 2."""
    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = blobs_image(24, 32, 5, 6.0, 1)
    expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    got = np.asarray(
        segment_turbo(jnp.asarray(img), cfg, gossip_rounds=gossip_rounds)
    )
    assert np.array_equal(expected, got)


@pytest.mark.parametrize("wb", [8, 16])
def test_bucketed_quality_mode_parity(wb):
    """Quality mode (weight-quantile ramp) must match the bucketed oracle."""
    cfg = SegmentationConfig(k=30.0, min_size=10, weight_buckets=wb)
    img = blobs_image(48, 64, 5, 4.0, 1)
    expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    got = np.asarray(segment_turbo(jnp.asarray(img), cfg))
    assert np.array_equal(expected, got)


def test_bucketed_mode_recovers_kruskal_quality():
    """The headline quality claim: 16-bucket ramp reaches CPU-baseline ASA
    (the reference's GPU variants were 3-8 ASA points below, BASELINE.md)."""
    from gseg.metrics.compare import asa_ue
    from gseg.models.felzenszwalb_cpu import segment_kruskal_np
    from gseg.utils.datasets import synthetic_quality_set
    from gseg.utils.labels import compact_labels_np

    cfg = SegmentationConfig(k=30.0, min_size=10, weight_buckets=16)
    cfg_kr = SegmentationConfig(k=30.0, min_size=10)
    for name, img, gts in synthetic_quality_set(n=2, h=48, w=64, noise=4.0):
        asa_t, _ = asa_ue(
            compact_labels_np(np.asarray(segment_turbo(jnp.asarray(img), cfg))),
            gts[0],
        )
        asa_k, _ = asa_ue(
            compact_labels_np(segment_kruskal_np(img, cfg_kr)), gts[0]
        )
        assert asa_t >= asa_k - 0.01, (name, asa_t, asa_k)


def test_labels_are_canonical_min_ids(small_image, small_cfg):
    labels = np.asarray(segment_turbo(jnp.asarray(small_image), small_cfg))
    assert np.array_equal(labels, canonical_min_labels_np(labels))


def test_special_images():
    grad = gradient_image(20, 20)
    cfg = SegmentationConfig(k=2000.0, min_size=1, sigma=0.4)
    assert num_components(np.asarray(segment_turbo(jnp.asarray(grad), cfg))) == 1
    chk = checkerboard_image(24, 24, cell=6)
    cfg = SegmentationConfig(sigma=0.1, k=5.0, min_size=1)
    labels = np.asarray(segment_turbo(jnp.asarray(chk), cfg))
    for y in range(0, 24, 6):
        for x in range(0, 24, 6):
            assert np.unique(labels[y : y + 6, x : x + 6]).size == 1


def test_deep_minsize_chain_resolves_in_budget():
    """Regression: the min-size phase can form hook chains thousands deep
    (every component hooks to its cheaper left neighbor). Single-step chain
    walking (pre-fix) resolved <=17 levels per round and ran out of the
    stage-2 round budget; successor-map pointer doubling must merge the
    whole chain within the budget and match the oracle."""
    n = 4096
    # strictly increasing edge weights along one row -> every pixel's min
    # edge points left -> one maximal-depth chain in the min-size phase.
    vals = np.cumsum(np.linspace(10.0, 30.0, n)).astype(np.float32)
    img = np.repeat(vals[None, :, None], 3, axis=2).reshape(1, n, 3)
    cfg = SegmentationConfig(k=1e-3, min_size=n, sigma=0.0)
    expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    got = np.asarray(segment_turbo(jnp.asarray(img), cfg))
    assert num_components(got) == 1
    assert np.array_equal(expected, got)


def test_capacity_overflow_detected_not_silent():
    """A low-k noise image keeps C ~ V into stage 2, overflowing the
    measured-heuristic capacities. Pre-fix this silently truncated the edge
    set and corrupted the labels; now it must raise (default) and produce
    the oracle partition under on_overflow='fallback'."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (192, 384, 3)).astype(np.float32)
    cfg = SegmentationConfig(k=1e-3, min_size=1, sigma=0.0)
    with pytest.raises(RuntimeError, match="capacity|budget"):
        segment_turbo(jnp.asarray(img), cfg)

    cfg_fb = SegmentationConfig(
        k=1e-3, min_size=1, sigma=0.0, on_overflow="fallback"
    )
    got = np.asarray(segment_turbo(jnp.asarray(img), cfg_fb))
    # k ~ 0 on continuous noise: every pixel stays its own component.
    assert num_components(got) == img.shape[0] * img.shape[1]


def test_chunked_pair_extract_matches_flat_dedup():
    """Multi-chunk extraction must cover every pair's global-min edge
    (duplicates allowed, losses not)."""
    from gseg.models.turbo import _chunked_pair_extract
    from gseg.ops.primitives import INT32_MAX

    rng = np.random.default_rng(0)
    n = 1024
    lo = rng.integers(0, 40, n).astype(np.int32)
    hi = (lo + rng.integers(1, 40, n)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, n).astype(np.float32)
    eid = np.arange(n, dtype=np.int32)
    dead = rng.uniform(size=n) < 0.5
    lo[dead] = INT32_MAX
    hi[dead] = INT32_MAX
    w[dead] = np.inf

    cap = 1024
    m, olo, ohi, ow, oe, ovf = _chunked_pair_extract(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(w), jnp.asarray(eid),
        cap, chunk=128,
    )
    assert not bool(ovf)
    m, olo, ohi, ow, oe = (np.asarray(x) for x in (m, olo, ohi, ow, oe))

    # reference: per-pair global min (w, eid)
    best = {}
    for i in range(n):
        if dead[i]:
            continue
        key = (lo[i], hi[i])
        if key not in best or (w[i], eid[i]) < best[key]:
            best[key] = (w[i], eid[i])

    got = {}
    for i in range(cap):
        if not m[i]:
            continue
        key = (olo[i], ohi[i])
        cur = (ow[i], oe[i])
        if key not in got or cur < got[key]:
            got[key] = cur
    assert got == best


def test_hierarchy_levels_nest_and_match_oracle():
    """Turbo-native hierarchy: level 0 singletons, monotone nesting, final
    labels equal to segment_turbo / the oracle partition."""
    from gseg.models.turbo import segment_turbo_hierarchy

    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = blobs_image(24, 32, 5, 6.0, 0)
    levels, final = segment_turbo_hierarchy(jnp.asarray(img), cfg)
    levels = np.asarray(levels)
    counts = [np.unique(levels[i]).size for i in range(levels.shape[0])]
    assert counts[0] == img.shape[0] * img.shape[1]
    assert all(a >= b for a, b in zip(counts, counts[1:]))
    # nesting: each level-i component lies inside one level-(i+1) component
    for i in range(levels.shape[0] - 1):
        fine = levels[i].reshape(-1)
        coarse = levels[i + 1].reshape(-1)
        seen = {}
        for f, c in zip(fine.tolist(), coarse.tolist()):
            assert seen.setdefault(f, c) == c
    expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    assert np.array_equal(expected, np.asarray(final))
    assert np.array_equal(
        np.asarray(segment_turbo(jnp.asarray(img), cfg)), np.asarray(final)
    )


def test_hierarchy_per_level_partitions_match_fastmst():
    """The turbo hierarchy's per-round partition sequence equals the
    fastmst hierarchy's (same merge rule per felz round, different
    schedule), compared as canonical partitions level by level."""
    from gseg.models.fastmst import segment_fastmst_hierarchy
    from gseg.models.turbo import segment_turbo_hierarchy

    cfg = SegmentationConfig(k=120.0, min_size=1, max_iters=12)
    img = blobs_image(20, 28, 4, 5.0, 3)
    t_levels, _ = segment_turbo_hierarchy(jnp.asarray(img), cfg)
    f_levels, _ = segment_fastmst_hierarchy(jnp.asarray(img), cfg)
    n = min(t_levels.shape[0], f_levels.shape[0])
    for i in range(n):
        a = canonical_min_labels_np(np.asarray(t_levels[i]))
        b = canonical_min_labels_np(np.asarray(f_levels[i]))
        assert np.array_equal(a, b), f"level {i} partitions differ"


def test_rlist_sizes_exact():
    """_rlist_sizes: exact new-component sizes from an old-root list."""
    from gseg.models.turbo import _build_rlist, _rlist_sizes

    rng = np.random.default_rng(9)
    h, w = 17, 23
    v = h * w
    # old partition: random blocks canonicalized to min flat id
    from tests.test_fixpoints import _canonical as _canonicalize

    L_old = jnp.asarray(_canonicalize(
        rng.integers(0, 5, (h, w)).astype(np.int32)))
    # new partition: coarsen by merging labels mod groups, canonical again
    groups = {int(r): int(r) // 2 for r in np.unique(np.asarray(L_old))}
    Lnew_np = _canonicalize(
        np.vectorize(lambda r: groups[int(r)])(np.asarray(L_old)))
    Lnew = jnp.asarray(Lnew_np)
    # old sizes at old roots
    S_old = np.zeros((h, w), np.int32)
    for r in np.unique(np.asarray(L_old)):
        ry, rx = divmod(int(r), w)
        S_old[ry, rx] = int((np.asarray(L_old) == r).sum())
    rlist, ovf = _build_rlist(L_old, 16384)
    assert not bool(ovf)
    S_new, rlist_new = _rlist_sizes(rlist, Lnew, jnp.asarray(S_old))
    S_new = np.asarray(S_new)
    for r in np.unique(Lnew_np):
        ry, rx = divmod(int(r), w)
        assert S_new[ry, rx] == int((Lnew_np == r).sum())
    # new list holds exactly the new roots
    live = np.asarray(rlist_new)
    live = np.sort(live[live != np.iinfo(np.int32).max])
    assert np.array_equal(live, np.unique(Lnew_np))


def test_s2_small_path_matches_full_pool(monkeypatch):
    """The live-count small path (sliced early-round pool) must produce the
    identical partition as the full-capacity branch: dead slots beyond the
    slice carry no information, so slicing is result-invariant. Guards the
    lax.cond routing in _s2_stage."""
    import jax

    cfg = SegmentationConfig(k=100.0, min_size=8)
    img = blobs_image(40, 48, 6, 6.0, 7)
    outs = {}
    for sm in ("1", "0"):
        monkeypatch.setenv("GSEG_S2_SMALL", sm)
        jax.clear_caches()  # env is read at trace time
        outs[sm] = np.asarray(segment_turbo(jnp.asarray(img), cfg))
    monkeypatch.undo()
    jax.clear_caches()
    expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    assert np.array_equal(outs["1"], outs["0"])
    assert np.array_equal(outs["1"], expected)


def test_rlist_split_loop_matches_single_loop(monkeypatch):
    """The two-phase rlist gossip loop (full cap, then sliced once live
    roots fit) must execute exactly the rounds the single loop would —
    slicing the sorted root list is lossless once every live root fits.
    Shrink the slice floor so tiny images exercise the split, in both
    speed and quality modes."""
    import jax

    from gseg.models import turbo as T

    for cfg in (SegmentationConfig(k=100.0, min_size=8),
                SegmentationConfig(k=30.0, min_size=10, weight_buckets=8)):
        img = blobs_image(48, 56, 6, 6.0, 9)
        expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))
        outs = {}
        for split, floor in (("1", 64), ("0", 16384)):
            monkeypatch.setenv("GSEG_RLIST_SPLIT", split)
            monkeypatch.setattr(T, "_RLIST_FLOOR", floor)
            jax.clear_caches()
            outs[split] = np.asarray(segment_turbo(jnp.asarray(img), cfg))
        monkeypatch.undo()
        jax.clear_caches()
        assert np.array_equal(outs["1"], outs["0"])
        assert np.array_equal(outs["1"], expected)


def test_prune_keeps_minsize_hook_targets():
    """Regression: _prune_dead must keep the reverse edge of every possible
    min-size hook (small[edst] term). With the old src-only rule, a frozen
    non-small component whose neighbors are all frozen lost ALL its live
    outgoing edges, stopped being a head in _s2_round, and a small
    component's min-size hook into it resolved to self and silently
    no-opped — leaving a size-1 component (min_size violation) and a
    partition diverging from the oracle (20-seed parity sweep, seeds 5/19).

    Construction: two flat halves (strong border, both freeze with all
    cross edges frozen-frozen) + one outlier pixel whose every edge exceeds
    its own threshold (size-1, frozen). The outlier MUST min-size hook into
    its surrounding half; pre-fix it could not."""
    img = np.zeros((24, 32, 3), dtype=np.float32)
    img[:, 16:, 0] = 200.0     # right half: strong vertical border
    img[12, 8, 2] = 120.0      # outlier inside the left half
    cfg = SegmentationConfig(k=50.0, min_size=10, sigma=0.01)
    expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    # the construction must actually exercise the path: oracle leaves no
    # undersized component, and the outlier merged into the left half
    sizes = np.bincount(expected.reshape(-1))
    assert (sizes[sizes > 0] >= cfg.min_size).all()
    got = canonical_min_labels_np(np.asarray(segment_turbo(jnp.asarray(img), cfg)))
    gsizes = np.bincount(got.reshape(-1))
    assert (gsizes[gsizes > 0] >= cfg.min_size).all()
    assert np.array_equal(got, expected)


def test_partition_matches_oracle_multistrip(emulated):
    """End-to-end turbo vs the sequential oracle with every dense fixpoint
    run as GPU-style tile passes (kernel emulated on the host) over tiles
    of 4 x 8 cells: 24 x 7 tiles at h=96, so passes interact across tile
    edges in every round, where halo and fill mistakes would show."""
    import jax

    from gseg.bench.fixpoints import fixpoints
    from gseg.models import turbo as turbo_mod
    from gseg.ops import tilepass

    cfg = SegmentationConfig(k=200.0, min_size=20, connectivity=8)
    img = blobs_image(96, 56, 6, 6.0, 11)
    expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    with fixpoints(tilepass):
        got, flags = jax.jit(lambda im: turbo_mod.segment_turbo_impl(
            im, cfg, 2))(jnp.asarray(img))
    assert int(flags) == 0
    assert np.array_equal(expected, np.asarray(got))


def test_flood_pointer_matches_oracle(monkeypatch):
    """GSEG_FLOOD_PTR=1 (pool pointer-resolution instead of the rlist-round
    wavefront flood, r5 measurement knob) must reproduce the oracle
    partition exactly. The knob is read at trace time, so the jit caches
    are cleared around the flip."""
    import jax

    from gseg.models import turbo as turbo_mod

    cfg = SegmentationConfig(k=120.0, min_size=10)
    img = blobs_image(40, 56, 6, 6.0, 13)
    expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))

    monkeypatch.setenv("GSEG_FLOOD_PTR", "1")
    jax.clear_caches()
    try:
        got = np.asarray(segment_turbo(jnp.asarray(img), cfg))
    finally:
        monkeypatch.delenv("GSEG_FLOOD_PTR", raising=False)
        jax.clear_caches()
    assert np.array_equal(expected, got)
