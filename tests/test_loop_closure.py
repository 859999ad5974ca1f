"""Loop-closure edges kill serpentine drift.

Synthetic serpentine grid cut from one textured field: the chain
measurements carry injected noise (the reference's prefix-sum would
accumulate it, Stitcher.py:404-405); verified cross-row overlap edges +
the solver recover the true positions.
"""
import numpy as np

from imagestitch_tpu.solver import loop_closure, pose_graph as pg


def _grid(rng, rows=3, cols=4, th=200, tw=250, rstep=150, cstep=180):
    base = np.zeros((rstep * rows + th, cstep * cols + tw), np.float32)
    ys = rng.integers(3, base.shape[0] - 3, 9000)
    xs = rng.integers(3, base.shape[1] - 3, 9000)
    for y, x, a in zip(ys, xs, rng.uniform(60, 200, 9000)):
        base[y - 2:y + 3, x - 2:x + 3] += a
    base = np.clip(base, 0, 255).astype(np.uint8)
    # serpentine order: row 0 left->right, row 1 right->left, ...
    true_pos = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        for c in cs:
            true_pos.append((r * rstep, c * cstep))
    true_pos = np.asarray(true_pos, np.float64)
    tiles = np.stack([base[r:r + th, c:c + tw]
                      for r, c in true_pos.astype(int)])
    return tiles, true_pos


def test_loop_closure_beats_chain():
    rng = np.random.default_rng(21)
    tiles, true_pos = _grid(rng)
    n = len(tiles)
    chain = np.diff(true_pos, axis=0)
    noise = rng.integers(-3, 4, chain.shape).astype(np.float64)
    noisy = chain + noise
    graph = pg.PoseGraph.from_chain([tuple(o) for o in noisy])
    chain_pos = pg.chain_positions(noisy)

    graph2, n_added = loop_closure.close_loops(
        tiles, graph, chain_pos, tiles.shape[1:])
    assert n_added >= 6   # cross-row overlaps on a 3x4 serpentine grid

    solved = pg.solve(graph2, iters=400)
    err_chain = np.abs(chain_pos - true_pos).max()
    err_solved = np.abs(solved - true_pos).max()
    assert err_chain > 2.0          # the injected drift is real
    assert err_solved < err_chain / 2
    assert err_solved <= 2.0


def test_verify_edges_measures_true_offsets():
    rng = np.random.default_rng(22)
    tiles, true_pos = _grid(rng, rows=2, cols=3)
    # perturbed prior positions (what a drifted chain would provide)
    prior = true_pos + rng.integers(-5, 6, true_pos.shape)
    cands = loop_closure.propose_edges(prior, tiles.shape[1:])
    assert cands
    ia, ib, meas, wgt = loop_closure.verify_edges(tiles, prior, cands)
    assert len(ia) > 0
    for a, b, m in zip(ia, ib, meas):
        true_d = true_pos[b] - true_pos[a]
        assert np.abs(m - true_d).max() <= 1.0, (a, b, m, true_d)


def test_propose_edges_skips_non_overlapping():
    pos = np.asarray([[0, 0], [0, 300], [0, 600], [0, 900]], np.float64)
    cands = loop_closure.propose_edges(pos, (200, 250))
    assert cands == []   # linear strip: only adjacent tiles overlap


def test_real_dendritic_subset_solver_beats_chain():
    """e2e solver evidence on REAL dendritic frames — a
    14-frame subset spanning the first serpentine row transition (2x
    block-mean downsampled for CPU test speed; the committed artifact
    baselines/drift_dendritic.json runs full resolution).  The solved
    positions must explain the measured loop-closure overlaps better than
    the reference-style prefix-sum chain."""
    from conftest import has_demo_images
    import pytest
    if not has_demo_images():
        pytest.skip("reference demoImages not present")
    from imagestitch_tpu.eval import loop_closure_demo
    rep = loop_closure_demo.run(subset=(8, 22), downsample=2)
    assert rep.n_loop_edges >= 3
    assert rep.solved_mean_residual_px < rep.chain_mean_residual_px
    assert rep.solved_max_residual_px <= rep.chain_max_residual_px
