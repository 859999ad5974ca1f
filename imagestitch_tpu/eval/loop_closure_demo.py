"""Dendritic-grid drift eval: chain vs solver + loop closure.

BASELINE follow-up: on the serpentine dendritic demo,
registration chains 88 offsets; row-to-row drift accumulates (the
reference's prefix-sum weakness, Stitcher.py:404-405).  Loop-closure edges
measure the true offsets between vertically-overlapping tiles of adjacent
rows; the residual of those measurements under a set of positions IS the
drift metric:

    residual(e=(i,j)) = || (pos[j] - pos[i]) - measurement_e ||_inf

Chain positions ignore the loop measurements entirely, so their residuals
show the accumulated drift; solved positions (weighted least squares over
chain + loop edges) should shrink them to registration noise.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np

from ..config import FeatureConfig, StitchConfig
from ..core import feature_registration as freg
from ..io import dataset
from ..solver import loop_closure, pose_graph as pg


@dataclasses.dataclass
class DriftReport:
    name: str
    n_tiles: int
    n_loop_edges: int
    chain_mean_residual_px: float
    chain_max_residual_px: float
    solved_mean_residual_px: float
    solved_max_residual_px: float


def _residuals(pos: np.ndarray, ia, ib, meas) -> np.ndarray:
    d = pos[ib] - pos[ia]
    return np.abs(d - meas).max(axis=1)


def run(demo_root: str = "/root/reference/demoImages",
        name: str = "dendriticCrystal", subset=None,
        downsample: int = 1) -> DriftReport:
    """``subset``: optional (start, end) frame range; ``downsample``: integer
    block-mean factor (CPU-test speed; the committed artifact runs
    full-resolution, downsample=1)."""
    files = dataset.list_project_images(os.path.join(demo_root, name), 1)
    if subset is not None:
        files = files[subset[0]:subset[1]]
    batch = dataset.load_batch(files, color_mode=False)
    gray_all = batch.gray
    if downsample > 1:
        n0, h0, w0 = gray_all.shape
        h2 = (h0 // downsample) * downsample
        w2 = (w0 // downsample) * downsample
        gray_all = gray_all[:, :h2, :w2].reshape(
            n0, h2 // downsample, downsample, w2 // downsample, downsample
        ).mean(axis=(2, 4)).astype(np.uint8)
        batch = dataset.ImageBatch(gray=gray_all, color=None,
                                   files=batch.files)
    cfg = StitchConfig(registration="feature_incre", direction=1,
                       direct_incre=1, roi_ratio=0.2,
                       features=FeatureConfig(method="surf"))
    recs = freg.register_sequence_features_incre(batch.gray, cfg)
    # largest stitchable segment (the missing-frame pair breaks the chain)
    segs, start = [], 0
    for k, r in enumerate(recs):
        if not r.ok:
            segs.append((start, k + 1))
            start = k + 1
    segs.append((start, len(files)))
    s, e = max(segs, key=lambda t: t[1] - t[0])
    gray = np.asarray(batch.gray[s:e])
    subpix = [recs[k].offset_subpix for k in range(s, e - 1)]
    conf = [max(recs[k].confidence, 1e-3) for k in range(s, e - 1)]

    chain_pos = pg.chain_positions(subpix)
    cands = loop_closure.propose_edges(chain_pos, gray.shape[1:])
    ia, ib, meas, wgt = loop_closure.verify_edges(gray, chain_pos, cands)

    graph = pg.PoseGraph.from_chain(subpix, conf)
    chain_med = float(np.median(graph.weights))
    wn = wgt / max(float(np.median(wgt)), 1e-6) * chain_med
    graph2 = graph.with_extra_edges(ia, ib, meas, wn)
    solved = pg.solve(graph2, iters=4 * graph2.n_nodes)

    rc = _residuals(chain_pos, ia, ib, meas)
    rs = _residuals(solved, ia, ib, meas)
    return DriftReport(
        name=name, n_tiles=gray.shape[0], n_loop_edges=int(len(ia)),
        chain_mean_residual_px=float(rc.mean()),
        chain_max_residual_px=float(rc.max()),
        solved_mean_residual_px=float(rs.mean()),
        solved_max_residual_px=float(rs.max()))


def main():
    import argparse
    from ..utils.cache import enable_compilation_cache
    enable_compilation_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--demo-root", default="/root/reference/demoImages")
    p.add_argument("--name", default="dendriticCrystal")
    p.add_argument("--out")
    args = p.parse_args()
    rep = run(args.demo_root, args.name)
    txt = json.dumps(dataclasses.asdict(rep), indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    print(txt)


if __name__ == "__main__":
    main()
