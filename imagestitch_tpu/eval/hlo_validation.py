"""Collective-bytes model validation against COMPILED HLO.

The sharded subsystems are designed around an analytic model of the bytes
each collective moves.  This module checks that model against what XLA
actually compiles: for the three sharded subsystems (feature registration
step, canvas compose fuse scan, pose-graph CG solve), it compiles the
ACTUAL program at several mesh widths, parses every collective
instruction's payload shape out of the HLO
(utils/hlo.collective_bytes_from_text), and compares the model's assumed
payload bytes with the compiled ones.

Notes on accounting:
  * HLO instruction payloads are per-EXECUTION; ops inside lax.scan /
    while_loop bodies compile once but execute per step — the comparison is
    therefore per-collective-payload (the model's input), with the trip
    counts stated alongside, not a wall-clock byte total.
  * The virtual CPU mesh compiles the same SPMD partitioning as an
    accelerator mesh; only codegen differs, so payload shapes are
    hardware-independent evidence.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import jax
import numpy as np

from ..parallel.mesh import make_mesh
from ..utils import hlo


@dataclasses.dataclass
class Row:
    subsystem: str
    n_devices: int
    collectives: Dict[str, Dict[str, int]]   # compiled: op -> count/bytes
    modeled_payload_bytes: int               # the model's assumed payload
    compiled_payload_bytes: int              # sum of compiled payloads
    ratio: float                             # compiled / modeled
    note: str = ""


def _feature_row(d: int) -> Row:
    """Sharded feature step (explicit-halo shard_map): model = ONE
    boundary ppermute of a single frame's selected B-side strip features
    (rows f32, cols f32, valid pred, descs f32[k_sel, D]); outputs stay
    sharded, so no other collective should compile."""
    import jax.numpy as jnp
    from ..config import FeatureConfig, StitchConfig
    from ..parallel import pipeline

    rng = np.random.default_rng(0)
    n = 2 * d
    images = rng.integers(0, 255, (n, 256, 384), np.uint8)
    cfg = StitchConfig(features=FeatureConfig(pool_keypoints=512,
                                              max_keypoints=256))
    mesh = make_mesh(d, axis="pairs")
    n_t, args = pipeline._feature_call_args(images, mesh, cfg, 1, 0.5)
    (imgs, max_kp, k_sel, dparams, sparams, metric, sr_, md_,
     ba, bb, vm) = args
    fn = pipeline._feature_pairs_sharded_fn(mesh, max_kp, k_sel, dparams,
                                            sparams, metric, ba, bb, vm)
    colls = hlo.collective_bytes(fn, imgs, jnp.float32(sr_),
                                 jnp.float32(md_))
    from ..ops.features import describe
    desc_dim = describe.descriptor_dim(sparams)
    modeled = k_sel * (4 + 4 + 1 + desc_dim * 4)
    compiled = sum(rec["result_bytes"] for op, rec in colls.items())
    return Row("feature_step", d, colls, int(modeled), int(compiled),
               round(compiled / max(modeled, 1), 3),
               note=f"n_frames={imgs.shape[0]}, k_sel={k_sel}, "
                    f"desc_dim={desc_dim}; expected: collective-permute "
                    "of one frame's (rows, cols, valid, descs)")


def _compose_row(d: int) -> Row:
    """Sharded compose fuse scan: model = one int16 (bh, bw) window psum
    per fuse step (parallel/compose_sharded.py LAST_COMPOSE_STATS)."""
    from ..config import StitchConfig
    from ..parallel import compose_sharded as cs

    rng = np.random.default_rng(1)
    h, w = 96, 128
    offsets = [(70, 3), (64, -2), (71, 1)]
    base = rng.integers(1, 255, (h + 300, w + 16), np.uint8)
    from ..core.compose import compute_placement
    placement = compute_placement(offsets, (h, w))
    tiles = np.stack([base[r:r + h, c:c + w] for r, c in placement.positions])
    cfg = StitchConfig(color_mode=False, fuse_method="fadeInAndFadeOut",
                       registration="phase_incre")
    mesh = make_mesh(d, axis="blocks")
    cs.compose_sharded(tiles, offsets, cfg, mesh, return_device=True)
    stats = dict(cs.LAST_COMPOSE_STATS)
    n_steps = int(stats["fuse_psums"])
    per_step_model = stats["psum_payload_bytes"] // max(n_steps, 1)

    # compile the fuse-scan program itself and read its per-step psum
    rows, cols = placement.canvas_shape
    block_rows = -(-rows // d)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    bh = bw = None
    # recover the shared bucket the planner chose
    from ..core.compose import plan_groups, plan_compose
    _, steps, pairwise = plan_compose(offsets, (h, w), cfg)
    for kind, rect_shape, idxs, pos, aux, geoms in plan_groups(
            steps, cfg.fuse_method, block_rows * d, cols):
        if kind == "fusep":
            bh, bw = rect_shape
            k = len(idxs)
            fn = cs._fusep_scan_sharded(mesh, mesh.axis_names[0], bh, bw,
                                        cfg.fuse_method, False)
            canvas = jax.device_put(
                jnp.full((block_rows * d, cols), -1, jnp.int16),
                NamedSharding(mesh, P(mesh.axis_names[0])))
            args = (canvas, jnp.asarray(tiles[np.asarray(idxs)]),
                    jnp.asarray(pos, jnp.int32),
                    jnp.asarray(aux, jnp.int32),
                    jnp.asarray(geoms, jnp.int32),
                    jnp.asarray([pairwise[i] for i in idxs], jnp.int32))
            colls = hlo.collective_bytes(fn, *args)
            compiled = sum(rec["result_bytes"] for op, rec in colls.items())
            return Row(
                "compose_fuse_scan", d, colls, int(per_step_model),
                int(compiled),
                round(compiled / max(per_step_model, 1), 3),
                note=f"scan body compiles once, executes {k} steps; model "
                     f"payload is per step (bucket {bh}x{bw} int16)")
    raise AssertionError("no fuse group planned")


def _solver_row(d: int) -> Row:
    """Edge-sharded CG: model = one (N, 2) f32 psum for the rhs + one per
    CG iteration (solver/pose_graph.py)."""
    from ..solver import pose_graph as pg

    rng = np.random.default_rng(2)
    n = 64
    offsets = [(float(rng.normal(100, 1)), float(rng.normal(0, 1)))
               for _ in range(n - 1)]
    graph = pg.PoseGraph.from_chain(offsets)
    mesh = make_mesh(d, axis="edges")
    iters = 16
    from ..parallel.mesh import pad_to_multiple
    e_pad = pad_to_multiple(max(len(graph.edges_a), d), d)
    pad = e_pad - len(graph.edges_a)
    ea = np.pad(graph.edges_a, (0, pad))
    eb = np.pad(graph.edges_b, (0, pad))
    m = np.pad(graph.measurements, ((0, pad), (0, 0)))
    w = np.pad(graph.weights, (0, pad))
    fn = pg.sharded_solve_fn(mesh, n, iters)
    colls = hlo.collective_bytes(fn, ea, eb, m, w)
    modeled = n * 2 * 4            # one (N,2) f32 psum payload
    # expect exactly 2 all-reduce instructions (rhs + loop-body matvec),
    # each of the modeled payload
    compiled = sum(rec["result_bytes"] for op, rec in colls.items())
    n_ar = colls.get("all-reduce", {}).get("count", 0)
    return Row("solver_cg", d, colls, int(modeled * max(n_ar, 1)),
               int(compiled),
               round(compiled / max(modeled * max(n_ar, 1), 1), 3),
               note=f"{n_ar} all-reduce instrs (rhs + CG loop body); loop "
                    f"executes <= {iters} iterations of the body payload")


def run(device_counts=(2, 4, 8)) -> List[Row]:
    rows: List[Row] = []
    for d in device_counts:
        if d > jax.device_count():
            continue
        rows.append(_feature_row(d))
        rows.append(_compose_row(d))
        rows.append(_solver_row(d))
    return rows


def main(out_path: Optional[str] = None):
    rows = run()
    payload = {
        "what": "modeled collective payloads vs compiled-HLO collective "
                "payloads",
        "backend": jax.default_backend(),
        "rows": [dataclasses.asdict(r) for r in rows],
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=1)
    print(json.dumps(payload, indent=1))
    return payload


if __name__ == "__main__":
    main()
