"""Composition throughput: single-device vs sharded canvas.

Publishes the sharded-compose frames/s number.
On the virtual CPU mesh the absolute numbers validate the code path and its
dispatch structure (virtual devices share one host, so wall-clock is not a
hardware-efficiency claim; the report marks the backend) — on several
accelerators the same harness measures the real speed-up.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional

import jax
import numpy as np

from ..config import StitchConfig
from ..core.compose import compose
from ..parallel.compose_sharded import compose_sharded
from ..parallel.mesh import make_mesh


@dataclasses.dataclass
class ComposeBench:
    backend: str
    n_frames: int
    image_shape: List[int]
    canvas_shape: List[int]
    fuse_method: str
    single_fps: float
    sharded_fps: float
    n_devices: int
    sharded_dispatches: int = 0     # jitted scan groups per panorama
    sharded_fuse_psums: int = 0     # collectives: ONE psum per fused image
    host_cores: int = 0
    note: str = ""
    # int16 psum payload bytes per panorama and the ring all-reduce
    # traffic through each device (parallel/compose_sharded.py)
    psum_payload_bytes: int = 0
    modeled_bytes_per_device: int = 0


def _serpentine(rng, n_rows=4, n_cols=6, h=256, w=320):
    """Dendritic-shaped synthetic: serpentine grid with ~93% row overlap."""
    rstep, cstep = int(h * 0.7), int(w * 0.93)
    base = rng.integers(0, 255, (rstep * n_rows + h, cstep * n_cols + w),
                        np.uint8)
    pos = []
    for r in range(n_rows):
        cs = range(n_cols) if r % 2 == 0 else range(n_cols - 1, -1, -1)
        pos += [(r * rstep, c * cstep) for c in cs]
    tiles = np.stack([base[r:r + h, c:c + w] for r, c in pos])
    offsets = [(pos[i + 1][0] - pos[i][0], pos[i + 1][1] - pos[i][1])
               for i in range(len(pos) - 1)]
    return tiles, offsets


def run(images: Optional[np.ndarray] = None, offsets=None,
        n_devices: int = 8, fuse_method: str = "fadeInAndFadeOut",
        repeats: int = 3) -> ComposeBench:
    if images is None:
        rng = np.random.default_rng(0)
        images, offsets = _serpentine(rng)
    n = images.shape[0]
    cfg = StitchConfig(color_mode=False, fuse_method=fuse_method,
                       registration="phase_incre")
    mesh = make_mesh(n_devices, axis="blocks")

    def t_single():
        out = compose(images, offsets, cfg, return_device=True)
        jax.block_until_ready(out)

    def t_sharded():
        out, rows = compose_sharded(images, offsets, cfg, mesh,
                                    return_device=True)
        jax.block_until_ready(out)

    t_single(); t_sharded()   # compile
    bs = min(_time(t_single) for _ in range(repeats))
    bh = min(_time(t_sharded) for _ in range(repeats))
    from ..core.compose import compute_placement
    from ..parallel.compose_sharded import LAST_COMPOSE_STATS
    rows, cols = compute_placement(offsets, images.shape[1:3]).canvas_shape
    import os as _os
    cores = _os.cpu_count() or 0
    note = ""
    if jax.default_backend() == "cpu":
        note = (f"virtual CPU mesh on a {cores}-core host (device programs "
                f"share the cores: ~{n_devices}/{cores}x oversubscription in "
                f"the sharded wall-clock); the dispatch/psum counts are the "
                f"hardware-independent overhead evidence")
    return ComposeBench(
        backend=jax.default_backend(), n_frames=n,
        image_shape=list(images.shape[1:]), canvas_shape=[rows, cols],
        fuse_method=fuse_method,
        single_fps=round(n / bs, 2), sharded_fps=round(n / bh, 2),
        n_devices=n_devices,
        sharded_dispatches=int(LAST_COMPOSE_STATS.get("dispatches", 0)),
        sharded_fuse_psums=int(LAST_COMPOSE_STATS.get("fuse_psums", 0)),
        host_cores=cores, note=note,
        psum_payload_bytes=int(LAST_COMPOSE_STATS.get("psum_payload_bytes",
                                                      0)),
        modeled_bytes_per_device=int(
            LAST_COMPOSE_STATS.get("modeled_bytes_per_device", 0)))


def _time(f) -> float:
    t0 = time.perf_counter()
    f()
    return time.perf_counter() - t0


def main():
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--cpu-mesh", action="store_true",
                   help="force the virtual CPU mesh (needs "
                        "XLA_FLAGS=--xla_force_host_platform_device_count=N)")
    p.add_argument("--out")
    args = p.parse_args()
    if args.cpu_mesh:
        jax.config.update("jax_platforms", "cpu")
    rep = run()
    txt = json.dumps(dataclasses.asdict(rep))
    if args.out:
        with open(args.out, "w") as f:
            f.write(txt)
    print(txt)


if __name__ == "__main__":
    main()
