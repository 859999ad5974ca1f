"""Sequence/dataset stitching orchestration.

Rebuild of the reference's L3/L4 layers:
  * ``stitch_sequence``      — flowStitch (reference Stitcher.py:49-94)
  * ``stitch_sequence_multi``— flowStitchWithMutiple (Stitcher.py:96-127)
  * ``stitch_project_set``   — imageSetStitch(WithMutiple) (Stitcher.py:129-182)

Key structural change: registration of ALL pairs happens up front in batched
device dispatches (core/registration.py); segmentation on failure is then a
pure host-side split of the per-pair records — semantically identical to the
reference's restart-the-loop-after-a-break behavior, because each pair's
registration outcome is independent of the segment structure (the feature
cache only short-circuits recomputation, never changes results; see
register_sequence_features for the cache-parity discussion).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import StitchConfig
from ..io import codec, dataset
from ..utils.records import SequenceReport, print_and_write
from . import compose as compose_mod
from . import registration


@dataclasses.dataclass
class StitchResult:
    """One stitched segment + its provenance."""
    image: np.ndarray                      # uint8 panorama (or single image)
    file_range: Tuple[int, int]            # [start, end) indices into the file list
    offsets: List[Tuple[int, int]]         # pairwise offsets inside the segment
    report: Optional[SequenceReport] = None


class Stitcher:
    """The engine facade. Construct once per configuration; stateless across
    calls except for the persisted search direction (reference parity:
    Stitcher.direction is a class attribute surviving across datasets,
    Stitcher.py:361 / Main.py:17-47).

    ``mesh``: optional ``jax.sharding.Mesh`` — ONE driver runs everything
   : with a mesh, registration runs frame-sharded
    (parallel/pooled_sharded.py), decode runs pipelined (io/prefetch.py),
    and composition runs on the sharded canvas (parallel/compose_sharded.py);
    without one, the single-device paths run.  Results are identical.
    """

    def __init__(self, cfg: StitchConfig, checkpoint_dir: Optional[str] = None,
                 mesh=None):
        self.cfg = cfg
        self._direction = cfg.direction
        self.checkpoint_dir = checkpoint_dir
        self.mesh = mesh

    # -- registration ------------------------------------------------------

    def register(self, gray: np.ndarray) -> List[registration.PairRegistration]:
        """Register all adjacent pairs of a grayscale batch."""
        cfg = self.cfg.replace(direction=self._direction)
        if self.cfg.registration == "phase_incre":
            recs = registration.register_sequence_phase(gray, cfg)
        elif self.cfg.registration == "phase":
            recs = registration.register_sequence_phase_whole(gray, cfg,
                                                              mesh=self.mesh)
        elif self.cfg.registration == "feature_incre":
            if self.mesh is not None and self.mesh.devices.size > 1 \
                    and not cfg.features.strict_roi_detect \
                    and not cfg.enhance.enabled:
                from ..parallel import pooled_sharded
                recs = pooled_sharded.register_sequence_features_incre_sharded(
                    gray, cfg, self.mesh)
            else:
                recs = registration.register_sequence_features_incre(gray, cfg)
        elif self.cfg.registration == "feature":
            if self.mesh is not None and self.mesh.devices.size > 1 \
                    and not cfg.enhance.enabled:
                from ..parallel import pooled_sharded
                recs = pooled_sharded.register_sequence_features_sharded(
                    gray, cfg, self.mesh)
            else:
                recs = registration.register_sequence_features(gray, cfg)
        elif self.cfg.registration == "hybrid":
            recs = registration.register_sequence_hybrid(gray, cfg)
        else:
            raise ValueError(self.cfg.registration)
        # persist the last successful direction across sequences
        for r in reversed(recs):
            if r.ok and r.direction:
                self._direction = r.direction
                break
        self._log_records(recs)
        return recs

    def _log_records(self, recs) -> None:
        # per-pair offset log (reference Stitcher.py:303, :366 via
        # printAndWrite, ImageUtility.py:52-64)
        if self.cfg.print_log or self.cfg.evaluate:
            for k, r in enumerate(recs):
                if r.ok:
                    print_and_write(
                        self.cfg,
                        f"  The offset of pair {k} is {list(r.offset)} "
                        f"(direction={r.direction}, scale={r.scale}, "
                        f"confidence={r.confidence:.3g})")
                else:
                    print_and_write(
                        self.cfg, f"  Pair {k} failed to register after "
                                  f"{r.attempts} attempts")

    # -- sequence stitching ------------------------------------------------

    def stitch_batch(self, batch: dataset.ImageBatch,
                     recs: Optional[List[registration.PairRegistration]] = None
                     ) -> List[StitchResult]:
        """flowStitchWithMutiple semantics on a decoded batch.

        Returns one StitchResult per stitchable segment; a trailing lone image
        is returned as-is (reference Stitcher.py:119-125).  ``recs``: optional
        precomputed registration records (the pipelined-ingest path computes
        them during decode overlap).
        """
        t0 = time.time()
        ckpt_path = None
        if self.checkpoint_dir is not None:
            from . import checkpoint as ckpt
            import hashlib
            key = hashlib.sha1("\n".join(batch.files).encode()).hexdigest()[:16]
            ckpt_path = os.path.join(self.checkpoint_dir, f"reg_{key}.json")
            if recs is None:
                recs = ckpt.load_registration(ckpt_path, batch.files)
        if recs is None:
            recs = self.register(batch.gray)
            if ckpt_path is not None:
                from . import checkpoint as ckpt
                ckpt.save_registration(ckpt_path, batch.files, recs)
        t_reg = time.time() - t0
        compose_src = batch.color if self.cfg.color_mode else batch.gray
        n = batch.num_images

        results: List[StitchResult] = []
        t0 = time.time()
        start = 0
        while start < n:
            # extend the segment while pairs register
            end = start
            seg_offsets: List[Tuple[int, int]] = []
            while end < n - 1 and recs[end].ok:
                seg_offsets.append(recs[end].offset)
                end += 1
            seg_images = compose_src[start:end + 1]
            if end == start:
                results.append(StitchResult(image=np.asarray(seg_images[0]),
                                            file_range=(start, start + 1),
                                            offsets=[]))
            elif self.cfg.use_global_solver:
                from ..solver import pose_graph as pg
                subpix = [recs[k].offset_subpix for k in range(start, end)]
                conf = [max(recs[k].confidence, 1e-3)
                        for k in range(start, end)]
                graph = pg.PoseGraph.from_chain(subpix, conf)
                if end - start + 1 >= 3:
                    # grid loop closure: verified non-adjacent overlap edges
                    # pin the serpentine drift the chain accumulates
                    from ..solver import loop_closure
                    gray_seg = np.asarray(batch.gray[start:end + 1])
                    graph, n_loop = loop_closure.close_loops(
                        gray_seg, graph, pg.chain_positions(subpix),
                        gray_seg.shape[1:])
                    if self.cfg.print_log or self.cfg.evaluate:
                        print_and_write(self.cfg,
                                        f"  solver: {n_loop} loop-closure "
                                        f"edges added")
                iters = self.cfg.solver_iters or None
                positions = pg.solve(graph, iters=iters)
                img = self._compose_positions(batch, seg_images, positions,
                                              start, end)
                results.append(StitchResult(image=img,
                                            file_range=(start, end + 1),
                                            offsets=seg_offsets))
            elif self.mesh is not None and self.mesh.devices.size > 1:
                from ..parallel import compose_sharded as cs
                img = cs.compose_sharded(np.asarray(seg_images), seg_offsets,
                                         self.cfg, self.mesh)
                results.append(StitchResult(image=img,
                                            file_range=(start, end + 1),
                                            offsets=seg_offsets))
            else:
                img = self._compose_segment(batch, seg_images, seg_offsets,
                                            start, end)
                results.append(StitchResult(image=img,
                                            file_range=(start, end + 1),
                                            offsets=seg_offsets))
            start = end + 1
        t_fuse = time.time() - t0
        report = SequenceReport.from_records(recs, t_register=t_reg, t_compose=t_fuse)
        for r in results:
            r.report = report
        return results

    def _compose_segment(self, batch: dataset.ImageBatch, seg_images,
                         seg_offsets, start: int, end: int) -> np.ndarray:
        """Single-device segment composition: full readback by default;
        ``cfg.stream_output`` materializes via the delta-readback assembler
        (core/stream_out.py) when the required host frames are available."""
        cfg = self.cfg
        if cfg.stream_output:
            from ..io import native_loader
            from . import stream_out
            host_ok = (native_loader.get_lib() is not None
                       and cfg.fuse_method in compose_mod._PADDABLE_METHODS)
            if cfg.color_mode:
                # color never crosses the link: host f64 canvas + native
                # C fusion kernels (stream_out.compose_color_host)
                if isinstance(batch.color, np.ndarray) and \
                        cfg.fuse_method in compose_mod._PADDABLE_METHODS:
                    return stream_out.compose_color_host(
                        np.asarray(seg_images), seg_offsets, cfg)
            else:
                host = batch.gray_host if batch.gray_host is not None else (
                    batch.gray if isinstance(batch.gray, np.ndarray) else None)
                if host is not None and host_ok:
                    # link-optimal gray mode: zero panorama link bytes,
                    # reference-f64 output (compose_host)
                    return stream_out.compose_host(
                        host[start:end + 1], seg_offsets, cfg)
                if host is not None:
                    # exact-device-parity streamed fallback (also covers
                    # multiband/seam, which the host composer lacks)
                    dev = None if isinstance(seg_images, np.ndarray) \
                        else seg_images
                    return stream_out.compose_streamed(
                        host[start:end + 1], seg_offsets, cfg,
                        frames_dev=dev)
        return compose_mod.compose(seg_images, seg_offsets, cfg)

    def _compose_positions(self, batch: dataset.ImageBatch, seg_images,
                           positions, start: int, end: int) -> np.ndarray:
        """Solver-path composition; honors ``cfg.stream_output`` with the
        host f64 composer (compose_host_positions) when possible."""
        cfg = self.cfg
        if cfg.stream_output and \
                cfg.fuse_method in compose_mod._PADDABLE_METHODS:
            from ..io import native_loader
            from . import stream_out
            if native_loader.get_lib() is not None:
                if cfg.color_mode:
                    if isinstance(batch.color, np.ndarray):
                        return stream_out.compose_host_positions(
                            np.asarray(seg_images), positions, cfg)
                else:
                    host = batch.gray_host if batch.gray_host is not None \
                        else (batch.gray
                              if isinstance(batch.gray, np.ndarray) else None)
                    if host is not None:
                        return stream_out.compose_host_positions(
                            host[start:end + 1], positions, cfg)
        return compose_mod.compose_from_positions(seg_images, positions, cfg)

    def stitch_files(self, files: Sequence[str]) -> List[StitchResult]:
        """Stitch a file sequence with pipelined ingest (SURVEY §2.3 PP row):
        libjpeg decode of chunk k+1 overlaps device work on chunk k.

        On the single-device flagship path (pooled feature_incre) the decode
        additionally overlaps pooled feature extraction itself
        (io/prefetch.register_sequence_pipelined); a mesh keeps frames
        host-side so sharded registration places them with its own sharding.
        """
        from ..io import prefetch
        cfg = self.cfg
        fused_ingest = (
            cfg.registration == "feature_incre"
            and (self.mesh is None or self.mesh.devices.size == 1)
            and self.checkpoint_dir is None
            and not cfg.features.strict_roi_detect
            and not cfg.enhance.enabled
            and not cfg.color_mode)
        if fused_ingest:
            recs, gray_dev, gray_host = prefetch.register_sequence_pipelined(
                files, cfg.replace(direction=self._direction),
                keep_host=cfg.stream_output)
            for r in reversed(recs):
                if r.ok and r.direction:
                    self._direction = r.direction
                    break
            self._log_records(recs)
            batch = dataset.ImageBatch(gray=gray_dev, color=None,
                                       files=list(files),
                                       gray_host=gray_host)
            return self.stitch_batch(batch, recs=recs)
        batch = prefetch.load_batch_pipelined(
            files, cfg.color_mode,
            to_device=self.mesh is None or self.mesh.devices.size == 1)
        return self.stitch_batch(batch)

    # -- dataset orchestration (L4) ----------------------------------------

    def stitch_project_set(self, project_address: str, output_address: str,
                           file_num: int, start_num: int = 1,
                           file_extension: str = "jpg",
                           output_extension: str = "jpg") -> List[str]:
        """imageSetStitchWithMutiple semantics (Stitcher.py:153-182) with
        portable paths.  Returns the written output files."""
        written: List[str] = []
        for i in range(start_num, file_num + 1):
            t0 = time.time()
            files = dataset.list_project_images(project_address, i, file_extension)
            if not files:
                print(f"warning: no *.{file_extension} files under "
                      f"{os.path.join(project_address, str(i))}; skipping")
                continue
            results = self.stitch_files(files)
            os.makedirs(output_address, exist_ok=True)
            if len(results) == 1:
                out = os.path.join(output_address,
                                   f"stitching_result_{i}.{output_extension}")
                codec.imwrite(out, results[0].image)
                written.append(out)
            else:
                for j, res in enumerate(results):
                    out = os.path.join(
                        output_address,
                        f"stitching_result_{i}_{j + 1}.{output_extension}")
                    codec.imwrite(out, res.image)
                    written.append(out)
            print_and_write(self.cfg,
                            f"Time consuming for {project_address}/{i}: "
                            f"{time.time() - t0:.3f}s")
        return written
