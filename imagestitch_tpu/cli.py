"""Command-line driver.

Replaces the reference's hardcoded ``Main.py`` (reference: Main.py:4-51,
which mutates class attributes and hardcodes Windows paths) with a real CLI
over the frozen StitchConfig.

Examples (reproducing the reference's six demo runs, Main.py:17-51):

  python -m imagestitch_tpu.cli stitch demoImages/iron out/iron \\
      --registration feature_incre --direction 1 --direct-incre 0
  python -m imagestitch_tpu.cli stitch demoImages/dendriticCrystal out/dc \\
      --registration feature_incre --direction 1 --direct-incre 1
  python -m imagestitch_tpu.cli stitch demoImages/zirconBSE out/bse \\
      --registration feature --direction 4 --direct-incre 0
"""
from __future__ import annotations

import argparse
import json
import sys

from .config import EnhanceConfig, FeatureConfig, StitchConfig
from .core.stitcher import Stitcher


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="imagestitch_tpu")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("stitch", help="stitch project sub-directories")
    s.add_argument("project", help="project directory (contains 1/, 2/, ...)")
    s.add_argument("output", help="output directory")
    s.add_argument("--file-num", type=int, default=1,
                   help="number of numbered sub-projects")
    s.add_argument("--start-num", type=int, default=1)
    s.add_argument("--file-extension", default="jpg")
    s.add_argument("--output-extension", default="jpg")
    s.add_argument("--registration", default="feature_incre",
                   choices=["feature_incre", "feature", "phase_incre", "phase", "hybrid"])
    s.add_argument("--feature-method", default="surf",
                   choices=["surf", "sift", "orb"])
    s.add_argument("--offset-calculate", default="mode",
                   choices=["mode", "ransac", "ransac_translation"])
    s.add_argument("--offset-evaluate", type=int, default=3)
    s.add_argument("--roi-ratio", type=float, default=0.2)
    s.add_argument("--search-ratio", type=float, default=0.75)
    s.add_argument("--direction", type=int, default=1, choices=[1, 2, 3, 4])
    s.add_argument("--direct-incre", type=int, default=1, choices=[-1, 0, 1])
    s.add_argument("--fuse-method", default="fadeInAndFadeOut",
                   choices=["notFuse", "average", "maximum", "minimum",
                            "fadeInAndFadeOut", "trigonometric",
                            "multiBandBlending", "optimalSeamLine"])
    s.add_argument("--gray", action="store_true",
                   help="compose grayscale (default: color)")
    s.add_argument("--enhance", action="store_true")
    s.add_argument("--clahe", action="store_true")
    s.add_argument("--clip-limit", type=float, default=20.0)
    s.add_argument("--tile-size", type=int, default=5)
    s.add_argument("--max-keypoints", type=int, default=1024)
    s.add_argument("--hessian-threshold", type=float, default=10.0)
    s.add_argument("--box-filter", action="store_true",
                   help="use the reference's integral-image SURF box-filter "
                        "response instead of Gaussian-derivative DoH")
    s.add_argument("--upright", action="store_true",
                   help="skip descriptor orientation (surfIsUpright)")
    s.add_argument("--phase-response-threshold", type=float, default=0.15)
    s.add_argument("--evaluate", action="store_true",
                   help="append per-pair log lines to the evaluate file "
                        "(reference printAndWrite sink)")
    s.add_argument("--evaluate-file", default="evaluate.txt")
    s.add_argument("--stream-output", action="store_true",
                   help="delta-only panorama readback: device composes, "
                        "host assembles from decoded frames + a fused-rect "
                        "stream; color composes host-side (no color upload)."
                        "  Wins on thin host<->device links")
    s.add_argument("--use-solver", action="store_true",
                   help="refine the offset chain with the global pose-graph "
                        "solver before composition (new capability)")
    s.add_argument("--report", help="write per-pair JSON report here")
    s.add_argument("--quiet", action="store_true")
    s.add_argument("--mesh", default=None,
                   help="device count for the distributed driver ('auto' = "
                        "all visible devices): frame-sharded registration, "
                        "pipelined ingest, sharded-canvas composition")
    s.add_argument("--platform", default=None,
                   choices=["cpu", "gpu"],
                   help="pin the jax backend; must precede the first jax "
                        "computation in this process")
    return p


def config_from_args(args) -> StitchConfig:
    return StitchConfig(
        registration=args.registration,
        offset_calculate=args.offset_calculate,
        offset_evaluate=args.offset_evaluate,
        roi_ratio=args.roi_ratio,
        phase_response_threshold=args.phase_response_threshold,
        direction=args.direction,
        direct_incre=args.direct_incre,
        color_mode=not args.gray,
        fuse_method=args.fuse_method,
        use_global_solver=args.use_solver,
        stream_output=args.stream_output,
        features=FeatureConfig(method=args.feature_method,
                               max_keypoints=args.max_keypoints,
                               search_ratio=args.search_ratio,
                               hessian_threshold=args.hessian_threshold,
                               box_filter=args.box_filter,
                               upright=args.upright),
        enhance=EnhanceConfig(enabled=args.enhance, use_clahe=args.clahe,
                              clip_limit=args.clip_limit,
                              tile_size=args.tile_size),
        print_log=not args.quiet,
        evaluate=args.evaluate,
        evaluate_file=args.evaluate_file,
        output_address=args.output,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if getattr(args, "platform", None):
        import jax

        # jax caches backends on first use and jax_platforms has no update
        # hook, so this flag is a silent no-op once any computation has run
        # in this process — fail loudly instead of mis-promising a backend.
        # The registry is keyed by plugin name ("cuda"), while a backend's
        # ``platform`` is the generic name ("gpu"): accept either.  It is
        # private API; if it moves across jax releases, fall back to
        # setting the flag rather than crashing a valid invocation.
        try:
            from jax._src import xla_bridge
            backends = dict(xla_bridge._backends)
        except (ImportError, AttributeError):
            backends = {}
        if backends:
            live = set(backends) | {b.platform for b in backends.values()}
            if args.platform not in live:
                raise SystemExit(
                    f"--platform {args.platform}: a jax backend is already "
                    f"initialized in this process ({sorted(live)}); the "
                    "platform can only be pinned before the first jax "
                    "computation — run the CLI in a fresh process.")
        else:
            jax.config.update("jax_platforms", args.platform)
    from .utils.cache import enable_compilation_cache
    enable_compilation_cache()
    if args.command == "stitch":
        cfg = config_from_args(args)
        mesh = None
        if args.mesh:
            import jax

            from .parallel.mesh import make_mesh
            n = jax.device_count() if args.mesh == "auto" else int(args.mesh)
            mesh = make_mesh(n, axis="frames")
        st = Stitcher(cfg, mesh=mesh)
        written = st.stitch_project_set(
            args.project, args.output, args.file_num,
            start_num=args.start_num, file_extension=args.file_extension,
            output_extension=args.output_extension)
        if not args.quiet:
            for w in written:
                print(f"wrote {w}")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
