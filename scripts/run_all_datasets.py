"""The reference driver's full workload (Main.py:4-51), end to end.

Runs all six demo datasets through the Stitcher with the reference's
per-dataset configuration — registration strategy, direction, direction
increment, color mode — writing panoramas to disk exactly as
imageSetStitchWithMutiple does, and records wall times + output shapes to
baselines/demo_driver.json.  The "switch from the reference" receipt:
same inputs, same knobs, same outputs, one command.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEMO = "/root/reference/demoImages"
OUT_JSON = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "baselines", "demo_driver.json")

# Main.py:17-51 per-dataset knobs (registration method, direction,
# directIncre); isColorMode=True globally (Main.py:6); fuseMethod
# fadeInAndFadeOut (Main.py:14)
DATASETS = [
    ("iron",             "phase_incre",   1, 0),   # Main.py:17-21
    ("dendriticCrystal", "feature_incre", 1, 1),   # Main.py:23-27
    ("zirconBSE",        "feature",       4, 0),   # Main.py:29-33
    ("zirconCL",         "feature",       4, 0),   # Main.py:35-39
    ("zirconREM",        "feature",       4, 0),   # Main.py:41-45
    ("zirconTEM",        "feature",       4, 0),   # Main.py:47-51
]


def main():
    from imagestitch_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    t0 = time.time()
    np.asarray(jax.jit(lambda: jnp.zeros((8, 128)).sum())())
    backend_s = time.time() - t0

    from imagestitch_tpu import StitchConfig, Stitcher

    out_root = "/tmp/demo_driver_out"
    rows = []
    t_all = time.time()
    for name, regmethod, direction, incre in DATASETS:
        cfg = StitchConfig(registration=regmethod, direction=direction,
                           direct_incre=incre, roi_ratio=0.2,
                           color_mode=True, fuse_method="fadeInAndFadeOut",
                           stream_output=True)
        st = Stitcher(cfg)
        t0 = time.time()
        written = st.stitch_project_set(os.path.join(DEMO, name),
                                        os.path.join(out_root, name), 1)
        dt = time.time() - t0
        import cv2
        shapes = []
        for f in written:
            im = cv2.imread(f)
            shapes.append(list(im.shape) if im is not None else None)
        rows.append({"dataset": name, "registration": regmethod,
                     "direction": direction, "direct_incre": incre,
                     "wall_s": round(dt, 2), "outputs": written,
                     "output_shapes": shapes})
        print(name, round(dt, 2), "s ->", shapes, flush=True)

    payload = {
        "what": "reference Main.py workload, all six demo datasets, color, "
                "device registration + stream-output host composition",
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "backend_init_s": round(backend_s, 1),
        "total_wall_s": round(time.time() - t_all, 2),
        "datasets": rows,
    }
    with open(OUT_JSON, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps(payload)[:400])


if __name__ == "__main__":
    main()
