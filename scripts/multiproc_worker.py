"""Multi-host runtime worker: one PROCESS of an N-process CPU bring-up.

Executes the full multi-host path of ``parallel/distributed.py`` for real —
``jax.distributed.initialize`` across processes, host-sharded "decode",
``make_global_batch`` (make_array_from_process_local_data), one jitted
sharded registration step over the global mesh, a cross-process reduction,
and the DCN record gather — then writes its records to a JSON file the
spawning test compares across hosts and against the single-process run.

Usage: python multiproc_worker.py <coordinator_port> <num_processes> \
           <process_id> <out_dir>

Replaces (at process level) the reference's serial pair loop
(reference: Stitcher.py:64-79); SURVEY §2.3 communication-backend row.
"""
import json
import os
import sys


def make_frames(lo: int, hi: int, n: int, h: int = 96, w: int = 128,
                step: int = 40, seed: int = 11):
    """Frames [lo, hi) of a deterministic textured strip sequence (true
    inter-frame offset = (step, 0)).  Each host generates ONLY its shard —
    the stand-in for per-host image decode."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = np.zeros((step * n + h, w), np.float32)
    ys = rng.integers(3, base.shape[0] - 3, 2500)
    xs = rng.integers(3, w - 3, 2500)
    for y, x, a in zip(ys, xs, rng.uniform(60, 200, 2500)):
        base[y - 2:y + 3, x - 2:x + 3] += a
    base = np.clip(base, 0, 255).astype(np.uint8)
    return {i: base[step * i:step * i + h] for i in range(lo, hi)}


def main() -> None:
    port, nproc, pid, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4"
                               ).strip()
    import jax
    # the first jax touch: the worker must run on its virtual CPU devices
    # even where an accelerator is present
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from imagestitch_tpu.ops import phase_corr
    from imagestitch_tpu.parallel import distributed as dist

    ctx = dist.initialize(coordinator_address=f"127.0.0.1:{port}",
                          num_processes=nproc, process_id=pid)
    assert ctx.process_count == nproc, ctx
    n_local = jax.local_device_count()

    # --- host-sharded decode: pairs are the sharded unit -------------------
    n_frames = 2 * len(jax.devices()) // 2 + 1     # D pairs over D devices
    n_pairs = n_frames - 1
    my_pairs = dist.host_shard(list(range(n_pairs)), ctx, overlap=0)
    frames = make_frames(my_pairs[0], my_pairs[-1] + 2, n_frames)
    a_loc = np.stack([frames[k] for k in my_pairs]).astype(np.float32)
    b_loc = np.stack([frames[k + 1] for k in my_pairs]).astype(np.float32)

    # --- global sharded batch + ONE jitted registration step ---------------
    ga = dist.make_global_batch(a_loc, ctx)
    gb = dist.make_global_batch(b_loc, ctx)
    h, w = a_loc.shape[1:]
    hp, wp = phase_corr.optimal_dft_size(h), phase_corr.optimal_dft_size(w)
    sx, sy, resp = phase_corr._phase_correlate_batch_jit(ga, gb, hp, wp)

    # cross-process reduction on the sharded result (exercises a collective
    # spanning both processes' devices)
    mean_resp = float(np.asarray(jax.jit(lambda r: r.mean())(resp)))

    # --- local records -> DCN gather ---------------------------------------
    def local_vals(arr):
        shards = sorted(arr.addressable_shards, key=lambda s: s.index)
        return np.concatenate([np.asarray(s.data) for s in shards])

    rec_local = np.stack([local_vals(sx), local_vals(sy),
                          local_vals(resp)], axis=1)
    assert rec_local.shape == (len(my_pairs), 3), rec_local.shape
    rec_global = dist.all_gather_records(rec_local, ctx)
    assert rec_global.shape == (n_pairs, 3), rec_global.shape

    with open(os.path.join(out_dir, f"proc{pid}.json"), "w") as f:
        json.dump({"pid": pid,
                   "process_count": ctx.process_count,
                   "local_devices": n_local,
                   "global_devices": len(jax.devices()),
                   "my_pairs": my_pairs,
                   "mean_resp": mean_resp,
                   "records": rec_global.tolist()}, f)
    print(f"proc{pid} ok: pairs={my_pairs} mean_resp={mean_resp:.4f}",
          flush=True)


if __name__ == "__main__":
    main()
