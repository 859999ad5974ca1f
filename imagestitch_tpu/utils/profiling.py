"""Profiling and throughput measurement.

Upgrade over the reference's wall-clock prints (reference: Stitcher.py:61-90,
:166-182): fenced phase timers (``block_until_ready`` so async dispatch can't
lie), a frames/s meter, a jax.profiler trace context for device timelines,
and the reduction of such a trace to per-operation device time.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax


@dataclass
class PhaseTimer:
    """Named phase spans; device-fenced when given result handles."""
    spans: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                jax.block_until_ready(fence)
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def fence(self, name: str, value):
        """Time until ``value`` is device-complete, attributed to ``name``."""
        t0 = time.perf_counter()
        jax.block_until_ready(value)
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0
        return value

    def report(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.spans.items()})


def frames_per_second(n_frames: int, fn, *args, repeats: int = 3,
                      **kwargs) -> float:
    """Best-of-N fenced throughput of ``fn(*args)`` processing n_frames."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return n_frames / best


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def card_info() -> str:
    """``name, power limit`` of each GPU (joined by "; "), from nvidia-smi
    rather than JAX.

    A card set below its maximum power runs slower under load, so every
    recorded time carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def device_op_times(log_dir: str) -> Tuple[Dict[str, Tuple[float, int]],
                                           Dict[str, int]]:
    """Per-operation device time from the newest trace under ``log_dir``.

    Reads the ``.xplane.pb`` that ``trace`` writes.  On each device plane
    ("/device:..."), the "XLA Ops" line holds one event per executed HLO
    operation; a plane without it contributes its stream lines (one event
    per kernel).  Returns ``({name: (total_ms, count)}, {line: n_events})``,
    the second for reading a trace by hand.
    """
    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    totals: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    lines: Dict[str, int] = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        plane_lines = list(plane.lines)
        for ln in plane_lines:
            lines[f"{plane.name} {ln.name}"] = sum(1 for _ in ln.events)
        ops = [ln for ln in plane_lines if ln.name == "XLA Ops"]
        for ln in ops or [ln for ln in plane_lines
                          if ln.name.startswith("Stream")]:
            for ev in ln.events:
                t = totals[ev.name]
                t[0] += ev.duration_ns / 1e6
                t[1] += 1
    return {k: (v[0], int(v[1])) for k, v in totals.items()}, lines
