"""imagestitch_tpu — an accelerator-native micrograph stitching framework.

A from-scratch JAX/XLA rebuild of the VFSMS pipeline (Ma et al.,
Comput. Mater. Sci. 158:1-13, 2019; reference implementation
Keep-Passion/ImageStitch): batched FFT phase-correlation and feature
registration with incremental ROI search, seven fusion modes, canvas
composition, a distributed pose-graph solver, and multi-chip scaling over
``jax.sharding`` meshes.
"""
from .config import StitchConfig, FeatureConfig, EnhanceConfig, direction_increase
from .core.stitcher import Stitcher, StitchResult
from .core.compose import compose, compute_placement
from .core.stream_out import (compose_streamed, compose_color_host,
                              compose_host, compose_host_positions)
from .core import registration

__version__ = "0.1.0"

__all__ = [
    "StitchConfig", "FeatureConfig", "EnhanceConfig", "direction_increase",
    "Stitcher", "StitchResult", "compose", "compute_placement",
    "compose_streamed", "compose_color_host", "compose_host",
    "compose_host_positions", "registration",
]
