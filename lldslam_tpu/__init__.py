"""lldslam_tpu — an accelerator-native stereo point+line visual SLAM framework.

A from-scratch rebuild of the capabilities of LLD-SLAM (alexandervakhitov/lld-slam,
a C++ ORB-SLAM2 fork with learnable line descriptors) designed for a JAX
accelerator (an NVIDIA H100 GPU):

- All per-pixel / per-feature compute is batched JAX/XLA,
  with fixed capacities + validity masks instead of dynamic object graphs.
- The map is a struct-of-arrays (SoA) device-resident store, not a pointer graph.
- Bundle adjustment is batched Gauss-Newton with dense-block Schur complement,
  shardable over a `jax.sharding.Mesh` for multi-GPU global BA.
- The reference's 4-thread racing pipeline becomes a deterministic schedule:
  track -> (on keyframe) map update + local BA -> (periodic) loop closure.

Reference layer map: see SURVEY.md at the repo root. Citations in docstrings are
`file:line` into the reference tree (for parity checking only; no code is ported).
"""

__version__ = "0.1.0"

import jax as _jax

# SLAM geometry is correctness-critical. On a GPU the default f32 matmul
# precision may run in TF32 (~3 decimal digits), which breaks pose
# composition / triangulation / normal equations at ranges of tens of
# metres. Force full f32 products as the framework default; throughput-
# critical code opts into bf16 explicitly where the math is exact (0/1 bit
# matrices in ops/hamming.py).
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache: the tracker step, local BA and the loop
# closing programs take tens of seconds to compile, so processes share one
# cache. JAX_COMPILATION_CACHE_DIR, when set, is read by JAX itself and wins;
# otherwise the cache lives at one fixed directory inside the checkout (the
# path is part of the cache key, so it must not move between runs). Opt out
# with LLDSLAM_NO_COMPILE_CACHE=1 (the CPU test suite does).
import os as _os

CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

if not _os.environ.get("LLDSLAM_NO_COMPILE_CACHE"):
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
