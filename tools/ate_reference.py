"""CPU reference for chip_smoke.py's points phase: track the same frames on
the CPU device and print the ATE that chip_smoke.CPU_POINTS_ATE_M records.

    JAX_PLATFORMS=cpu python tools/ate_reference.py

Runs the full KITTI-sized configuration on XLA:CPU (minutes)."""
import json
import os
import sys

os.environ.setdefault("LLDSLAM_NO_COMPILE_CACHE", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402

r = chip_smoke.run_points(warmup=False)
print(json.dumps({"platform": jax.devices()[0].platform,
                  "ate_m": r["ate"], "path_m": r["length"],
                  "n_kf": r["n_kf"],
                  "not_ok": [s for s in r["states"] if s != "OK"]}))
