"""Import guard: the PyTorch port runs on a machine without JAX.

A fresh interpreter blocks `jax`, `jaxlib` and the JAX package
(`sys.modules[name] = None` makes any import of them raise), imports every
module of the port, and runs `project_scan` on a tiny CPU batch.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "feature_base_pointcloud_registration_tpu"):
    sys.modules[name] = None

import numpy as np
import torch
import feature_base_pointcloud_registration_tpu_torch as port

for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)

from feature_base_pointcloud_registration_tpu_torch import Params, RawScan
from feature_base_pointcloud_registration_tpu_torch.ops.projection import (
    project_scan)

params = Params(n_scan=2, horizon_scan=8)
r = np.random.RandomState(0)
xyz = r.uniform(-10, 10, (12, 3)).astype(np.float32)
raw = RawScan.from_numpy(xyz, np.ones(12), r.randint(0, 2, 12),
                         np.zeros(12), max_points=16,
                         device=torch.device("cpu"))
cloud = project_scan(params, RawScan(*(a[None] for a in raw)))
assert cloud.points.shape == (1, 16, 3), cloud.points.shape
assert 0 < int(cloud.num_points[0]) <= 12
loaded = sorted(k for k, v in sys.modules.items()
                if v is not None and (k.split(".")[0] in ("jax", "jaxlib")
                or k.startswith("feature_base_pointcloud_registration_tpu.")))
assert not loaded, loaded
print("NO_JAX_OK", int(cloud.num_points[0]))
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK" in proc.stdout
