# Copyright 2026 Conch-TPU authors.
# SPDX-License-Identifier: Apache-2.0

"""The port's import rule: ``conch_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor any module of the JAX package (``conch_tpu``).

A fresh interpreter imports every module under ``conch_tpu_torch/`` (the
package walked) and ``chip_smoke`` (without running ``main()``), then
lists what ``sys.modules`` holds of JAX and of ``conch_tpu``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import conch_tpu_torch
names = [m.name for m in pkgutil.walk_packages(conch_tpu_torch.__path__, "conch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "conch_tpu") or m.startswith(("jax.", "jaxlib.", "conch_tpu.")))
print(json.dumps({"imported": names, "forbidden": bad}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "conch_tpu_torch.ops.vision.bev_pool" in result["imported"]
    assert len(result["imported"]) > 80
    assert result["forbidden"] == []
