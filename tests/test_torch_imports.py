"""Importing every module of magi_tpu_torch pulls in neither jax nor
magi_tpu, nor the packages the port reads checkpoints without
(`safetensors`, `zstandard`) or needs only for T5's tokenizer
(`transformers`); checked in a fresh interpreter."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import importlib, pkgutil, sys
import magi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(magi_tpu_torch.__path__, "magi_tpu_torch.")]
assert {"magi_tpu_torch.sampling.batched", "magi_tpu_torch.serve.service", "magi_tpu_torch.comfyui.comfy_nodes",
        "magi_tpu_torch.runtime_native"} <= set(names), names
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "magi_tpu", "safetensors", "zstandard", "transformers", "requests",
                                    "PIL"))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_magi_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 20
    assert bad == "[]", bad
