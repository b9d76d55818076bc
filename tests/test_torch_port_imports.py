"""The port's import rule: every module of ``unigen_tpu_torch`` and
``chip_smoke.py`` import without JAX and without the JAX package, and
without ``safetensors`` or ``transformers`` (the card host has neither:
the loaders read safetensors files themselves and import transformers'
tokenizers only when a checkpoint holds one). Checked in a fresh
interpreter, so this test process's own imports do not count."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
names = sorted(".".join(p.relative_to(root).with_suffix("").parts)
               for p in (root / "unigen_tpu_torch").rglob("*.py"))
names = [n[:-len(".__init__")] if n.endswith(".__init__") else n for n in names]
for n in names + ["chip_smoke"]:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "unigen_tpu" or m.startswith("unigen_tpu.")
             or m.split(".")[0] in ("safetensors", "transformers"))
print(len(names), "modules")
if bad:
    raise SystemExit(f"imported {bad}")
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    n = int(out.stdout.split()[0])
    assert n >= 50
    for name in ("serving_steps", "serving_cache", "torch_bridge", "torch_bridge_sd3",
                 "loading", "sd3", "lora", "checkpoint", "datasets", "sampler", "prefetch",
                 "native", "conditions", "train", "sana", "blocks_sana", "gemma_text",
                 "dcae"):
        assert any(name in p.name for p in (ROOT / "unigen_tpu_torch").rglob("*.py"))
