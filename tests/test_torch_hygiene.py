"""Import hygiene of the port: it runs where JAX, yaml, Pillow and matplotlib are absent.

In a fresh interpreter, import every module of img2latex_tpu_torch and build
a CPU Predictor, decoding a fixed and a bucketed batch of arrays; then none
of jax, flax, yaml, PIL, matplotlib, triton or any img2latex_tpu module may
be loaded.  An ``ast`` scan of the package, of
chip_smoke.py and of ``scripts/*_torch.py`` finds no such import either.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "img2latex_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "PIL", "matplotlib", "triton",
             "img2latex_tpu")

_PROBE = r"""
import importlib, json, pkgutil, sys
import numpy as np
import img2latex_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "img2latex_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from img2latex_tpu_torch import Config, LaTeXTokenizer, Predictor, build_model
cfg = Config()
cfg.model.embedding_dim = 16
cfg.model.decoder.hidden_dim = 16
cfg.model.encoder.cnn.img_height, cfg.model.encoder.cnn.img_width = 8, 16
cfg.model.encoder.cnn.conv_filters = [2, 2]
cfg.inference.max_length = 4
cfg.hardware.compute_dtype = "float32"
tok = LaTeXTokenizer()
tok.default_init()
pred = Predictor(cfg, build_model(cfg, tok.vocab_size, device="cpu"), tok, batch_size=2, device="cpu")
out = pred.predict_batch([np.zeros((8, 16, 1), np.uint8)] * 3, return_ids=True)
out += pred.predict_batch([np.zeros((8, w, 1), np.uint8) for w in (4, 30)], return_ids=True, bucket_widths=[4])
print(json.dumps({"modules": sorted(sys.modules), "imported": names, "n_out": len(out)}))
"""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_and_cpu_predictor_load_nothing_forbidden():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["n_out"] == 5
    assert len(report["imported"]) >= 15
    loaded = [m for m in report["modules"] if _forbidden(m)]
    assert loaded == []


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*_torch.py"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    allowed_lazy = {"yaml", "PIL"}  # only inside the functions that need them, off the inference path
    bad = [n for n in names if _forbidden(n) and n.split(".")[0] not in allowed_lazy]
    assert bad == []


def test_yaml_and_pil_imports_are_inside_functions():
    for path in _sources():
        tree = ast.parse(path.read_text())
        for node in tree.body:  # module level only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
                assert not any(_forbidden(m or "") for m in mods), (path, mods)
