"""Rules the port keeps: no JAX and nothing of the JAX package, entry
points that run on the card unless asked for the CPU, and a git-ignored
kernel build directory."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "autodist_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "autodist_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(pkg):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    bad = [(os.path.relpath(p, ROOT), name) for p in sources
           for name in _imported_roots(p) if name in FORBIDDEN]
    assert bad == []


def test_port_imports_with_jax_made_unimportable():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'autodist_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import autodist_tpu_torch, autodist_tpu_torch.serve\n"
            "import autodist_tpu_torch.models.bert\n"
            "import autodist_tpu_torch.ops.flash_attention\n"
            "import autodist_tpu_torch.convert, autodist_tpu_torch.strategy\n"
            "import chip_smoke\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    from autodist_tpu_torch import convert, serve
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T
    cfg = bert.bert_tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.params_from_jax({"w": np.zeros(3, np.float32)})
    params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    example = (np.zeros((8, 16), np.int32), np.zeros((8, 16), np.int32))

    def apply(p, b):
        return T.encode(p, cfg, b[0], segment_ids=b[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.Server(apply, params, example, buckets=(8,))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.ServeEngine(apply, params, example, (8,))


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    _no_cuda()
    proc = subprocess.run([sys.executable, os.path.join(ROOT,
                                                        "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "kernels" not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the checkout the script cannot run."""
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        alone.write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_gitignore_lists_the_kernel_build_directory():
    from autodist_tpu_torch.ops import build
    with open(os.path.join(ROOT, ".gitignore")) as f:
        lines = {ln.strip() for ln in f}
    assert os.path.relpath(build.BUILD_DIR, ROOT) + "/" in lines
    for name in build.KERNELS:
        assert os.path.exists(os.path.join(build.CSRC, name + ".cu"))
