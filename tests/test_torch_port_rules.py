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
            "import autodist_tpu_torch.autodist, autodist_tpu_torch.runner\n"
            "import autodist_tpu_torch.models.lm, autodist_tpu_torch.models.mlp\n"
            "from autodist_tpu_torch.models import ZOO, bilstm, ncf, resnet\n"
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


@pytest.mark.parametrize("model", ["resnet", "bilstm", "ncf"])
def test_zoo_init_defaults_to_cuda_and_raises_without_it(model):
    _no_cuda()
    from autodist_tpu_torch.models import bilstm, ncf, resnet
    from autodist_tpu_torch.utils.tree import leaves
    mod, cfg = {"resnet": (resnet, resnet.cifar_resnet(depth=8)),
                "bilstm": (bilstm, bilstm.BiLSTMConfig(vocab=50)),
                "ncf": (ncf, ncf.NCFConfig(num_users=20,
                                           num_items=10))}[model]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.init(cfg)
    params = mod.init(cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in leaves(params))


def test_training_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    import types

    from autodist_tpu_torch import AutoDist
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.cluster import Mesh
    from autodist_tpu_torch.kernel.graph_transformer import GraphTransformer
    from autodist_tpu_torch.models import mlp
    from autodist_tpu_torch.runner import Runner
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    params = mlp.linreg_init("cpu")
    batch = (np.zeros(8, np.float32), np.zeros(8, np.float32))
    opt = lambda ts: torch.optim.SGD(ts, lr=0.1)  # noqa: E731
    try:
        ad = AutoDist(strategy_builder=AllReduce())
        item = ad.capture(mlp.linreg_loss, params, opt, example_batch=batch)
        with pytest.raises(RuntimeError, match="CUDA"):
            ad.create_distributed_session(item)
        assert not torch.distributed.is_initialized()
    finally:
        autodist_mod._reset_default()
    # A program placed on the default device: create_state refuses.
    mesh = Mesh(np.array([torch.device("cuda")], dtype=object), ("data",))
    program = GraphTransformer(AllReduce().build(item, ad.resource_spec),
                               types.SimpleNamespace(mesh=mesh),
                               item).transform()
    with pytest.raises(RuntimeError, match="CUDA"):
        Runner(program).create_state()


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    from autodist_tpu_torch.ops import build
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    (tmp_path / "common.cuh").write_text("// v1\n")
    (tmp_path / "k.cu").write_text('#include <cmath>\n#include "common.cuh"\n')
    (tmp_path / "other.cu").write_text("// no headers\n")
    first, other = build.library_path("k")[1], build.library_path("other")[1]
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build.library_path("k")[1] != first
    assert build.library_path("other")[1] == other
    # The real kernels: both include the shared header and the TMA / wgmma
    # one.
    monkeypatch.undo()
    headers = {"flash_fwd": ["flash_common.cuh", "hopper.cuh"],
               "flash_bwd": ["flash_common.cuh", "hopper.cuh"]}
    assert set(build.KERNELS) == set(headers)
    for name in build.KERNELS:
        srcs = build._sources(os.path.join(build.CSRC, name + ".cu"))
        assert [os.path.basename(p) for p in srcs] == [name + ".cu",
                                                       *headers[name]]


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
