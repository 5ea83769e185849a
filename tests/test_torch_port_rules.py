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
            "import autodist_tpu_torch.serve.decode\n"
            "import autodist_tpu_torch.models.bert\n"
            "import autodist_tpu_torch.ops.flash_attention\n"
            "import autodist_tpu_torch.convert, autodist_tpu_torch.strategy\n"
            "import autodist_tpu_torch.autodist, autodist_tpu_torch.runner\n"
            "import autodist_tpu_torch.models.lm, autodist_tpu_torch.models.mlp\n"
            "import autodist_tpu_torch.parallel.moe\n"
            "import autodist_tpu_torch.pipeline, autodist_tpu_torch.ops.blocks\n"
            "import autodist_tpu_torch.data\n"
            "from autodist_tpu_torch.observability import (monitor, profile,\n"
            "                                              skew)\n"
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


# -- public names held to the JAX package's (ROADMAP A16) --------------------
# These import JAX inside the test: the rest of this file runs without it.

def test_package_exports_the_jax_packages_names():
    import autodist_tpu

    import autodist_tpu_torch
    from autodist_tpu_torch import autodist as autodist_mod
    assert autodist_tpu_torch.__all__ == autodist_tpu.__all__
    assert autodist_tpu_torch.__version__ == autodist_tpu.__version__
    autodist_mod._reset_default()
    try:
        assert autodist_tpu_torch.get_default_autodist() is None
        ad = autodist_tpu_torch.AutoDist(device="cpu")
        assert autodist_tpu_torch.get_default_autodist() is ad
    finally:
        autodist_mod._reset_default()
    assert autodist_tpu_torch.get_default_autodist() is None


SPEC_8_GPUS = """
nodes:
  - address: 10.0.0.1
    gpus: [0, 1, 2, 3, 4, 5, 6, 7]
    chief: true
"""


def test_build_strategy_matches_jax(tmp_path):
    """``AutoDist.build_strategy`` on one spec file: the JAX package's
    node configs, and no world started."""
    import jax
    import optax
    from autodist_tpu import AutoDist as JAutoDist
    from autodist_tpu import autodist as jautodist_mod
    from autodist_tpu.models import bert as jbert
    from autodist_tpu.strategy import AllReduce as JAllReduce

    from autodist_tpu_torch import AutoDist, convert
    from autodist_tpu_torch import autodist as autodist_mod
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.strategy import AllReduce
    spec = tmp_path / "spec.yml"
    spec.write_text(SPEC_8_GPUS)
    jparams, jloss, batch = jbert.tiny_fixture(seed=0)
    jautodist_mod._reset_default()
    jad = JAutoDist(resource_spec_file=str(spec),
                    strategy_builder=JAllReduce(chunk_size=16))
    want = jad.build_strategy(jad.capture(jloss, jparams, optax.sgd(0.1),
                                          example_batch=batch))
    jautodist_mod._reset_default()
    autodist_mod._reset_default()
    try:
        ad = AutoDist(resource_spec_file=str(spec),
                      strategy_builder=AllReduce(chunk_size=16),
                      device="cpu")
        item = ad.capture(bert.make_loss_fn(bert.bert_tiny()),
                          convert.params_from_jax(jax.device_get(jparams),
                                                  "cpu"),
                          lambda ts: torch.optim.SGD(ts, lr=0.1),
                          example_batch=batch)
        got = ad.build_strategy(item)
        assert not torch.distributed.is_initialized()
    finally:
        autodist_mod._reset_default()
    assert [n.SerializeToString() for n in got.node_config] == \
        [n.SerializeToString() for n in want.node_config]
    assert list(got.graph_config.replicas) == \
        list(want.graph_config.replicas)


ZOO_NAMES = ("mlp", "resnet", "bert", "lm", "bilstm", "ncf")


@pytest.mark.parametrize("model", ZOO_NAMES)
def test_tiny_fixture_matches_jax(model):
    """Each model's ``tiny_fixture``: the JAX batch bitwise, the JAX param
    tree's names and shapes, params drawn from the seed, and the loss on
    the JAX package's params carried across with ``convert`` at the zoo's
    f32 tolerance (atol 2e-5 / rtol 1e-4, ``tests/test_torch_models.py``)."""
    import importlib

    import jax

    from autodist_tpu_torch import convert
    from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name
    jmod = importlib.import_module(f"autodist_tpu.models.{model}")
    mod = importlib.import_module(f"autodist_tpu_torch.models.{model}")
    jparams, jloss, jbatch = jmod.tiny_fixture(seed=1)
    params, loss, batch = mod.tiny_fixture(seed=1, device="cpu")
    assert len(batch) == len(jbatch)
    for a, b in zip(batch, jbatch):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    def shapes(tree):
        return {path_to_name(p): tuple(np.shape(t))
                for p, t in flatten_with_path(tree)[0]}
    jparams = jax.device_get(jparams)
    assert shapes(params) == shapes(jparams)

    def named(tree):
        return {path_to_name(p): t for p, t in flatten_with_path(tree)[0]}
    ours = named(params)
    again = named(mod.tiny_fixture(seed=1, device="cpu")[0])
    other = named(mod.tiny_fixture(seed=2, device="cpu")[0])
    assert all(torch.equal(t, again[n]) for n, t in ours.items())
    assert any(not torch.equal(t, other[n]) for n, t in ours.items())
    got = loss(convert.params_from_jax(jparams, "cpu"),
               tuple(torch.from_numpy(a) for a in batch))
    np.testing.assert_allclose(float(got), float(jloss(jparams, jbatch)),
                               rtol=1e-4, atol=2e-5)


def test_lm_synthetic_batch_matches_jax():
    from autodist_tpu.models import lm as jlm

    from autodist_tpu_torch.models import lm
    for kw in (dict(), dict(batch_size=4, seq_len=8, seed=3)):
        (got,), (want,) = (lm.synthetic_batch(lm.lm_tiny(), **kw),
                           jlm.synthetic_batch(jlm.lm_tiny(), **kw))
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("buckets", [(8, 16), ((8, 16), (16, 16))],
                         ids=["rows", "rows_seq"])
def test_serve_engine_program_and_compiled_buckets_match_jax(buckets):
    """``ServeEngine.program`` (replica 0's) and ``ReplicaRuntime.
    compile_bucket`` / ``buckets_compiled``: the JAX package's bucket list
    for the same buckets; ``compile_bucket`` of a compiled bucket returns
    its graph."""
    import jax
    from autodist_tpu.models import transformer as JT
    from autodist_tpu.serve.engine import ServeEngine as JServeEngine

    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.models import transformer as T
    from autodist_tpu_torch.serve.engine import ServeEngine
    cfg = bert.bert_tiny()
    params = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    jcfg = JT.TransformerConfig(vocab=cfg.vocab, dim=cfg.dim,
                                num_heads=cfg.num_heads,
                                num_layers=cfg.num_layers,
                                max_len=cfg.max_len, causal=False,
                                num_segments=2)
    jparams = JT.init(jax.random.PRNGKey(0), jcfg)
    example = (np.zeros((8, 16), np.int32), np.zeros((8, 16), np.int32))
    engine = ServeEngine(
        lambda p, b: T.encode(p, cfg, b[0], segment_ids=b[1]), params,
        example, buckets, device="cpu")
    jengine = JServeEngine(
        lambda p, b: JT.encode(p, jcfg, b[0], segment_ids=b[1]), jparams,
        example, buckets)
    try:
        rep, jrep = engine.replicas[0], jengine.replicas[0]
        assert engine.program is rep.program
        assert jengine.program is jrep.program
        assert rep.buckets_compiled == jrep.buckets_compiled
        for b in rep.buckets_compiled:
            graph = rep.compile_bucket(b, engine.item.batch_struct)
            assert graph is rep.compile_bucket(b, engine.item.batch_struct)
            assert not graph.captured  # no card: the forward, called
    finally:
        engine.close()
        jengine.close()
