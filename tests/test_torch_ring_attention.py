"""Ring attention's hop functions and the ring itself, against the JAX
package, on the CPU.

* ``block_attn_fwd`` / ``block_attn_bwd`` / ``combine_blocks`` (the port's
  plain path here; on the card the same calls launch the flash kernels)
  against the JAX functions in Pallas interpret mode and on their dense
  path, causal and not, with rows that see no key and a wholly masked
  block: f32 inputs, rtol / atol 1e-5 (other summation orders), no NaN,
  and the empty rows' sentinel (o = 0, lse = -1e30) exact. The backward
  runs against a global lse that every row reaches through some block, as
  in a ring, where the JAX dense backward's p = 1 for a row with no
  visible key cannot arise (ROADMAP.md, Queue C).
* ``ring_attention`` and ``ulysses_attention``, forward and the gradients
  of sum(o^2), on a 4-rank gloo world (one subprocess per rank, each
  holding its quarter of the sequence) against the JAX package's on a
  ``{"seq": 4}`` CPU mesh (the ``tests/test_parallel.py:30-110`` cases):
  o at rtol / atol 2e-5, gradients at 5e-5, as there. A planted fault, the
  ring with one hop dropped, must read above that tolerance. A hop (an
  all-to-all with zero splits to all but the neighbours) must deliver the
  previous rank's tensors, whatever their dtype.
* On the card the hop functions launch the kernels or raise: inputs the
  kernels do not take (a head dim outside 16-128, float16) raise there
  instead of running the plain version.
"""
import fcntl
import functools
import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from autodist_tpu.parallel import ring_attention as jring
from autodist_tpu.parallel import ulysses_attention as julysses
from autodist_tpu_torch.ops import flash_attention as fa

jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

WORLD = 4
SHAPE = (2, 4, 32, 16)           # (b, h, s, d): global sequence 32
BLOCK = (2, 4, 16, 16)           # one hop's block
O_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)
# (q_offset, k_offset) of a 16-row block: the diagonal; a block wholly
# below it (all visible); rows 0-7 with no visible key; a wholly masked
# block (every row sees no key).
OFFSETS = [(0, 0), (16, 0), (0, 8), (0, 16)]


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _assert_close(got, want, **tol):
    for g, w in zip(got, want):
        g = np.asarray(g.detach() if isinstance(g, torch.Tensor) else g)
        assert not np.isnan(g).any()
        np.testing.assert_allclose(g, np.asarray(w), **tol)


# -- the hop functions --------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("offs", OFFSETS, ids=lambda o: f"q{o[0]}k{o[1]}")
def test_block_attn_fwd_matches_jax(causal, offs):
    q, k, v = (_rand(BLOCK, s) for s in range(3))
    got = fa.block_attn_fwd(_t(q), _t(k), _t(v), causal, *offs)
    assert all(t.dtype == torch.float32 for t in got)
    assert tuple(got[1].shape) == BLOCK[:3] + (1,)
    for interpret in (True, False):  # Pallas interpret; the dense path
        want = jfa.block_attn_fwd(q, k, v, causal, *offs,
                                  interpret=interpret)
        _assert_close(got, want, **BLOCK_TOL)
    if causal and offs[1] > offs[0]:
        q_pos = offs[0] + np.arange(BLOCK[2])
        empty = q_pos < offs[1]  # rows before the block's first key
        assert torch.equal(got[0][:, :, empty], torch.zeros_like(
            got[0][:, :, empty]))
        assert bool((got[1][:, :, empty] == fa._NEG_INF).all())


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("offs", OFFSETS, ids=lambda o: f"q{o[0]}k{o[1]}")
def test_block_attn_bwd_matches_jax(causal, offs):
    q, k, v, do = (_rand(BLOCK, s) for s in range(4))
    kd, vd = _rand(BLOCK, 5), _rand(BLOCK, 6)
    # The global lse of a ring that holds this block and the diagonal one
    # (k at q's own offset): every row sees at least its own position.
    o_b, lse_b = jfa.block_attn_fwd(q, k, v, causal, *offs, interpret=True)
    o_d, lse_d = jfa.block_attn_fwd(q, kd, vd, causal, offs[0], offs[0],
                                    interpret=True)
    o, lse = jfa.combine_blocks(o_b, lse_b, o_d, lse_d)
    delta = (do * np.asarray(o)).sum(-1, keepdims=True)
    got = fa.block_attn_bwd(_t(q), _t(k), _t(v), _t(do), _t(lse),
                            _t(delta), causal, *offs)
    assert all(t.dtype == torch.float32 for t in got)
    for interpret in (True, False):
        want = jfa.block_attn_bwd(q, k, v, do, lse, delta, causal, *offs,
                                  interpret=interpret)
        _assert_close(got, want, **BLOCK_TOL)
    if causal and offs[1] >= offs[0] + BLOCK[2]:  # wholly masked
        assert all(not t.any() for t in got)


def test_combine_blocks_matches_jax_with_empty_partials():
    o_a, o_b = _rand(BLOCK, 0), _rand(BLOCK, 1)
    lse_a = _rand(BLOCK[:3] + (1,), 2)
    lse_b = _rand(BLOCK[:3] + (1,), 3)
    lse_b[:, :, :4] = fa._NEG_INF        # b empty on rows 0-3
    lse_a[:, :, 2:6] = fa._NEG_INF       # a empty on 2-5: both on 2-3
    o_b[:, :, :4] = 0.0
    o_a[:, :, 2:6] = 0.0
    got = fa.combine_blocks(_t(o_a), _t(lse_a), _t(o_b), _t(lse_b))
    want = jfa.combine_blocks(o_a, lse_a, o_b, lse_b)
    _assert_close(got, want, **BLOCK_TOL)
    assert not got[0][:, :, 2:4].any()   # empty + empty = empty, no NaN
    assert torch.equal(got[0][:, :, :2], _t(o_a)[:, :, :2])


# -- the 4-rank gloo world ----------------------------------------------------

_RANK = r'''
import datetime, importlib, os, pickle, sys
import numpy as np, torch, torch.distributed as dist
# (the package's ring_attention names the function; this is the module)
ra = importlib.import_module("autodist_tpu_torch.parallel.ring_attention")

out, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
data = dict(np.load(os.path.join(out, "qkv.npz")))
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
s = data["q"].shape[2] // world
mine = {n: torch.from_numpy(a[:, :, rank * s:(rank + 1) * s].copy())
        for n, a in data.items()}
res = {}


def run(name, attn, causal):
    q, k, v = (mine[n].clone().requires_grad_(True) for n in "qkv")
    o = attn(q, k, v, None, causal)
    (o ** 2).sum().backward()
    res[name] = [t.detach().numpy().copy()
                 for t in (o, q.grad, k.grad, v.grad)]


for causal in (False, True):
    tag = "causal" if causal else "full"
    run(f"ring/{tag}", ra.ring_attention, causal)
    run(f"ulysses/{tag}", ra.ulysses_attention, causal)

# The planted fault: the ring with its second hop's partial dropped.
real, calls = ra.block_attn_fwd, []


def dropped(q, k, v, causal, q_offset, k_offset):
    calls.append(1)
    o, lse = real(q, k, v, causal, q_offset, k_offset)
    if len(calls) % world == 2:
        return torch.zeros_like(o), torch.full_like(lse, -1e30)
    return o, lse


ra.block_attn_fwd = dropped
with torch.no_grad():
    res["dropped_hop"] = ra.ring_attention(mine["q"], mine["k"], mine["v"],
                                           None, True).numpy().copy()
ra.block_attn_fwd = real

# One hop of two tensors of different dtypes (sent as bytes): each rank
# receives the previous rank's.
hop = ra._hop((torch.full((3, 5), float(rank)),
               torch.full((7,), rank, dtype=torch.bfloat16)), None, rank,
              world)
res["hop"] = [t.float().numpy().copy() for t in hop]
dist.barrier()
dist.destroy_process_group()
with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every ring case, run once per test session on a 4-rank gloo world
    (the first xdist worker to need it runs it under a file lock):
    {case: [rank 0's result, ...]}."""
    from test_torch_ps_strategies import _run_world, _shared_dir
    shared = _shared_dir(tmp_path_factory)
    out = shared / "ring_world"
    with open(shared / "ring_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            np.savez(out / "qkv.npz", q=_rand(SHAPE, 0), k=_rand(SHAPE, 1),
                     v=_rand(SHAPE, 2))
            outs, err = _run_world(_RANK, WORLD, [str(out)], str(out))
            (out / "error").write_text(err if outs is None else "")
            (out / "done").touch()
    err = (out / "error").read_text()
    assert not err, err
    per_rank = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            per_rank.append(pickle.load(f))
    return {name: [res[name] for res in per_rank] for name in per_rank[0]}


def _whole(ranks, i):
    """Output ``i`` of every rank, concatenated along the sequence."""
    return np.concatenate([r[i] for r in ranks], axis=2)


@functools.lru_cache(maxsize=None)
def _jax_attention(attn, causal, interpret=None):
    """(o, dq, dk, dv) of sum(o^2) through the JAX package's ring or
    Ulysses attention on a {"seq": 4} mesh of the CPU devices."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), axis_names=("seq",))
    if attn == "ring":
        kw = {} if interpret is None else {"interpret": interpret}
        inner = lambda q, k, v: jring(q, k, v, axis_name="seq",  # noqa: E731
                                      causal=causal, **kw)
    else:
        inner = lambda q, k, v: julysses(q, k, v, axis_name="seq",  # noqa: E731
                                         causal=causal)
    f = jax.shard_map(inner, mesh=mesh,
                      in_specs=(P(None, None, "seq", None),) * 3,
                      out_specs=P(None, None, "seq", None), check_vma=False)
    q, k, v = (jnp.asarray(_rand(SHAPE, s)) for s in range(3))
    o = f(q, k, v)
    grads = jax.grad(lambda q, k, v: (f(q, k, v) ** 2).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(x) for x in (o,) + tuple(grads)]


@pytest.mark.parametrize("interpret", [None, True],
                         ids=["dense-hops", "pallas-interpret-hops"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_attention_matches_jax_on_four_gloo_ranks(world, causal,
                                                       interpret):
    ranks = world[f"ring/{'causal' if causal else 'full'}"]
    want = _jax_attention("ring", causal, interpret)
    for i, tol in enumerate((O_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        got = _whole(ranks, i)
        assert not np.isnan(got).any()
        np.testing.assert_allclose(got, want[i], err_msg=f"output {i}",
                                   **tol)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ulysses_attention_matches_jax_on_four_gloo_ranks(world, causal):
    ranks = world[f"ulysses/{'causal' if causal else 'full'}"]
    want = _jax_attention("ulysses", causal)
    for i, tol in enumerate((O_TOL, GRAD_TOL, GRAD_TOL, GRAD_TOL)):
        np.testing.assert_allclose(_whole(ranks, i), want[i],
                                   err_msg=f"output {i}", **tol)


def test_a_dropped_hop_reads_above_the_tolerance(world):
    """The planted fault: the ring's o with one hop's partial dropped on
    every rank must fail the tolerance the ring passes."""
    got = np.concatenate(world["dropped_hop"], axis=2)
    want = _jax_attention("ring", True)[0]
    err = np.abs(got - want).max()
    assert err > O_TOL["atol"] + O_TOL["rtol"] * np.abs(want).max(), err
    intact = _whole(world["ring/causal"], 0)
    np.testing.assert_allclose(intact, want, **O_TOL)


def test_a_hop_delivers_the_previous_ranks_tensors(world):
    for r, (f32, bf16) in enumerate(world["hop"]):
        prev = float((r - 1) % WORLD)
        assert f32.shape == (3, 5) and bf16.shape == (7,), r
        assert (f32 == prev).all() and (bf16 == prev).all(), r


class _OnTheCard:
    """What the hop functions read of a CUDA tensor before they touch its
    data (shape, dtype, device, layout), so that their choice on the card
    can be checked on a CPU-only build."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda")

    def dim(self):
        return len(self.shape)

    def stride(self, i):
        return 1


@pytest.mark.parametrize("d,dtype", [(48, torch.bfloat16),
                                     (64, torch.float16)],
                         ids=["head-dim-48", "float16"])
def test_hop_functions_on_the_card_raise_for_what_the_kernels_do_not_take(
        d, dtype):
    """No plain version hides behind a hop on the card: inputs the
    kernels do not take raise, as ``flash_fwd`` / ``flash_bwd`` do, and
    nothing is counted as a launch."""
    q = _OnTheCard((1, 2, 8, d), dtype)
    rows = _OnTheCard((1, 2, 8, 1), torch.float32)
    assert not fa.kernel_takes(q, q, q)
    before = (fa.block_attn_fwd.launches, fa.block_attn_bwd.launches)
    with pytest.raises(ValueError, match="head_dim|dtype"):
        fa.block_attn_fwd(q, q, q, True, 0, 0)
    with pytest.raises(ValueError, match="head_dim|dtype"):
        fa.block_attn_bwd(q, q, q, q, rows, rows, True, 0, 0)
    assert (fa.block_attn_fwd.launches, fa.block_attn_bwd.launches) == before
    # Off the card the same shapes run the plain version, as JAX's dense
    # path takes them.
    x = torch.zeros((1, 2, 8, d), dtype=dtype)
    o, lse = fa.block_attn_fwd(x, x, x, True, 0, 0)
    assert o.shape == x.shape and lse.shape == (1, 2, 8, 1)
