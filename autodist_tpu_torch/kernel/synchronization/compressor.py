"""Gradient compressors: the wire format of one gradient's mean-reduction.

Counterpart of ``autodist_tpu/kernel/synchronization/compressor.py``:
``Compressor`` wraps the mean all-reduce of one gradient over a process
group, ``reduced = decompress(all_reduce(compress(grad)))``, with optional
error-feedback state threaded through (``reduce`` returns the new state; the
Runner copies it into the state's own tensors, so a CUDA graph bound to them
advances them at every replay).

The wire formats:

* ``NoneCompressor``: a plain mean all-reduce, in place;
* ``HorovodCompressor`` (+``EF``): a bfloat16 wire. On NCCL the all-reduce
  runs in bfloat16 (half the bytes; the sum rounds in bfloat16). On gloo
  the wire's rounding is emulated, as the JAX package does on the CPU: the
  gradient is cast to bfloat16 and back and the all-reduce runs in its own
  dtype;
* ``Int8Compressor`` (+``EF``): blockwise max-abs int8 (one f32 scale per
  256 elements). Up to ``_INT8_MAX_AXIS`` ranks the transport is an int8
  all-gather (``torch.int8`` on the wire) and a local dequantized mean;
  beyond it the requantizing ring (:func:`_ring_int8_mean`), whose hops go
  to the neighbour as the ring attention's do (``all_to_all_single`` with
  zero splits but one, ``parallel/collectives.exchange``). ``Int8CompressorEF``
  on a group past the crossover takes the bfloat16 wire with error feedback
  instead (the ring's noise lives in shared partial sums no rank can carry
  forward);
* ``PowerSGDCompressor``: rank-2 PowerSGD with error feedback; the
  all-reduces carry the factors ``P = M Q`` and ``Q' = M^T P-hat``. ``P`` is
  orthogonalized by Gram-Schmidt (matmuls and a norm, no host sync, so a
  CUDA graph captures it) where the JAX package calls ``jnp.linalg.qr``: the
  columns may differ in sign, which ``P-hat Q'^T`` does not see. ``Q`` starts
  from a ``torch.Generator`` seeded with the md5 of the variable's name, the
  JAX package's seed, the same on every rank (the values are not the JAX
  ``jax.random`` draw).

The stateless formats also have a split form, :func:`start_mean`: the
collectives are issued (``async_op`` where the transport is one collective
per tensor) and the returned :class:`Pending` finishes the mean at
``wait()``; the overlap scheduler (``runner.py``) issues a bucket's
reduction from the backward that way.
"""
import hashlib
from abc import ABC, abstractmethod

import torch
import torch.distributed as dist

from autodist_tpu_torch.proto import strategy_pb2

_C = strategy_pb2.AllReduceSynchronizer.Compressor

_INT8_BLOCK = 256

# Above this group size the int8 all-gather transport receives more bytes
# than an uncompressed ring all-reduce ((W-1)*N/4 vs ~2*N f32 words) and the
# gathered buffer is W x the gradient: the stateless wire switches to the
# requantizing ring. A module constant, so a test can force the ring at a
# small world.
_INT8_MAX_AXIS = 8


def all_reduce_mean_(tensor, group):
    """Mean of ``tensor`` over ``group``, in place (sum, then divide by
    the group's size)."""
    dist.all_reduce(tensor, group=group)
    tensor.div_(dist.get_world_size(group))
    return tensor


def nccl_wire(group):
    """Whether ``group``'s collectives run on NCCL (a true bfloat16 wire);
    elsewhere the bfloat16 wire is emulated."""
    return "nccl" in str(dist.get_backend(group)).lower()


class Pending:
    """A reduction in flight: ``wait()`` waits for its collectives and
    returns the result."""

    def __init__(self, works, finish):
        self._works, self._finish = [w for w in works if w is not None], \
            finish

    def wait(self):
        for w in self._works:
            w.wait()
        return self._finish()


def _bf16_start(x, group, async_op=False):
    wire = x.to(torch.bfloat16)
    n = dist.get_world_size(group)
    if x.dtype == torch.bfloat16 or nccl_wire(group):
        work = dist.all_reduce(wire, group=group, async_op=async_op)
        return Pending([work], lambda: wire.to(x.dtype).div_(n))
    # Emulated: the wire's rounding, then the collective in x's dtype.
    out = wire.to(x.dtype)
    work = dist.all_reduce(out, group=group, async_op=async_op)
    return Pending([work], lambda: out.div_(n))


def mean_bf16_wire(x, group):
    """Mean of ``x`` over ``group`` through a bfloat16 wire (a new tensor
    of ``x``'s dtype)."""
    return _bf16_start(x, group).wait()


def _int8_quantize(x, block=_INT8_BLOCK):
    """Blockwise max-abs int8 quantization of a flat vector.

    Returns (q int8 [nblk, block], scale f32 [nblk, 1], pad). All-zero
    blocks quantize to zeros with scale 0 (dequantizes exactly)."""
    n = x.shape[0]
    pad = (-n) % block
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    chunks = x.reshape(-1, block).float()
    amax = chunks.abs().amax(dim=1, keepdim=True)
    # A tensor divisor: a Python scalar one makes CUDA multiply by its
    # rounded reciprocal, a scale one ulp off the true quotient.
    scale = amax / amax.new_full((), 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(chunks / safe), -127, 127).to(torch.int8)
    return q, scale, pad


def int8_transport(group_size):
    """Transport of an int8 reduction over ``group_size`` ranks: the
    crossover is a property of the group the reduction runs over (a
    hierarchical DCN leg of 2 hosts gathers however wide the flat axis)."""
    return "ring" if int(group_size) > _INT8_MAX_AXIS else "allgather"


def _gather(t, group, async_op=False):
    """``(W,) + t.shape`` of every rank's ``t`` (rank order) and the work."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    work = dist.all_gather_into_tensor(out, t, group=group,
                                       async_op=async_op)
    return out.view((n,) + tuple(t.shape)), work


def _int8_allgather_start(q, scale, pad, shape, dtype, group,
                          async_op=False):
    """Transport + decompress of a pre-quantized (q, scale, pad): int8
    all-gather (``torch.int8`` on the wire) and the local dequantized
    mean."""
    qs, w1 = _gather(q, group, async_op)
    ss, w2 = _gather(scale, group, async_op)

    def finish():
        mean = (qs.float() * ss).mean(dim=0).reshape(-1)
        if pad:
            mean = mean[:-pad]
        return mean.reshape(shape).to(dtype)
    return Pending([w1, w2], finish)


def _int8_allgather_mean(q, scale, pad, shape, dtype, group):
    return _int8_allgather_start(q, scale, pad, shape, dtype, group).wait()


def _ring_int8_mean(x, group, block=_INT8_BLOCK):
    """Requantizing int8 ring all-reduce (the EQuARX family): a ring
    reduce-scatter whose wire stays int8 at every hop (each rank receives a
    quantized partial chunk from its left neighbour, dequantizes, adds its
    own f32 contribution, requantizes and forwards), then an int8
    all-gather of the final chunks. The hops are neighbour exchanges."""
    from autodist_tpu_torch.parallel.collectives import exchange
    w = dist.get_world_size(group)
    idx = dist.get_rank(group)
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    chunk = max(block, -(-n // (w * block)) * block)  # a block multiple
    total = chunk * w
    if total > n:
        flat = torch.cat([flat, flat.new_zeros(total - n)])
    chunks = flat.reshape(w, chunk)
    right, left = (idx + 1) % w, (idx - 1) % w

    def quant(c):
        q, s, _ = _int8_quantize(c, block)
        return q, s

    # Rank i starts with its own chunk i; after hop s it holds the partial
    # sum of chunk (i - s - 1) mod w, after w - 1 hops the whole sum of
    # chunk (i + 1) mod w.
    q, s = quant(chunks[idx])
    for step in range(w - 1):
        rq, rs = torch.empty_like(q), torch.empty_like(s)
        exchange(q, rq, group, dst=right, src=left)
        exchange(s, rs, group, dst=right, src=left)
        local = chunks[(idx - step - 1) % w]
        q, s = quant((rq.float() * rs).reshape(-1) + local)
    qg, _ = _gather(q, group)
    sg, _ = _gather(s, group)
    # Source j holds chunk (j + 1) mod w: a roll of 1 restores flat order.
    ordered = torch.roll(qg.float() * sg, 1, dims=0)
    mean = ordered.reshape(-1)[:n] / w
    return mean.reshape(shape).to(dtype)


def mean_int8_wire(x, group, block=_INT8_BLOCK):
    """Mean of ``x`` over ``group`` through the blockwise int8 wire: the
    all-gather transport up to ``_INT8_MAX_AXIS`` ranks, the requantizing
    ring beyond (a new tensor of ``x``'s dtype)."""
    return _int8_start(x, group, block).wait()


def _int8_start(x, group, block=_INT8_BLOCK, async_op=False):
    if int8_transport(dist.get_world_size(group)) == "ring":
        out = _ring_int8_mean(x, group, block)
        return Pending([], lambda: out)
    q, scale, pad = _int8_quantize(x.reshape(-1), block)
    return _int8_allgather_start(q, scale, pad, x.shape, x.dtype, group,
                                 async_op)


def start_mean(x, group, kind, async_op=False):
    """Issue the mean of ``x`` over ``group`` through the stateless wire of
    compressor ``kind`` (``NoneCompressor``, ``HorovodCompressor``,
    ``Int8Compressor``); returns a :class:`Pending` whose ``wait()`` gives
    the mean (``x`` itself, reduced in place, for ``NoneCompressor``)."""
    if kind == _C.HorovodCompressor:
        return _bf16_start(x, group, async_op)
    if kind == _C.Int8Compressor:
        return _int8_start(x, group, async_op=async_op)
    n = dist.get_world_size(group)
    work = dist.all_reduce(x, group=group, async_op=async_op)
    return Pending([work], lambda: x.div_(n))


class Compressor(ABC):
    """Wraps the mean all-reduce of one gradient over a process group."""

    def __init__(self, var_name=""):
        self.var_name = var_name

    def init_state(self, shape, dtype, device=None):
        """This rank's compressor state for one variable (default: none)."""
        return ()

    @abstractmethod
    def reduce(self, grad, state, group):
        """Return (mean-reduced gradient, new state)."""

    @staticmethod
    def create(kind, var_name=""):
        """Name/enum-based factory."""
        if isinstance(kind, str):
            kind = _C.Value(kind)
        return {_C.NoneCompressor: NoneCompressor,
                _C.HorovodCompressor: HorovodCompressor,
                _C.HorovodCompressorEF: HorovodCompressorEF,
                _C.PowerSGDCompressor: PowerSGDCompressor,
                _C.Int8Compressor: Int8Compressor,
                _C.Int8CompressorEF: Int8CompressorEF}[kind](var_name)


class NoneCompressor(Compressor):
    """Identity wire format: a plain mean all-reduce, in place."""

    def reduce(self, grad, state, group):
        return all_reduce_mean_(grad, group), state


class HorovodCompressor(Compressor):
    """Half-width wire format: a bfloat16 wire, accumulated back in the
    gradient's dtype."""

    def reduce(self, grad, state, group):
        return mean_bf16_wire(grad, group), state


def _bf16_ef(grad, state, group):
    corrected = grad + state
    residual = corrected - corrected.to(torch.bfloat16).to(grad.dtype)
    return mean_bf16_wire(corrected, group), residual


class HorovodCompressorEF(Compressor):
    """bfloat16 wire + error feedback: the quantization error is carried
    forward and re-injected at the next step."""

    def init_state(self, shape, dtype, device=None):
        return torch.zeros(shape, dtype=dtype, device=device)

    def reduce(self, grad, state, group):
        return _bf16_ef(grad, state, group)


class Int8Compressor(Compressor):
    """Blockwise-scaled int8 wire format (stateless; fusable)."""

    def reduce(self, grad, state, group):
        return mean_int8_wire(grad, group), state


class Int8CompressorEF(Compressor):
    """int8 wire + error feedback. The residual is computed from the same
    (q, scale) tensors that go on the wire, so send and correction cannot
    drift apart."""

    def init_state(self, shape, dtype, device=None):
        return torch.zeros(shape, dtype=dtype, device=device)

    def reduce(self, grad, state, group):
        if int8_transport(dist.get_world_size(group)) == "ring":
            # Wide groups: bfloat16 wire + EF, not the requantizing ring,
            # whose noise no single rank can observe or carry forward.
            return _bf16_ef(grad, state, group)
        corrected = grad + state
        q, scale, pad = _int8_quantize(corrected.reshape(-1))
        deq = (q.float() * scale).reshape(-1)
        if pad:
            deq = deq[:-pad]
        residual = corrected - deq.reshape(grad.shape).to(grad.dtype)
        reduced = _int8_allgather_mean(q, scale, pad, grad.shape, grad.dtype,
                                       group)
        return reduced, residual


def name_seed(var_name):
    """The PowerSGD ``Q`` seed of a variable: its name's md5 (Python's
    ``hash`` is salted per process), the same on every rank."""
    return int(hashlib.md5(var_name.encode()).hexdigest()[:8], 16)


class PowerSGDCompressor(Compressor):
    """Rank-r PowerSGD (arXiv:1905.13727) with error feedback.

    The gradient is viewed as a matrix M (dim 0 x the rest); its all-reduce
    is replaced by all-reduces of the rank-r factors ``P = M Q`` and
    ``Q' = M^T P-hat``: r (m + n) words on the wire instead of m n."""

    def __init__(self, var_name="", rank=2):
        super().__init__(var_name)
        self.rank = rank

    @staticmethod
    def _matrix_shape(shape):
        if len(shape) < 2:
            return None
        n = 1
        for d in shape[1:]:
            n *= int(d)
        return int(shape[0]), n

    def init_state(self, shape, dtype, device=None):
        mn = self._matrix_shape(shape)
        if mn is None:  # vectors and scalars reduce uncompressed
            return ()
        m, n = mn
        gen = torch.Generator(device="cpu")
        gen.manual_seed(name_seed(self.var_name))
        q = torch.randn((n, self.rank), generator=gen, dtype=torch.float32)
        return {"q": q.to(device),
                "residual": torch.zeros(shape, dtype=dtype, device=device)}

    @staticmethod
    def _orthogonalize(p):
        """Orthonormal columns spanning ``p``'s: Gram-Schmidt column by
        column, each projection done twice, so a column that ``p``'s others
        nearly span (a rank-deficient ``p``, as a matrix with fewer columns
        than the rank gives) comes out orthogonal to them, as Householder
        QR's does; a column with nothing left is zero, so ``P-hat Q'^T``
        stays finite."""
        cols = []
        for j in range(p.shape[1]):
            v = p[:, j]
            for _ in range(2):
                for u in cols:
                    v = v - (u @ v) * u
            norm = torch.linalg.vector_norm(v)
            inv = torch.where(norm > 0, 1.0 / norm, torch.zeros_like(norm))
            cols.append(v * inv)
        return torch.stack(cols, dim=1)

    def reduce(self, grad, state, group):
        mn = self._matrix_shape(grad.shape)
        if mn is None:
            return all_reduce_mean_(grad, group), state
        m, n = mn
        matrix = (grad + state["residual"]).reshape(m, n).float()
        p = all_reduce_mean_(matrix @ state["q"], group)          # (m, r)
        p_hat = self._orthogonalize(p)
        q = all_reduce_mean_(matrix.t() @ p_hat, group)           # (n, r)
        approx = (p_hat @ q.t()).to(grad.dtype)                   # (m, n)
        residual = (matrix - approx.float()).reshape(grad.shape).to(
            grad.dtype)
        return approx.reshape(grad.shape), {"q": q, "residual": residual}
