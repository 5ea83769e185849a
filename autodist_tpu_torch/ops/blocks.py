"""scan_blocks: the block-stack op a strategy can pipeline.

Counterpart of ``autodist_tpu/ops/blocks.py``. A deep stack of homogeneous
blocks is one tree whose leaves carry a leading layer dim L (the stacked
layout, ``TransformerConfig(scan_layers=True)``). ``scan_blocks`` applies
it: on one device a sequential loop over the leading dim (``lax.scan`` in
the JAX package); under the :class:`~autodist_tpu_torch.strategy.Pipeline`
strategy, which splits the stacked variables over the ``pipe`` axis and
records the microbatch count, the same model runs on the pipeline
schedule without the user restructuring anything.

When the active :mod:`~autodist_tpu_torch.parallel.context` carries
``pipeline_microbatches > 0`` and the mesh has a ``pipe`` axis of S > 1
ranks, the rank's L/S contiguous layers are its stage (the leaves arrive
as its pieces, ``parallel.context.stage_pieces``; whole leaves are cut to
them), and ``pipeline/schedule.py`` runs them, each stage applying its
layers in order. Under a seq axis too (``SequenceParallel(base=
Pipeline(...))``) ``x`` is this rank's chunk of the sequence
(``transformer.encode`` cut it) and stays so through the schedule: its
hops go to the next stage's rank of the same chunk, and inside a stage
the blocks' attention runs the ring (or Ulysses) over the rank's seq
group.
"""
from autodist_tpu_torch import const
from autodist_tpu_torch.parallel import context as parallel_context
from autodist_tpu_torch.utils.tree import leaves as tree_leaves
from autodist_tpu_torch.utils.tree import tree_map


def _local_stage(tree, p_size, index):
    """This rank's contiguous ``1/p_size`` of each leaf's leading dim."""
    def cut(leaf):
        n = leaf.shape[0] // p_size
        return leaf.narrow(0, index * n, n)
    return tree_map(cut, tree)


def _layers(stacked, block_fn, x, n):
    for i in range(n):
        x = block_fn(tree_map(lambda l: l[i], stacked), x)
    return x


def scan_blocks(stacked_params, block_fn, x):
    """Apply a stack of homogeneous blocks to ``x``.

    Args:
        stacked_params: tree whose leaves have a leading layer dim L
            (identical L on every leaf), or, under a pipeline, this rank's
            L/S of it.
        block_fn: ``(one_layer_params, activation) -> activation`` with a
            shape-preserving activation.
        x: (batch, ...) activations.
    Returns: (batch, ...) activations after all L blocks.
    """
    leaves = tree_leaves(stacked_params)
    if not leaves:
        return x
    n = leaves[0].shape[0]
    ctx = parallel_context.current()
    if ctx is not None and ctx.pipeline_microbatches and ctx.pipe_size > 1:
        from autodist_tpu_torch.pipeline.schedule import run_stage
        p_size = ctx.pipe_size
        if parallel_context.stage_pieces(leaves) is not None:
            local = stacked_params  # this rank's stage: L/S layers
            num_layers = n * p_size
        else:
            num_layers = n
            if num_layers % p_size != 0:
                raise ValueError(
                    f"Pipeline: {num_layers} stacked layers do not divide "
                    f"into {p_size} stages (the "
                    f"'{const.MESH_AXIS_PIPELINE}' mesh axis size)")
            local = _local_stage(stacked_params, p_size, ctx.pipe_index)
        per_stage = num_layers // p_size

        def stage_fn(stage_params, act):
            # stage_params leaves: (per_stage, ...), applied in order.
            return _layers(stage_params, block_fn, act, per_stage)

        staged = tree_map(lambda l: l.reshape((1, per_stage) +
                                              tuple(l.shape[1:])), local)
        return run_stage(staged, stage_fn, x, ctx.pipeline_microbatches,
                         ctx.mesh, schedule=ctx.pipeline_schedule)
    # One device: the layers in order.
    return _layers(stacked_params, block_fn, x, n)
