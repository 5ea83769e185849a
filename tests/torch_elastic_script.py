"""Elastic shrink-resume on the port, on the CPU (gloo): a two-process
``launch: local`` linreg job loses its worker and, under
``AUTODIST_SUPERVISION=elastic``, re-forms at world size 1 in the SAME
process (the chief re-execs this script), reshard-restores from the
checkpoint manifest and finishes.

Three roles, one script (the Coordinator re-runs the same command line for
the worker and for the re-exec'd generation):

* generation 0 (``crash_step`` given, no ``AUTODIST_ELASTIC_WORLD``): two
  processes train through ``CheckpointManager.run(coordinator=...)`` with a
  save every step, each on its half of the rows; ``AUTODIST_CHAOS=
  kill_at=<crash>:1`` hard-exits the worker after step ``crash``. The
  chief's ElasticPolicy re-execs this script with ``AUTODIST_ELASTIC_WORLD=1``;
* generation 1 (``AUTODIST_ELASTIC_WORLD`` set): the spec shrinks to one
  process, ``restore_or_init`` sees the manifest's world change (2 -> 1
  processes) and reshards, the run finishes on the whole batch with no
  further save, and the final params are written;
* control (no ``crash_step``): a clean one-process resume from the same
  checkpoint directory (its own spec), the same steps.

Usage: torch_elastic_script.py spec.yml ckpt_dir total_steps out.npz
       [crash_step]
"""
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from autodist_tpu_torch import AutoDist, resilience  # noqa: E402
from autodist_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from autodist_tpu_torch.checkpoint.manifest import state_tree  # noqa: E402
from autodist_tpu_torch.strategy import AllReduce  # noqa: E402
from autodist_tpu_torch.utils.tree import (flatten_with_path,  # noqa: E402
                                           path_to_name)

ROWS = 64


def data():
    rng = np.random.RandomState(7)
    return (rng.randn(ROWS, 8).astype(np.float32),
            rng.randn(ROWS, 1).astype(np.float32))


def loss_fn(params, batch):
    x, y = batch
    pred = x @ params["w"] + params["b"]
    return torch.mean((pred - y) ** 2)


def main():
    spec_file, ckpt_dir, total, out_file = sys.argv[1:5]
    total = int(total)
    crash = int(sys.argv[5]) if len(sys.argv) > 5 else None
    resumed = bool(int(os.environ.get("AUTODIST_ELASTIC_WORLD", "0") or 0))

    ad = AutoDist(resource_spec_file=spec_file, strategy_builder=AllReduce(),
                  device="cpu")
    x, y = data()
    params = {"w": torch.zeros(8, 1), "b": torch.zeros(1)}
    item = ad.capture(loss_fn, params,
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=(x, y))
    runner = ad.create_distributed_session(item)
    rank, world = dist.get_rank(), dist.get_world_size()
    print(f"GENERATION world={world} rank={rank} chief={ad.is_chief}",
          flush=True)

    if resumed or crash is None:
        assert world == 1, f"the continuation runs on one process: {world}"
        mgr = CheckpointManager(runner, ckpt_dir, save_interval_steps=10 ** 9)
        state = mgr.restore_or_init()
        start = int(state.step)
        assert start > 0, "the continuation resumes from a checkpoint"
        kinds = {k for _, k, _ in resilience.events()}
        assert "reshard" in kinds, f"2 -> 1 did not reshard: {sorted(kinds)}"
        whole = (torch.from_numpy(x), torch.from_numpy(y))
        state, _ = mgr.run(state, iter(lambda: whole, None), total)
        arrays = {"step": np.asarray(start)}
        logical = state_tree(runner.to_logical(state))["params"]
        for path, leaf in flatten_with_path(logical)[0]:
            arrays[path_to_name(path)] = leaf.detach().numpy()
        np.savez(out_file, **arrays)
        print(f"ELASTIC_OK resumed_from={start} final_step={int(state.step)} "
              f"events={','.join(sorted(kinds))}", flush=True)
        mgr.close()
        return 0

    mgr = CheckpointManager(runner, ckpt_dir, save_interval_steps=1)
    state = mgr.restore_or_init()
    assert int(state.step) == 0, "generation 0 starts fresh"
    per = ROWS // world
    mine = (torch.from_numpy(x[rank * per:(rank + 1) * per]),
            torch.from_numpy(y[rank * per:(rank + 1) * per]))
    mgr.run(state, iter(lambda: mine, None), total,
            coordinator=ad.coordinator)
    # Neither process gets here: the worker hard-exits at the crash step
    # and the chief is replaced by its re-exec.
    print(f"ELASTIC_UNEXPECTED_COMPLETION rank={rank}", flush=True)
    return 3


if __name__ == "__main__":
    sys.exit(main())
