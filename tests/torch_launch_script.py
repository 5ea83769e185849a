"""A launched linreg job on the port, on the CPU (gloo): the chief's
``AutoDist`` starts the workers of a ``launch: local|ssh`` spec (they re-run
this script under the env contract), every process joins the world at the
spec's coordinator, takes ``steps`` SGD steps on its share of the rows, and
writes a marker; the chief writes the final params and waits for its
workers.

Usage: torch_launch_script.py spec.yml steps out.npz
"""
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from autodist_tpu_torch import AutoDist  # noqa: E402
from autodist_tpu_torch import autodist as autodist_mod  # noqa: E402
from autodist_tpu_torch.strategy import AllReduce  # noqa: E402
from torch_elastic_script import ROWS, data, loss_fn  # noqa: E402


def main():
    spec_file, steps, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    ad = AutoDist(resource_spec_file=spec_file, strategy_builder=AllReduce(),
                  device="cpu")
    x, y = data()
    item = ad.capture(loss_fn, {"w": torch.zeros(8, 1), "b": torch.zeros(1)},
                      functools.partial(torch.optim.SGD, lr=0.1),
                      example_batch=(x, y))
    runner = ad.create_distributed_session(item)
    rank, world = dist.get_rank(), dist.get_world_size()
    per = ROWS // world
    mine = (torch.from_numpy(x[rank * per:(rank + 1) * per]),
            torch.from_numpy(y[rank * per:(rank + 1) * per]))
    state = runner.create_state()
    for _ in range(steps):
        state, _ = runner.step(state, mine)
    params = {k: v.detach().numpy()
              for k, v in runner.logical_params(state).items()}
    if rank == 0:
        np.savez(out, **params)
    with open(f"{out}.p{rank}", "w") as f:
        f.write(f"{world} {os.environ.get('AUTODIST_WORKER', '')}\n")
    dist.barrier()
    coordinator = ad.coordinator
    autodist_mod._reset_default()
    if coordinator is not None:
        coordinator.join()
    print(f"LAUNCH_OK rank={rank} world={world}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
