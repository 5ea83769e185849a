#!/usr/bin/env python
"""Which exchange gloo takes for CUDA tensors: two gloo ranks on card 0
send each other a CUDA tensor, first with ``all_to_all_single`` whose
splits are zero but to the peer (the ring attention's hop,
``autodist_tpu_torch/parallel/ring_attention.py``), then with P2P
``batch_isend_irecv``. Each rank prints what it received or what was
raised; gloo may abort the process on the P2P exchange instead of
raising, which the exit status shows. Run from anywhere, with one card:

    python3 scripts/gloo_cuda_hop_probe.py [--port 29533]
"""
import argparse
import datetime

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank, port):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=20))
    x = torch.full((4,), float(rank + 1), device="cuda")
    y = torch.zeros_like(x)
    splits = [0, 16] if rank == 0 else [16, 0]
    dist.all_to_all_single(y.view(torch.uint8), x.view(torch.uint8), splits,
                           splits)
    print(f"rank {rank} all_to_all_single (zero splits but the peer): "
          f"received {y.tolist()}", flush=True)
    y.zero_()
    try:
        ops = [dist.P2POp(dist.isend, x, 1 - rank),
               dist.P2POp(dist.irecv, y, 1 - rank)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        print(f"rank {rank} batch_isend_irecv: received {y.tolist()}",
              flush=True)
    except Exception as e:  # noqa: BLE001 - what gloo says is the result
        print(f"rank {rank} batch_isend_irecv raised {type(e).__name__}: "
              f"{str(e)[:300]}", flush=True)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", type=int, default=29533)
    args = ap.parse_args()
    mp.spawn(_rank, args=(args.port,), nprocs=2)


if __name__ == "__main__":
    main()
