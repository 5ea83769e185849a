#!/usr/bin/env python
"""Repeat chip_smoke's phase 9 (f), the BERT-base graph step around an
asynchronous checkpoint save, with the host parts of each save timed.

``CheckpointManager.save`` stages the state into pinned host memory and
returns; this probe runs ``chip_smoke.save_stall`` ``--repeats`` times on
one fresh BERT-base runner and prints, per repeat, the second save's
figures (the first allocates the staging buffer) and the milliseconds
spent in ``saver._logical_tree``, ``saver._stage``,
``manifest.build_manifest`` and ``wait_until_finished``, call by call (a
repeat's third ``_stage`` is the synchronous ``Saver.save`` beside it).
Needs one CUDA card; run from the repository root:

    python3 scripts/save_stall_probe.py [--repeats 3]
"""
import argparse
import functools
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from autodist_tpu_torch.checkpoint import manifest as manifest_mod  # noqa: E402
from autodist_tpu_torch.checkpoint import saver as saver_mod  # noqa: E402
from autodist_tpu_torch.models import bert  # noqa: E402
from autodist_tpu_torch.ops import build  # noqa: E402


def _timing(parts, owner, name):
    real = getattr(owner, name)

    @functools.wraps(real)
    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            parts.setdefault(name, []).append(
                round((time.perf_counter() - t) * 1e3, 3))
    setattr(owner, name, timed)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("save_stall_probe: needs a CUDA card")
    card = cs.card_line()
    parts = {}
    for owner, name in ((saver_mod, "_logical_tree"), (saver_mod, "_stage"),
                        (manifest_mod, "build_manifest"),
                        (saver_mod.CheckpointManager, "wait_until_finished")):
        _timing(parts, owner, name)
    cfg = bert.bert_base(max_len=512)
    batches = cs.weighted_batches(cfg, range(cs.RESIL_RESUME_STEPS), 32, 128,
                                  20)
    runner = cs._bert_runner(torch, cfg, "cuda", batches[0])
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        for i in range(args.repeats):
            parts.clear()
            got = cs.save_stall(torch, card, runner, batches, "cuda", tmp)
            second = got["saves"][1]
            print(f"repeat {i}: graph {got['graph_ms']:.3f} ms; save 2 "
                  f"returned in {second['save_ms']:.3f}, stall "
                  f"{second['stall_ms']:.3f}, wait {second['wait_ms']:.3f}; "
                  f"synchronous save {got['sync_save_ms']:.3f}; host parts "
                  f"(ms, call order): {parts} on {card}", flush=True)


if __name__ == "__main__":
    main()
