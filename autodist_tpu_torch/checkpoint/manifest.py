"""Checkpoint manifest: the layout-independent description of a checkpoint.

Counterpart of ``autodist_tpu/checkpoint/manifest.py``. Every training
checkpoint gets a small versioned JSON sidecar recording what the
checkpoint *is* independently of how the ranks stored it:

* the logical paths, shapes and dtypes of every leaf (``step``, params,
  optimizer state): variable names are '/'-joined tree paths, identical
  however many ranks held the tensors. The params' entries are the JAX
  package's for the same model; the optimizer state is described in
  torch's terms, ``opt_state/<variable path>/<state key>`` (``exp_avg``,
  ``exp_avg_sq``, ``step`` for Adam), where optax's tuple of states sits
  in the JAX manifest;
* the save-time world: process count, device count, data-axis size and
  the mesh's axis sizes;
* a strategy fingerprint (the strategy id) and whether the program needs
  the explicit (sharded-state) gradient path.

``restore_or_init`` reads it to reject a checkpoint whose params do not
match the live model with a clear error, and to route a restore whose
world changed since save time through the cross-shape path. The manifest
never holds array data; losing it degrades to the same-world restore.
"""
import json
import os

import torch
import torch.distributed as dist

from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.tree import flatten_with_path, path_to_name

MANIFEST_VERSION = 1


class ManifestMismatchError(ValueError):
    """The checkpoint's params do not match the live model.

    Deliberately NOT swallowed by ``restore_or_init``'s corruption
    fallback: restoring checkpoint A into model B is a user error that
    must fail loudly, not silently initialize fresh state.
    """


def manifest_name(step):
    return f"manifest-{int(step)}.json"


def sidecar_path(checkpoint_path):
    """Manifest path for a path-addressed (``Saver.save``) checkpoint."""
    return f"{os.path.abspath(str(checkpoint_path))}.manifest.json"


def dtype_name(dtype):
    """numpy's name of a torch or numpy dtype (``float32``, ``bfloat16``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


def leaf_entries(tree):
    """{'/'-joined tree path: {"shape": [...], "dtype": str}} for every
    leaf: the layout-independent inventory."""
    out = {}
    for path, leaf in flatten_with_path(tree)[0]:
        out[path_to_name(path)] = {
            "shape": [int(s) for s in getattr(leaf, "shape", ())],
            "dtype": dtype_name(getattr(leaf, "dtype", "float32")),
        }
    return out


def leaves_by_path(tree):
    """{normalized path: leaf}: dict keys and sequence indices render the
    same way, so a raw read (nested dicts) matches the live tree
    leaf for leaf."""
    return {path_to_name(path): leaf
            for path, leaf in flatten_with_path(tree)[0]}


def state_tree(logical):
    """The tree a logical TrainState is saved as: ``{"step", "params",
    "opt_state"}`` (the JAX TrainState's field names as paths)."""
    return {"step": logical.step, "params": logical.params,
            "opt_state": logical.opt_state}


def live_world(runner):
    """The world ``runner`` runs on, as a manifest records it."""
    mesh = runner.program.mesh
    processes = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "processes": int(processes),
        "devices": int(mesh.size),
        "devices_per_host": max(1, int(mesh.size) // max(1, processes)),
        "data_axis": int(runner.program.data_axis_size),
        "mesh": {str(k): int(v) for k, v in mesh.shape.items()},
    }


def build_manifest(runner, step, logical):
    """The manifest dict for one checkpoint of ``logical`` (the checkpoint
    form, :meth:`Runner.to_logical`) written by ``runner``."""
    strategy = getattr(runner.program, "strategy", None)
    strategy_id = getattr(strategy, "id", None)
    return {
        "manifest_version": MANIFEST_VERSION,
        "step": int(step),
        "world": live_world(runner),
        "strategy": {
            "id": str(strategy_id) if strategy_id else "",
            "explicit_path": bool(runner.program.use_explicit_path),
        },
        "leaves": leaf_entries(state_tree(logical)),
    }


def is_chief():
    return not dist.is_initialized() or dist.get_rank() == 0


def write_manifest(runner, step, path, logical):
    """Write the manifest JSON at ``path`` (chief only; fail-open: a
    read-only filesystem must not kill a save)."""
    if not is_chief():
        return None
    return store_manifest(build_manifest(runner, step, logical), path)


def store_manifest(manifest, path):
    """Write a built manifest dict at ``path`` atomically; fail-open (a
    read-only filesystem must not kill a save): None on an OSError."""
    try:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, path)  # atomic: a torn manifest is never visible
        return path
    except OSError as e:
        logging.warning("could not write checkpoint manifest %s: %s", path, e)
        return None


def read_manifest(path):
    """Read a manifest; ``None`` when absent or unreadable (a checkpoint
    without one restores through the same-world path)."""
    try:
        with open(path) as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) or "leaves" not in man \
            or int(man.get("manifest_version", 0)) < 1:
        logging.warning("ignoring malformed checkpoint manifest %s", path)
        return None
    return man


def params_entries(runner):
    """The live model's ``params/...`` entries (logical shapes)."""
    return leaf_entries({"params": runner.program.graph_item.params})


def validate_manifest(manifest, runner, where=""):
    """Reject a manifest whose *params* paths (or logical shapes) do not
    match the live model, loudly, before any data is read."""
    live = params_entries(runner)
    saved = {name: entry for name, entry in manifest["leaves"].items()
             if name.startswith("params/")}
    missing = sorted(set(live) - set(saved))
    unexpected = sorted(set(saved) - set(live))
    if missing or unexpected:
        raise ManifestMismatchError(
            f"autodist_tpu_torch: checkpoint manifest {where or '(unnamed)'} "
            f"does not match the live model: the model expects param leaves "
            f"the checkpoint lacks {missing[:5]}"
            f"{'...' if len(missing) > 5 else ''}; the checkpoint holds "
            f"leaves the model lacks {unexpected[:5]}"
            f"{'...' if len(unexpected) > 5 else ''}. Restoring a checkpoint "
            f"into a different model is not a resharding problem: point the "
            f"manager at the right checkpoint directory or rebuild the "
            f"matching model.")
    shape_diffs = [
        f"{name}: saved {saved[name]['shape']} vs live {live[name]['shape']}"
        for name in live
        if list(saved[name]["shape"]) != list(live[name]["shape"])]
    if shape_diffs:
        raise ManifestMismatchError(
            f"autodist_tpu_torch: checkpoint manifest "
            f"{where or '(unnamed)'} matches the model's paths but not its "
            f"logical shapes (a changed layer width is a different model, "
            f"not a different world): {shape_diffs[:5]}")


def world_changed(manifest, runner):
    """True when the save-time world differs from the live runner's: the
    trigger for the cross-shape restore."""
    saved, live = manifest.get("world", {}), live_world(runner)
    return any(int(saved.get(k, -1)) != live[k]
               for k in ("data_axis", "devices", "processes"))
