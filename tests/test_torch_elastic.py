"""The port's elastic shrink-resume and its stitched goodput ledger
against the JAX package.

* ``stitch_run`` / ``priced_downtime`` / ``reexec_env`` over the same
  segment files equal the JAX functions (rel 1e-9; the generation lists,
  gaps and episode lists exactly); a directory without generation 1 does
  not read as stitched;
* the report's stitched goodput fragment equals JAX ``_render_goodput``'s
  over the same segment files (exactly), and so does the monitor's
  ``/status`` run identity and stitched section;
* the single-process drain flow with a stubbed exec (the JAX
  ``test_elastic_supervision_survives_worker_kill``) on BERT-tiny: a
  chaos-killed worker process requests a re-form, the checkpointed loop
  drains through an emergency save and "re-execs", and the next generation
  restores with a reshard (the emergency step's manifest is rewritten as
  if two ranks had saved it: one process cannot shrink its own world) and
  trains on, every stage in the event trail and the report;
* the stitched-ledger flow (the JAX ``test_elastic_stitched_goodput_
  ledger``) at ``unroll`` 1 and 4, with the JAX test's assertions;
* the whole slice: a ``launch: local`` two-process gloo linreg
  (``tests/torch_elastic_script.py``) loses its worker at step 3, the
  chief re-execs for real at world size 1 and resumes from step 2 with a
  reshard; its params are bitwise its control arm's (a clean one-process
  resume from the same checkpoints) and within rtol 1e-6 of the JAX
  package's one-process run of the same steps on the full batch (the same
  zero initial weights, SGD 0.1); the stitched ledger of the real run has
  generations [0, 1], a priced gap and reshard, and both generations'
  steps (3 + 4: step 3 ran in generation 0 and again from the step-2
  checkpoint).
"""
import copy
import functools
import json
import os
import re
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from autodist_tpu import const as jconst
from autodist_tpu import observability as jobs
from autodist_tpu import report as jreport
from autodist_tpu.observability import goodput as jgoodput
from autodist_tpu.observability import monitor as jmonitor
from autodist_tpu_torch import AutoDist, const, observability, report
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch import resilience
from autodist_tpu_torch.checkpoint import CheckpointManager
from autodist_tpu_torch.coordinator import Coordinator
from autodist_tpu_torch.models import bert
from autodist_tpu_torch.observability import goodput, monitor
from autodist_tpu_torch.resilience import ElasticPolicy, ElasticReform, chaos
from autodist_tpu_torch.strategy import AllReduce

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
ELASTIC_SCRIPT = os.path.join(TESTS, "torch_elastic_script.py")
SUBPROCESS_TIMEOUT_S = 300
REL = 1e-9


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    for name in ("AUTODIST_TELEMETRY", "AUTODIST_TRACE", "AUTODIST_RUN_ID",
                 "AUTODIST_RUN_GENERATION", "AUTODIST_PEAK_TFLOPS",
                 "AUTODIST_CHAOS", "AUTODIST_SUPERVISION",
                 "AUTODIST_ELASTIC_WORLD", "AUTODIST_DUMP_GRAPHS",
                 "AUTODIST_MONITOR_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AUTODIST_TUNER_CALIBRATION", str(tmp_path / "cal.json"))
    for mod in (const, jconst):
        monkeypatch.setattr(mod, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
        monkeypatch.setattr(mod, "DEFAULT_TRACE_DIR", str(tmp_path / "traces"))
        monkeypatch.setattr(mod, "DEFAULT_GRAPH_DUMP_DIR",
                            str(tmp_path / "graphs"))
    autodist_mod._reset_default()
    resilience.clear_events()
    chaos.reset()
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    yield
    for o in (observability, jobs):
        o.refresh()
        o.reset()
    resilience.clear_events()
    chaos.reset()
    autodist_mod._reset_default()


def _close(got, want, path="$"):
    """Recursive equality, floats at ``REL``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert got == pytest.approx(want, rel=REL, abs=0), path
    else:
        assert got == want, path


# -- the stitcher over the same segment files ---------------------------------

def _segment(gen, start, wall_ms, steps, reason=None, switches=0, seed=0):
    rng = np.random.RandomState(seed + gen)
    classes = {k: float(round(rng.uniform(0, 300), 3))
               for k in goodput.BADPUT_CLASSES}
    classes["reexec_gap_ms"] = classes["selfheal_ms"] = 0.0
    goodput_ms = float(round(wall_ms - sum(classes.values()), 3))
    seg = {"run_id": "stitch-run", "generation": gen, "pid": 100 + gen,
           "start": start, "end": round(start + wall_ms / 1e3, 3),
           "wall_ms": wall_ms, "goodput_ms": goodput_ms,
           "goodput_pct": round(100 * goodput_ms / wall_ms, 2),
           "classes": classes, "steps": steps, "dispatches": steps,
           "retune_switches": switches, "flops_per_step": 3.0e9,
           "model_flops": 3.0e9 * steps, "devices": 2 - min(gen, 1),
           "peak_tflops_per_device": 0.05,
           "peak_flops_total": 0.05e12 * (2 - min(gen, 1)),
           "mfu": 0.01, "hfu": 0.02}
    if reason:
        seg["end_reason"] = reason
    return seg


SEGMENT_SETS = {
    "two": [_segment(0, 1000.0, 5000.0, 3, "re-exec"),
            _segment(1, 1009.25, 4000.0, 6)],
    "selfheal": [_segment(0, 1000.0, 5000.0, 3, "re-exec", switches=2),
                 _segment(1, 1007.5, 3000.0, 4, "selfheal", switches=1),
                 _segment(2, 1012.0, 2500.0, 5)],
    "one": [_segment(0, 1000.0, 5000.0, 3)],
}


def _write_segments(log_dir, segs, other_run=True):
    os.makedirs(log_dir, exist_ok=True)
    for seg in segs:
        with open(os.path.join(
                log_dir, f"goodput_{seg['run_id']}_g{seg['generation']}"
                         f".json"), "w") as f:
            json.dump(seg, f)
    if other_run:  # another run's segment in the same directory
        seg = dict(segs[0], run_id="another-run", generation=7)
        with open(os.path.join(log_dir, "goodput_another-run_g7.json"),
                  "w") as f:
            json.dump(seg, f)


@pytest.mark.parametrize("name", sorted(SEGMENT_SETS))
def test_stitch_and_prices_match_jax(tmp_path, name):
    logs = str(tmp_path / "seglogs")
    _write_segments(logs, SEGMENT_SETS[name])
    got = goodput.stitch_run("stitch-run", logs)
    want = jgoodput.stitch_run("stitch-run", logs)
    _close(got, want)
    _close(goodput.priced_downtime("stitch-run", logs),
           jgoodput.priced_downtime("stitch-run", logs))
    assert goodput.stitch_run("no-such-run", logs) is None
    if name == "one":  # the planted fault: no generation 1, no stitch
        assert got["generations"] == [0] and got["reexec_gaps_ms"] == []
    else:
        assert got["generations"] == list(range(len(SEGMENT_SETS[name])))
        assert got["classes"]["reexec_gap_ms"] > 0


def test_reexec_env_matches_jax(monkeypatch):
    monkeypatch.setenv("AUTODIST_RUN_ID", "run-x")
    monkeypatch.setenv("AUTODIST_RUN_GENERATION", "4")
    assert goodput.reexec_env() == jgoodput.reexec_env() == {
        "AUTODIST_RUN_ID": "run-x", "AUTODIST_RUN_GENERATION": "5"}
    monkeypatch.delenv("AUTODIST_RUN_ID")
    monkeypatch.delenv("AUTODIST_RUN_GENERATION")
    assert goodput.reexec_env()["AUTODIST_RUN_GENERATION"] == "1"
    assert goodput.reexec_env()["AUTODIST_RUN_ID"] == goodput.run_id()


@pytest.mark.parametrize("name", sorted(SEGMENT_SETS))
def test_stitched_report_and_status_match_jax(tmp_path, monkeypatch, name):
    segs = SEGMENT_SETS[name]
    _write_segments(str(tmp_path / "logs"), segs)
    monkeypatch.setenv("AUTODIST_RUN_ID", "stitch-run")
    monkeypatch.setenv("AUTODIST_RUN_GENERATION",
                       str(segs[-1]["generation"]))
    goodput.set_last_summary(copy.deepcopy(segs[-1]))
    jgoodput.set_last_summary(copy.deepcopy(segs[-1]))
    page = report._render_goodput()
    assert page == jreport._render_goodput()
    assert ("stitched across generations" in page) == (len(segs) > 1)
    assert ('title="re-exec gap' in page) == (len(segs) > 1)
    monkeypatch.setattr(monitor, "_snapshots", lambda: [])
    monkeypatch.setattr(jmonitor, "_snapshots", lambda: [])
    doc, jdoc = monitor.status(), jmonitor.status()
    assert doc["run"] == jdoc["run"]
    _close(doc["goodput"], jdoc["goodput"])
    assert ("stitched" in doc["goodput"]) == (len(segs) > 1)


# -- the drain flow on BERT-tiny (one process, stubbed exec) ------------------

def _bert_runner():
    params, loss_fn, batch = bert.tiny_fixture(seed=0, device="cpu")
    autodist_mod._reset_default()
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    item = ad.capture(loss_fn, params,
                      functools.partial(torch.optim.Adam, lr=1e-3),
                      example_batch=batch)
    return ad.create_distributed_session(item), batch


def _batches(runner, batch):
    dbatch = runner.remapper.shard_batch(batch)
    return iter(lambda: dbatch, None)


def _as_saved_by_two_ranks(directory, step):
    """Rewrite step ``step``'s manifest as two ranks of one device each
    would have written it (the state is whole on each rank under
    AllReduce): the next restore then takes the cross-shape path."""
    path = os.path.join(str(directory), f"manifest-{step}.json")
    with open(path) as f:
        man = json.load(f)
    man["world"].update(processes=2, devices=2, data_axis=2,
                        mesh={"data": 2})
    with open(path, "w") as f:
        json.dump(man, f)


def _kill_a_worker(co):
    """A real launched process dies through the chaos kill-worker fault;
    returns once the coordinator's policy requested the re-form."""
    script = ("import os, sys; sys.path.insert(0, sys.argv[1]); "
              "os.environ['AUTODIST_CHAOS'] = 'kill_worker=1'; "
              "from autodist_tpu_torch.resilience import chaos; "
              "chaos.maybe_kill(1, process_index=1)")
    proc = subprocess.Popen([sys.executable, "-c", script, ROOT],
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    co._procs.append(proc)
    co._proc_wait_async(proc, 1)
    deadline = time.monotonic() + SUBPROCESS_TIMEOUT_S
    while time.monotonic() < deadline and not co.reform_pending:
        time.sleep(0.05)
    assert proc.wait(timeout=SUBPROCESS_TIMEOUT_S) == 9


def test_elastic_supervision_survives_worker_kill(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTODIST_SUPERVISION", "elastic")
    runner, batch = _bert_runner()
    mgr = CheckpointManager(runner, tmp_path / "ckpt",
                            save_interval_steps=100)  # only the emergency
    state = mgr.restore_or_init()                     # save can save
    co = Coordinator(None, None)
    assert isinstance(co.supervision, ElasticPolicy)
    execs = []
    co._exec = lambda *a: execs.append(a)
    co._world_size = 2
    _kill_a_worker(co)
    assert co.reform_pending, "worker death did not request a re-form"

    with pytest.raises(ElasticReform) as excinfo:
        mgr.run(state, _batches(runner, batch), num_steps=50,
                coordinator=co)
    assert excinfo.value.new_world == 1 and excinfo.value.step == 1
    assert mgr.latest_step() == excinfo.value.step  # the emergency save
    assert execs and execs[0][2]["AUTODIST_ELASTIC_WORLD"] == "1"
    mgr.close()

    _as_saved_by_two_ranks(tmp_path / "ckpt", excinfo.value.step)
    runner2, batch = _bert_runner()
    mgr2 = CheckpointManager(runner2, tmp_path / "ckpt",
                             save_interval_steps=1)
    state2 = mgr2.restore_or_init()
    assert int(state2.step) == excinfo.value.step
    target = excinfo.value.step + 2
    state2, metrics = mgr2.run(state2, _batches(runner2, batch),
                               num_steps=target)
    assert int(state2.step) == target
    assert np.isfinite(float(metrics["loss"]))
    kinds = {k for _, k, _ in resilience.events()}
    for kind in ("worker-death", "re-form-request", "emergency-save",
                 "re-form", "reshard"):
        assert kind in kinds, f"missing {kind} in {sorted(kinds)}"
    path = report.render_report(runner2.program,
                                out_path=str(tmp_path / "r.html"))
    text = open(path).read()
    for needle in ("re-form", "emergency-save", "reshard"):
        assert needle in text
    mgr2.close()


@pytest.mark.parametrize("unroll", [1, 4])
def test_elastic_stitched_goodput_ledger(tmp_path, monkeypatch, unroll):
    monkeypatch.setenv("AUTODIST_SUPERVISION", "elastic")
    monkeypatch.setenv("AUTODIST_RUN_ID", f"stitch-u{unroll}")
    # -- generation 0: train, lose a worker, drain, "re-exec" ---------------
    runner, batch = _bert_runner()
    mgr = CheckpointManager(runner, tmp_path / "ckpt",
                            save_interval_steps=100)
    state = mgr.restore_or_init()
    co = Coordinator(None, None)
    execs = []
    co._exec = lambda *a: execs.append(a)
    co._world_size = 2
    co.supervision.on_worker_death(co, 1, SimpleNamespace(pid=999), 9)
    assert co.reform_pending
    with pytest.raises(ElasticReform) as excinfo:
        mgr.run(state, _batches(runner, batch), num_steps=48,
                coordinator=co, unroll=unroll)
    mgr.close()
    (_exe, _argv, env), = execs
    assert env["AUTODIST_RUN_ID"] == f"stitch-u{unroll}"
    assert env["AUTODIST_RUN_GENERATION"] == "1"
    segs = goodput.segments_for()
    assert [s["generation"] for s in segs] == [0]
    assert segs[0]["steps"] == excinfo.value.step > 0
    assert segs[0]["end_reason"] == "re-exec"

    # -- generation 1: a fresh process (simulated), reshard, continue ------
    time.sleep(0.05)  # the re-exec dead time the stitcher must price
    monkeypatch.setenv("AUTODIST_RUN_GENERATION", "1")
    observability.reset()
    _as_saved_by_two_ranks(tmp_path / "ckpt", excinfo.value.step)
    runner2, batch = _bert_runner()
    mgr2 = CheckpointManager(runner2, tmp_path / "ckpt",
                             save_interval_steps=100)
    state2 = mgr2.restore_or_init()
    start = int(state2.step)
    assert start == excinfo.value.step
    target = ((start + 8 + unroll - 1) // unroll) * unroll
    state2, metrics = mgr2.run(state2, _batches(runner2, batch),
                               num_steps=target, unroll=unroll)
    mgr2.close()
    assert np.all(np.isfinite(metrics["loss"].detach().numpy()))

    st = goodput.stitch_run()
    assert st is not None and st["generations"] == [0, 1]
    assert all(s["goodput_ms"] > 0 for s in st["segments"])
    assert st["classes"]["reexec_gap_ms"] > 10
    assert st["classes"]["reshard_ms"] > 0
    assert st["steps"] == target
    total = st["goodput_ms"] + sum(st["classes"].values())
    assert total == pytest.approx(st["wall_ms"], rel=0.05, abs=1.0)
    assert st["mfu"] is not None and 0 < st["mfu"] <= 1
    _close(st, jgoodput.stitch_run(st["run_id"], const.DEFAULT_LOG_DIR))
    path = report.render_report(runner2.program,
                                out_path=str(tmp_path / "r.html"))
    text = open(path).read()
    assert "Run goodput" in text
    assert "stitched across generations" in text
    assert 'title="re-exec gap' in text, [
        (g["generation"], g["wall_ms"], g["goodput_ms"], g["classes"])
        for g in st["segments"]]


# -- the whole slice: a real two-process job loses its worker ----------------

TOTAL, CRASH = 6, 3

ELASTIC_SPEC = """
launch: local
coordinator: "127.0.0.1:{port}"
nodes:
  - address: proc0
    chief: true
    cpus: [0]
  - address: proc1
    cpus: [0]
"""

CONTROL_SPEC = """
nodes:
  - address: proc0
    chief: true
    cpus: [0]
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_script(tmp_path, spec_text, args, env_extra, name):
    for _ in range(2):  # a free port can be taken before it binds
        spec = tmp_path / f"{name}.yml"
        spec.write_text(spec_text.format(port=_free_port()))
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("AUTODIST_", "RANK", "WORLD_SIZE",
                                    "MASTER_", "LOCAL_RANK"))}
        env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   AUTODIST_WORKING_DIR=str(tmp_path / f"wd-{name}"),
                   **env_extra)
        proc = subprocess.run([sys.executable, ELASTIC_SCRIPT, str(spec)]
                              + [str(a) for a in args], env=env, cwd=ROOT,
                              capture_output=True, text=True,
                              timeout=SUBPROCESS_TIMEOUT_S)
        if proc.returncode == 0 or "ddress already in use" not in \
                proc.stderr:
            break
    assert proc.returncode == 0, \
        f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-3000:]}"
    return proc


def _jax_one_process():
    """The JAX package's one-process run on one device: the same linreg,
    zero weights, SGD 0.1, ``TOTAL`` steps on the full batch."""
    import jax
    import jax.numpy as jnp
    import optax
    from autodist_tpu import AutoDist as JAutoDist
    from autodist_tpu import autodist as jautodist_mod
    from autodist_tpu.strategy import AllReduce as JAllReduce
    from autodist_tpu_torch import convert
    sys.path.insert(0, TESTS)
    try:
        from torch_elastic_script import data
    finally:
        sys.path.remove(TESTS)
    x, y = data()

    def loss_fn(params, batch):
        bx, by = batch
        return jnp.mean((bx @ params["w"] + params["b"] - by) ** 2)
    init = {"w": np.zeros((8, 1), np.float32), "b": np.zeros((1,),
                                                            np.float32)}
    # The port's initial weights, carried to the JAX package as the port
    # would carry them back.
    assert all(np.array_equal(v.numpy(), init[k]) for k, v in
               convert.params_from_jax(init, "cpu").items())
    jautodist_mod._reset_default()
    try:
        ad = JAutoDist(strategy_builder=JAllReduce(),
                       devices=jax.devices()[:1], mesh_axes={"data": 1})
        runner = ad.create_distributed_session(ad.capture(
            loss_fn, jax.tree_util.tree_map(jnp.asarray, init),
            optax.sgd(0.1), example_batch=(x, y)))
        state = runner.create_state()
        for _ in range(TOTAL):
            state, _ = runner.step(state, (x, y))
        return {k: np.asarray(v) for k, v in
                jax.device_get(runner.logical_params(state)).items()}
    finally:
        jautodist_mod._reset_default()


def test_two_process_job_loses_its_worker_and_resumes(tmp_path):
    ckpt = tmp_path / "ckpt"
    elastic, control = tmp_path / "elastic.npz", tmp_path / "control.npz"
    p1 = _run_script(tmp_path, ELASTIC_SPEC,
                     [ckpt, TOTAL, elastic, CRASH],
                     {"AUTODIST_SUPERVISION": "elastic",
                      "AUTODIST_CHAOS": f"kill_at={CRASH}:1",
                      "AUTODIST_RUN_ID": "elastic-cpu"}, "elastic")
    assert "ELASTIC_UNEXPECTED_COMPLETION" not in p1.stdout
    # The chief and its worker share the pipe: their lines may interleave.
    gens = re.findall(r"GENERATION world=\d rank=\d chief=(?:True|False)",
                      p1.stdout)
    assert sorted(gens[:2]) == ["GENERATION world=2 rank=0 chief=True",
                                "GENERATION world=2 rank=1 chief=False"]
    assert gens[2:] == ["GENERATION world=1 rank=0 chief=True"]
    (ok,) = re.findall(r"ELASTIC_OK[^\n]*", p1.stdout)
    assert f"resumed_from={CRASH - 1} final_step={TOTAL}" in ok
    assert "reshard" in ok and "spec-shrink" in ok
    assert "worker 1 exited with code 9; elastic shrink 2 -> 1" in p1.stderr

    p2 = _run_script(tmp_path, CONTROL_SPEC, [ckpt, TOTAL, control], {},
                     "control")
    assert f"resumed_from={CRASH - 1}" in p2.stdout
    a, b = np.load(elastic), np.load(control)
    assert set(a.files) == set(b.files) == {"step", "w", "b"}
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    want = _jax_one_process()
    for name, w in want.items():
        np.testing.assert_allclose(a[name], w, rtol=1e-6, atol=0,
                                   err_msg=name)

    logs = str(tmp_path / "wd-elastic" / "logs")
    st = goodput.stitch_run("elastic-cpu", logs)
    assert st["generations"] == [0, 1]
    assert st["reexec_gaps_ms"][0] > 0 and st["classes"]["reshard_ms"] > 0
    assert [s["steps"] for s in st["segments"]] == [CRASH,
                                                    TOTAL - CRASH + 1]
    assert st["segments"][0]["end_reason"] == "re-exec"
    total = st["goodput_ms"] + sum(st["classes"].values())
    assert total == pytest.approx(st["wall_ms"], rel=0.05, abs=1.0)
    _close(st, jgoodput.stitch_run("elastic-cpu", logs))
    traces = os.listdir(tmp_path / "wd-elastic" / "traces")
    assert any(t.endswith("_g0.json") for t in traces), traces


def test_checkpoint_and_exit_saves_alone_after_a_worker_death(tmp_path):
    """checkpoint-and-exit on a real two-process world: the worker dies
    after step 3; the chief's step-3 save meets the dead peer at its
    barrier, so the chief writes step 3 alone (the state is whole on each
    rank under AllReduce: no collective, no barrier), records it and
    exits nonzero; a one-process resume then starts from step 3."""
    ckpt = tmp_path / "ckpt"
    spec = tmp_path / "exit.yml"
    spec.write_text(ELASTIC_SPEC.format(port=_free_port()))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("AUTODIST_", "RANK", "WORLD_SIZE",
                                "MASTER_", "LOCAL_RANK"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               AUTODIST_WORKING_DIR=str(tmp_path / "wd-exit"),
               AUTODIST_SUPERVISION="checkpoint-and-exit",
               AUTODIST_CHAOS=f"kill_at={CRASH}:1")
    proc = subprocess.run([sys.executable, ELASTIC_SCRIPT, str(spec),
                           str(ckpt), str(TOTAL),
                           str(tmp_path / "exit.npz"), str(CRASH)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=SUBPROCESS_TIMEOUT_S)
    assert proc.returncode == 1, \
        f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-3000:]}"
    assert "checkpoint-and-exit supervision); emergency checkpoint at " \
        f"step {CRASH} (latest retained: {CRASH})" in proc.stderr
    assert "ELASTIC_UNEXPECTED_COMPLETION" not in proc.stdout
    events = [json.loads(line) for path in
              (tmp_path / "wd-exit" / "logs").glob("flight_*.jsonl")
              for line in open(path)]
    assert any(e["kind"] == "emergency-save" and "written alone" in
               e["detail"] for e in events), events
    control = tmp_path / "control.npz"
    p2 = _run_script(tmp_path, CONTROL_SPEC, [ckpt, TOTAL, control], {},
                     "control")
    assert f"resumed_from={CRASH} final_step={TOTAL}" in p2.stdout
