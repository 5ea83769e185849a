"""The port's merged cluster timeline against the JAX package's tool.

``autodist_tpu_torch.tools.timeline`` and ``autodist_tpu.tools.timeline``
read the same per-rank files (``autodist_trace_*.json``, ``flight_*.jsonl``,
``skew_summary*.json``), so on one directory they must give the same
merged document, key for key and value for value (tolerance 0: it is the
same arithmetic on the same floats):

* on the JAX tests' two-host fixture (``tests/test_timeline.py``, rebuilt
  here), in each of that file's seven cases (offset correction, Perfetto
  tracks, flight alignment, a torn log, skew-wait spans, the CLI, an empty
  directory), which hold the port's document as the JAX tests hold the
  JAX one;
* on a directory the port wrote itself: two gloo ranks training BERT-tiny
  through ``Runner.run`` with telemetry on, ``AUTODIST_WORKING_DIR`` in
  ``tmp_path``.
"""
import json
import os

import pytest

from autodist_tpu.tools import timeline as jtimeline
from autodist_tpu_torch.tools import timeline
from test_torch_ps_strategies import ROOT, _run_world

# A shared wall-clock moment (epoch us) both hosts' traces reference.
_T0_US = 1_700_000_000_000_000.0


def _trace_doc(host, pid, anchor_us, offset_ms, events):
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": {"epoch_anchor_us": anchor_us, "pid": pid,
                         "host": host, "clock_offset_ms": offset_ms}}


def _span(name, ts_us, dur_us, pid):
    return {"name": name, "cat": "autodist", "ph": "X", "ts": ts_us,
            "dur": dur_us, "pid": pid, "tid": 1}


def _fixture_dir(root):
    """``tests/test_timeline.py``'s two-host directory: host 1's clock runs
    250 ms ahead, its anchor differs, the same wall moment appears in both
    traces under different local coordinates, host 1's flight log is torn
    mid-final-line, and the chief's skew summary has one window."""
    h0 = _trace_doc(0, 100, _T0_US, 0.0,
                    [_span("step-loop", 1_000_000.0, 500_000.0, 100)])
    h1 = _trace_doc(1, 200, _T0_US + 3_000_000.0, 250.0,
                    [_span("step-loop", -1_750_000.0, 500_000.0, 200)])
    (root / "traces").mkdir()
    (root / "logs").mkdir()
    with open(root / "traces" / "autodist_trace_100.json", "w") as f:
        json.dump(h0, f)
    with open(root / "traces" / "autodist_trace_200.json", "w") as f:
        json.dump(h1, f)
    with open(root / "logs" / "flight_100.jsonl", "w") as f:
        f.write(json.dumps({"t": (_T0_US + 1_100_000.0) / 1e6,
                            "kind": "rollback", "detail": "chief"}) + "\n")
    line = json.dumps({"t": (_T0_US + 1_350_000.0 + 250_000.0) / 1e6,
                       "kind": "compile", "detail": "worker"}) + "\n"
    with open(root / "logs" / "flight_200.jsonl", "w") as f:
        f.write(line)
        f.write(line[: len(line) // 2])  # torn final line
    summary = {
        "hosts": {
            "0": {"offset_ms": 0.0, "skew_wait_ms": 2.0, "wire_ms": 0.5,
                  "windows": [{"i": 3, "s": (_T0_US + 1_200_000.0) / 1e6,
                               "e": (_T0_US + 1_210_000.0) / 1e6, "k": 1,
                               "skew_wait_ms": 2.0, "wire_ms": 0.5,
                               "exposed_comms_ms": 2.5, "straggler": 1}]},
            "1": {"offset_ms": 250.0, "skew_wait_ms": 0.0, "wire_ms": 2.5,
                  "windows": []},
        },
        "windows": 1, "significant": True, "max_skew_wait_ms": 2.0,
        "max_abs_offset_ms": 250.0,
        "straggler": {"host": 1, "share_pct": 100.0, "cause": "data_wait",
                      "cause_ms": 6.0,
                      "detail": "host 1 is the straggler in 1/1 windows; "
                                "dominant term data_wait (6.000 ms/step)"},
    }
    with open(root / "logs" / "skew_summary.json", "w") as f:
        json.dump(summary, f)
    return root


def _offsets(doc):
    spans = [e for e in doc["traceEvents"]
             if e.get("ph") == "X" and e["name"] == "step-loop"]
    by_host = {e["pid"]: e for e in spans}
    assert len(spans) == 2 and set(by_host) == {0, 1}
    assert by_host[0]["ts"] == pytest.approx(by_host[1]["ts"], abs=1.0)


def _tracks(doc):
    assert doc["displayTimeUnit"] == "ms" and doc["traceEvents"]
    for ev in doc["traceEvents"]:
        assert "name" in ev and "ph" in ev and "pid" in ev
        if ev["ph"] != "M":
            assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
    names = [e for e in doc["traceEvents"] if e["name"] == "process_name"]
    assert {e["args"]["name"] for e in names} == {"host 0", "host 1"}
    assert doc["metadata"]["hosts"] == [0, 1]


def _flight(doc):
    flight = {e["pid"]: e for e in doc["traceEvents"]
              if e.get("cat") == "flight"}
    base = doc["metadata"]["base_epoch_us"]
    assert flight[0]["name"] == "rollback" and flight[1]["name"] == "compile"
    assert flight[0]["ts"] == pytest.approx(_T0_US + 1_100_000.0 - base,
                                            abs=1.0)
    assert flight[1]["ts"] == pytest.approx(_T0_US + 1_350_000.0 - base,
                                            abs=1.0)


def _torn(doc):
    meta = doc["metadata"]
    assert meta["truncated"] is True
    assert any("flight_200" in p for p in meta["truncated_flight_logs"])


def _skew_wait(doc):
    waits = [e for e in doc["traceEvents"] if e["name"] == "skew-wait"]
    assert len(waits) == 1
    w = waits[0]
    assert w["pid"] == 0 and w["ph"] == "X"
    assert w["dur"] == pytest.approx(2_000.0)
    assert w["args"]["straggler"] == "1"
    assert doc["metadata"]["straggler"]["host"] == 1


_MERGE_CASES = {"offset_correction": _offsets, "perfetto_tracks": _tracks,
                "flight_alignment": _flight, "torn_log": _torn,
                "skew_wait_spans": _skew_wait}


@pytest.mark.parametrize("case", sorted(_MERGE_CASES) + ["cli", "empty"])
def test_merge_equals_the_jax_tool_on_its_fixture(case, tmp_path, capsys):
    if case == "empty":
        assert timeline.main([str(tmp_path)]) == \
            jtimeline.main([str(tmp_path)]) == 1
        assert not os.path.exists(tmp_path / "timeline.json")
        assert timeline.merge(str(tmp_path)) == \
            jtimeline.merge(str(tmp_path))
        return
    root = _fixture_dir(tmp_path)
    if case == "cli":
        capsys.readouterr()
        assert jtimeline.main([str(root), "--out", str(root / "j.json")]) == 0
        want = capsys.readouterr().out
        assert timeline.main([str(root)]) == 0
        got = capsys.readouterr().out
        with open(root / "timeline.json") as f:
            doc = json.load(f)
        with open(root / "j.json") as f:
            assert doc == json.load(f)
        assert "hosts [0, 1]" in got and "truncated" in got and \
            "straggler" in got
        assert got.replace(str(root / "timeline.json"), "OUT") == \
            want.replace(str(root / "j.json"), "OUT")
        return
    doc = timeline.merge(str(root))
    assert doc == jtimeline.merge(str(root))
    _MERGE_CASES[case](doc)


_RANK = r'''
import datetime, functools, os, sys
workdir, rank, world = sys.argv[-3], int(sys.argv[-2]), int(sys.argv[-1])
os.environ["AUTODIST_WORKING_DIR"] = workdir
os.environ["AUTODIST_TELEMETRY"] = "1"
import torch
import torch.distributed as dist
from autodist_tpu_torch import AutoDist
from autodist_tpu_torch.models import bert
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
dist.init_process_group("gloo", rank=rank, world_size=world, timeout=
                        datetime.timedelta(
                            seconds=float(os.environ["WORLD_TIMEOUT_S"])))
cfg = bert.bert_tiny(max_len=16)
full = bert.synthetic_batch(cfg, 8, 16, 3, seed=0)
mine = tuple(a[rank * 4:(rank + 1) * 4] for a in full)
ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
runner = ad.create_distributed_session(ad.capture(
    bert.make_loss_fn(cfg),
    bert.init(cfg, torch.Generator().manual_seed(0), device="cpu"),
    functools.partial(torch.optim.Adam, lr=1e-4), example_batch=mine))
state = runner.create_state()


def batches():
    while True:
        yield mine


state, _ = runner.run(state, batches(), 3)
dist.destroy_process_group()
'''


def test_merge_equals_the_jax_tool_on_a_directory_the_port_wrote(tmp_path):
    outs, err = _run_world(_RANK, 2, [str(tmp_path)], ROOT)
    assert outs is not None, err
    traces = sorted((tmp_path / "traces").glob("autodist_trace_*.json"))
    assert len(traces) == 2
    assert list((tmp_path / "logs").glob("flight_*.jsonl"))
    assert (tmp_path / "logs" / "skew_summary.json").exists()
    doc = timeline.merge(str(tmp_path))
    assert doc == jtimeline.merge(str(tmp_path))
    assert doc["metadata"]["hosts"] == [0, 1]
    assert doc["metadata"]["unaligned_traces"] == []
    # Every span of both traces appears exactly once.
    spans = []
    for path in traces:
        with open(path) as f:
            src = json.load(f)
        host = src["metadata"]["host"]
        spans += [(host, e["name"], e["dur"]) for e in src["traceEvents"]
                  if e.get("ph") == "X"]
    merged = [(e["pid"], e["name"], e["dur"]) for e in doc["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") != "skew"]
    assert sorted(merged) == sorted(spans) and spans
    assert {h for h, name, _ in spans if name == "step-loop"} == {0, 1}
