"""The port's launch and supervision layer against the JAX package's.

* the chief->worker env contract (``Coordinator._env_contract``) and what
  ``launch_clients`` starts over both tiers (local: argv and env; ssh:
  the client argv), and ``reform_now``'s exec (argv and env) under a
  stubbed exec, equal the JAX ``Coordinator``'s for the same spec and env
  (the port adds no key);
* the policy and chaos cases of ``tests/test_elastic.py`` (:306-362,
  :531-600) and ``tests/test_resilience.py`` (:187-250, :448-466),
  replayed on both packages: the same decisions and event kinds; the
  restart budget and the restart policy with real subprocesses;
* ``kill_worker_roll`` and ``slow_host_delay_ms`` bitwise equal to the JAX
  functions over 200 steps x 3 processes x 3 specs; ``maybe_kill`` exits a
  real subprocess with code 9;
* ``SSHLauncher``'s argv (exec, file write, copy) equal to the JAX one;
* a two-process ``launch: ssh`` linreg over a loopback ssh shim (the shim
  of ``tests/distributed/test_ssh_launch.py``) on a gloo world equals one
  process's run at rtol 1e-6, and so does a ``launch: local`` one.
"""
import functools
import os
import socket
import stat
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from autodist_tpu import coordinator as jcoordinator
from autodist_tpu import observability as jobs
from autodist_tpu import resilience as jresilience
from autodist_tpu import resource_spec as jrs
from autodist_tpu import ssh as jssh
from autodist_tpu.observability import goodput as jgoodput
from autodist_tpu.resilience import chaos as jchaos
from autodist_tpu_torch import AutoDist
from autodist_tpu_torch import autodist as autodist_mod
from autodist_tpu_torch import const, coordinator, observability, resilience
from autodist_tpu_torch import resource_spec as rs
from autodist_tpu_torch import ssh
from autodist_tpu_torch.observability import goodput
from autodist_tpu_torch.resilience import chaos
from autodist_tpu_torch.strategy import AllReduce

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")
LAUNCH_SCRIPT = os.path.join(TESTS, "torch_launch_script.py")
SUBPROCESS_TIMEOUT_S = 240

PKGS = {
    "jax": SimpleNamespace(Coordinator=jcoordinator.Coordinator,
                           resilience=jresilience, chaos=jchaos, rs=jrs,
                           ssh=jssh, obs=jobs, goodput=jgoodput),
    "port": SimpleNamespace(Coordinator=coordinator.Coordinator,
                            resilience=resilience, chaos=chaos, rs=rs,
                            ssh=ssh, obs=observability, goodput=goodput),
}

_KNOBS = ("AUTODIST_SUPERVISION", "AUTODIST_ELASTIC_MIN_WORLD",
          "AUTODIST_MAX_WORKER_RESTARTS", "AUTODIST_CHAOS",
          "AUTODIST_STRATEGY_ID", "AUTODIST_ELASTIC_WORLD",
          "AUTODIST_WORKER", "AUTODIST_PROCESS_ID", "AUTODIST_NUM_PROCESSES",
          "AUTODIST_COORDINATOR", "AUTODIST_RUN_GENERATION",
          "AUTODIST_SSH_BIN", "AUTODIST_SCP_BIN", "AUTODIST_DEBUG_REMOTE",
          "AUTODIST_TELEMETRY")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    from autodist_tpu import const as jconst
    for name in _KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AUTODIST_RUN_ID", "coord-test")
    for c in (const, jconst):
        monkeypatch.setattr(c, "DEFAULT_LOG_DIR", str(tmp_path / "logs"))
        monkeypatch.setattr(c, "DEFAULT_TRACE_DIR", str(tmp_path / "traces"))
    for pkg in PKGS.values():
        pkg.resilience.clear_events()
        pkg.chaos.reset()
        pkg.obs.refresh()
    yield
    for pkg in PKGS.values():
        pkg.resilience.clear_events()
        pkg.chaos.reset()
        pkg.obs.refresh()


def _kinds(pkg):
    return [k for _, k, _ in pkg.resilience.events()]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spec(pkg, tmp_path, text):
    path = tmp_path / "spec.yml"
    path.write_text(text)
    return pkg.rs.ResourceSpec(str(path))


# -- the env contract and what the chief launches -----------------------------

LOCAL_SPEC = """
launch: local
coordinator: "127.0.0.1:{port}"
nodes:
  - address: proc0
    chief: true
    cpus: [0]
  - address: proc1
    cpus: [0]
  - address: proc2
    cpus: [0]
"""

SSH_SPEC = """
launch: ssh
nodes:
  - address: chiefnode
    chief: true
    cpus: [0]
  - address: worknode
    cpus: [0]
    ssh_config: group_a
  - address: othernode
    cpus: [0]
    ssh_config: group_b
ssh:
  group_a:
    username: alice
    port: 2222
    key_file: /tmp/test_key
    python_venv: "source /srv/venv/bin/activate"
    shared_envs:
      MY_SHARED: "42"
  group_b:
    port: 22
"""


@pytest.mark.parametrize("with_strategy", [False, True])
def test_env_contract_matches_jax(monkeypatch, with_strategy):
    monkeypatch.setenv("AUTODIST_MIN_LOG_LEVEL", "WARNING")
    monkeypatch.setenv("AUTODIST_IS_TESTING", "1")
    strategy = SimpleNamespace(id="20260101T000000Z-1-0") \
        if with_strategy else None
    got = [PKGS[k].Coordinator(strategy, None)._env_contract(
        2, 3, "10.0.0.1:1234", "worknode") for k in ("port", "jax")]
    assert got[0] == got[1]
    assert got[0]["AUTODIST_RUN_ID"] == "coord-test"


class _FakeProc:
    pid = 4242

    def wait(self):
        return 0

    def poll(self):
        return 0


@pytest.mark.parametrize("tier", ["local", "ssh"])
def test_launch_clients_matches_jax(tmp_path, monkeypatch, tier):
    """What the chief starts for each worker: the argv and env of a local
    worker, the ssh client's argv of a remote one."""
    launched = {}
    text = LOCAL_SPEC.format(port=23999) if tier == "local" else SSH_SPEC
    monkeypatch.setattr(sys, "argv", [os.path.join(TESTS, "user.py"),
                                      "--flag", "a b"])
    for key, pkg in PKGS.items():
        calls = []

        def popen(argv, **kw):
            calls.append((list(argv), dict(kw.get("env") or {})))
            return _FakeProc()
        monkeypatch.setattr(subprocess, "Popen", popen)
        spec = _spec(pkg, tmp_path, text)
        co = pkg.Coordinator(None, SimpleNamespace(resource_spec=spec))
        co.launch_clients()
        launched[key] = calls
    assert len(launched["port"]) == 2
    assert launched["port"] == launched["jax"]
    if tier == "ssh":
        argv = launched["port"][0][0]
        assert argv[:6] == ["ssh", "-o", "StrictHostKeyChecking=no", "-p",
                            "2222", "-i"]
        assert "export AUTODIST_PROCESS_ID=1;" in argv[-1]


@pytest.mark.parametrize("telemetry", ["1", "0"])
def test_reform_now_exec_matches_jax(monkeypatch, telemetry):
    monkeypatch.setenv("AUTODIST_TELEMETRY", telemetry)
    monkeypatch.setenv("AUTODIST_STRATEGY_ID", "stale-artifact")
    monkeypatch.setenv("AUTODIST_WORKER", "proc3")
    monkeypatch.setenv("AUTODIST_RUN_GENERATION", "2")
    execs = {}
    for key, pkg in PKGS.items():
        pkg.obs.refresh()
        co = pkg.Coordinator(None, None)
        calls = []
        co._exec = lambda *a, calls=calls: calls.append(a)
        co._world_size = 4
        co.request_reform(3, reason="test")
        co.reform_now()
        co.reform_now()  # consumed: one re-form per process life
        assert not co.reform_pending and co.world_size == 3
        (execs[key],) = calls
    assert execs["port"] == execs["jax"]
    exe, argv, env = execs["port"]
    assert exe == sys.executable and argv[0] == sys.executable
    assert env["AUTODIST_ELASTIC_WORLD"] == "3"
    assert "AUTODIST_STRATEGY_ID" not in env and "AUTODIST_WORKER" not in env
    assert (env.get("AUTODIST_RUN_GENERATION") == "3") == (telemetry == "1")
    for pkg in PKGS.values():
        assert _kinds(pkg) == ["re-form-request", "re-form"]


def test_pinned_strategy_survives_the_reexec():
    envs = []
    for pkg in PKGS.values():
        co = pkg.Coordinator(None, None)
        co._exec = lambda *a: envs.append(a[2])
        co._world_size = 2
        assert co.pin_strategy("challenger-7") == "challenger-7"
        co.request_reform(1, reason="test")
        co.reform_now()
    assert envs[0] == envs[1]
    assert envs[0]["AUTODIST_STRATEGY_ID"] == "challenger-7"


# -- the policies, replayed on both packages ----------------------------------

def _policy_from_env(pkg, monkeypatch):
    r = pkg.resilience
    out = [type(r.supervision_policy()).__name__]
    monkeypatch.setenv("AUTODIST_SUPERVISION", "elastic")
    out.append(type(r.supervision_policy()).__name__)
    monkeypatch.setenv("AUTODIST_ELASTIC_MIN_WORLD", "3")
    out.append(r.ElasticPolicy().min_world)
    monkeypatch.setenv("AUTODIST_SUPERVISION", "restart-worker")
    out.append(type(r.supervision_policy()).__name__)
    monkeypatch.setenv("AUTODIST_MAX_WORKER_RESTARTS", "5")
    out.append(r.RestartPolicy().max_restarts)
    monkeypatch.setenv("AUTODIST_SUPERVISION", "no-such-policy")
    out.append(type(r.supervision_policy()).__name__)
    for name in ("AUTODIST_SUPERVISION", "AUTODIST_ELASTIC_MIN_WORLD",
                 "AUTODIST_MAX_WORKER_RESTARTS"):
        monkeypatch.delenv(name)
    return out


def _elastic_shrinks(pkg, monkeypatch):
    co = pkg.Coordinator(None, None,
                         supervision=pkg.resilience.ElasticPolicy(
                             min_world=1))
    co._world_size = 3
    co.supervision.on_worker_death(co, 2, SimpleNamespace(pid=999), 9)
    out = [co.reform_pending, co.world_size]
    co.supervision.on_worker_death(co, 1, SimpleNamespace(pid=998), 9)
    return out + [co.world_size, co.reform_pending]


def _elastic_escalates(pkg, monkeypatch):
    pol = pkg.resilience.ElasticPolicy(min_world=2)
    aborts = []
    monkeypatch.setattr(pol, "_escalate", SimpleNamespace(
        on_worker_death=lambda *a: aborts.append(a[1:])))
    co = pkg.Coordinator(None, None, supervision=pol)
    co._world_size = 2
    pol.on_worker_death(co, 1, SimpleNamespace(pid=997), 9)
    return [len(aborts), aborts[0][0], aborts[0][2], co.reform_pending]


def _grow_and_shrink(pkg, monkeypatch):
    co = pkg.Coordinator(None, None)
    co._world_size = 2
    out = [co.grow(1, immediate=False), co.reform_pending]
    details = [d for _, k, d in pkg.resilience.events()
               if k == "re-form-request"]
    co2 = pkg.Coordinator(None, None)
    co2._world_size = 3
    out += [co2.shrink(5, immediate=False), co2.world_size]
    # no world of several processes here: immediate defaults to a deferral
    co3 = pkg.Coordinator(None, None)
    co3._world_size = 1
    co3._exec = lambda *a: out.append("exec")
    out += [co3.grow(2), co3.reform_pending]
    return out + details


def _checkpoint_and_exit(pkg, monkeypatch):
    co = pkg.Coordinator(None, None,
                         supervision=pkg.resilience.CheckpointAndExitPolicy())
    proc = subprocess.Popen([sys.executable, "-c", "import os; os._exit(7)"])
    co._procs.append(proc)
    co._proc_wait_async(proc, 1)
    # ``failed`` flips before the policy runs: wait for the policy's
    # ``terminate`` too, so its event is recorded before the kinds are read
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not (co.failed and co._closing):
        time.sleep(0.05)
    return [co.failed, co._closing]


def _restart_second_life(pkg, monkeypatch, tmp_path):
    marker = tmp_path / f"second_life_{id(pkg)}"
    co = pkg.Coordinator(None, None,
                         supervision=pkg.resilience.RestartPolicy(
                             max_restarts=2))
    script = (f"import os, sys\n"
              f"p = {str(marker)!r}\n"
              f"if not os.path.exists(p):\n"
              f"    open(p, 'w').close()\n"
              f"    os._exit(9)\n"
              f"sys.exit(0)\n")
    monkeypatch.setattr(co, "_worker_argv",
                        lambda: [sys.executable, "-c", script])
    co._worker_launch[1] = ("proc-1", dict(os.environ))
    co._spawn_local(1, dict(os.environ))
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if (len(co._procs) == 2
                and all(p.poll() is not None for p in co._procs)
                and not co.failed):
            break
        time.sleep(0.05)
    return [len(co._procs), [p.returncode for p in co._procs],
            dict(co.supervision.restarts), co.failed]


def _restart_budget(pkg, monkeypatch, tmp_path):
    pol = pkg.resilience.RestartPolicy(max_restarts=1)
    aborts = []
    monkeypatch.setattr(pol, "_escalate", SimpleNamespace(
        on_worker_death=lambda *a: aborts.append(a[1:])))
    co = pkg.Coordinator(None, None, supervision=pol)
    monkeypatch.setattr(co, "_worker_argv", lambda: [
        sys.executable, "-c", "import os; os._exit(9)"])
    co._worker_launch[1] = ("proc-1", dict(os.environ))
    co._spawn_local(1, dict(os.environ))
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not aborts:
        time.sleep(0.05)
    return [dict(pol.restarts), len(co._procs),
            co._procs[0].pid != co._procs[1].pid, aborts[0][0],
            aborts[0][2]]


def _chaos_cases(pkg, monkeypatch):
    c = pkg.chaos
    out = [c.active()]
    monkeypatch.setenv("AUTODIST_CHAOS",
                       "nan_at=3, kv_delay_ms=50,kill_at=5:1")
    out += [c.knobs(), c.active()]
    monkeypatch.setenv("AUTODIST_CHAOS", "kill_at=5:1")
    c.maybe_kill(5, process_index=0)  # wrong process: alive
    c.maybe_kill(4, process_index=1)  # wrong step: alive
    monkeypatch.setenv("AUTODIST_CHAOS", "kill_at=5")
    c.maybe_kill(5, process_index=0)  # the chief is spared
    monkeypatch.setenv("AUTODIST_CHAOS", "kill_worker=1")
    c.maybe_kill(1, process_index=0)  # the chief is spared
    monkeypatch.setenv("AUTODIST_CHAOS", "kill_worker=0")
    c.maybe_kill(1, process_index=1)  # p = 0
    out.append(c.knobs())
    monkeypatch.setenv("AUTODIST_CHAOS", "slow_host=5:s")
    out += [c.maybe_slow_host(1, process_index=0),
            c.maybe_slow_host(2, process_index=1),
            c.maybe_slow_host(3, process_index=1)]
    monkeypatch.delenv("AUTODIST_CHAOS")
    return out


CASES = {"policy_from_env": _policy_from_env,
         "elastic_shrinks": _elastic_shrinks,
         "elastic_escalates": _elastic_escalates,
         "grow_and_shrink": _grow_and_shrink,
         "checkpoint_and_exit": _checkpoint_and_exit,
         "chaos": _chaos_cases}
SUBPROCESS_CASES = {"restart_second_life": _restart_second_life,
                    "restart_budget": _restart_budget}


@pytest.mark.parametrize("case", sorted(CASES))
def test_policy_case_matches_jax(monkeypatch, case):
    got = {}
    for key, pkg in PKGS.items():
        got[key] = (CASES[case](pkg, monkeypatch), _kinds(pkg))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("case", sorted(SUBPROCESS_CASES))
def test_restart_policy_with_real_processes_matches_jax(monkeypatch,
                                                        tmp_path, case):
    got = {}
    for key, pkg in PKGS.items():
        got[key] = (SUBPROCESS_CASES[case](pkg, monkeypatch, tmp_path),
                    _kinds(pkg))
    assert got["port"] == got["jax"]
    if case == "restart_budget":
        assert got["port"][0][0] == {1: 1}  # keyed by the logical index


# -- chaos coins --------------------------------------------------------------

@pytest.mark.parametrize("spec", ["0.5:seed7", "0.05", "0.9:x"])
def test_chaos_coins_bitwise_match_jax(spec):
    for proc in range(3):
        got = [chaos.kill_worker_roll(spec, s, proc) for s in range(200)]
        assert got == [jchaos.kill_worker_roll(spec, s, proc)
                       for s in range(200)]
        slow = spec.replace("0.", "1")  # slow_host takes ms
        delays = [chaos.slow_host_delay_ms(s, proc, slow)
                  for s in range(200)]
        assert delays == [jchaos.slow_host_delay_ms(s, proc, slow)
                          for s in range(200)]
        assert any(delays) == (proc == chaos.SLOW_HOST_TARGET)
    rolls = [chaos.kill_worker_roll("0.5:seed7", s, 1) for s in range(200)]
    assert 0.25 < sum(rolls) / 200 < 0.75
    assert chaos.SLOW_HOST_TARGET == jchaos.SLOW_HOST_TARGET


@pytest.mark.parametrize("knob", ["kill_worker=1", "kill_at=3:1",
                                  "kill_at=3"])
def test_maybe_kill_exits_a_process_with_9(knob):
    script = ("import os, sys; sys.path.insert(0, sys.argv[1]); "
              f"os.environ['AUTODIST_CHAOS'] = {knob!r}; "
              "os.environ['AUTODIST_PROCESS_ID'] = '1'; "
              "from autodist_tpu_torch.resilience import chaos; "
              "chaos.maybe_kill(2); chaos.maybe_kill(3); sys.exit(0)")
    proc = subprocess.run([sys.executable, "-c", script, ROOT],
                          env=dict(os.environ, OMP_NUM_THREADS="1"),
                          timeout=SUBPROCESS_TIMEOUT_S)
    assert proc.returncode == 9


# -- ssh ----------------------------------------------------------------------

SSH_SHIM = """#!/bin/bash
# Loopback ssh: record argv, strip client options + target, then do what a
# real remote login shell does: join the remaining words with spaces and
# re-parse them as one shell command line.
if [ -n "$SSH_SHIM_LOG" ]; then echo "$@" >> "$SSH_SHIM_LOG"; fi
while [ $# -gt 0 ]; do
  case "$1" in
    -o|-p|-i) shift 2 ;;
    -tt) shift ;;
    *) break ;;
  esac
done
target="$1"; shift   # user@host: unused, loopback
exec /bin/bash -c "$*"
"""

SCP_SHIM = """#!/bin/bash
# Loopback scp: copy the local source to the host:path target's path part.
if [ -n "$SSH_SHIM_LOG" ]; then echo "scp $@" >> "$SSH_SHIM_LOG"; fi
while [ $# -gt 0 ]; do
  case "$1" in
    -o|-P|-i) shift 2 ;;
    *) break ;;
  esac
done
src="$1"; dst="${2#*:}"
mkdir -p "$dst" 2>/dev/null
if [ "$src" != "$dst/$(basename "$src")" ]; then cp "$src" "$dst/"; fi
"""


def _write_shims(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name, body in (("ssh", SSH_SHIM), ("scp", SCP_SHIM)):
        p = bindir / name
        p.write_text(body)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return str(bindir / "ssh"), str(bindir / "scp")


def test_ssh_argv_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTODIST_SSH_BIN", "/usr/local/bin/myssh")
    monkeypatch.setenv("AUTODIST_SCP_BIN", "/usr/local/bin/myscp")
    argvs = {}
    for key, pkg in PKGS.items():
        calls = []
        monkeypatch.setattr(subprocess, "Popen", lambda argv, **kw: (
            calls.append(("popen", list(argv))), _FakeProc())[1])
        monkeypatch.setattr(subprocess, "run", lambda argv, **kw: (
            calls.append(("run", list(argv), kw.get("input"))),
            SimpleNamespace(returncode=0, stderr=""))[1])
        launcher = pkg.ssh.SSHLauncher(_spec(pkg, tmp_path, SSH_SPEC))
        for node in ("worknode", "othernode"):
            launcher.remote_exec(node, ["python", "x.py", "a b", "$HOME"],
                                 env={"AUTODIST_PROCESS_ID": "1",
                                      "Q": "it's"}, cwd="/w d")
            launcher.remote_file_write(node, "/tmp/sub dir/f.txt", "payload")
            launcher.remote_copy(node, "/tmp/spec.yml", "/remote dir")
        with pytest.raises(ValueError, match="no ssh config"):
            launcher.remote_exec("chiefnode", ["true"])
        argvs[key] = calls
    assert argvs["port"] == argvs["jax"]
    assert argvs["port"][0][1][0] == "/usr/local/bin/myssh"
    assert argvs["port"][-1][1][0] == "/usr/local/bin/myscp"


def test_ssh_debug_remote_runs_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTODIST_DEBUG_REMOTE", "1")
    monkeypatch.setattr(subprocess, "Popen", None)
    monkeypatch.setattr(subprocess, "run", None)
    launcher = ssh.SSHLauncher(_spec(PKGS["port"], tmp_path, SSH_SPEC))
    assert launcher.remote_exec("worknode", ["true"]) is None
    assert launcher.remote_file_write("worknode", "/tmp/f", "x") is None
    assert launcher.remote_copy("worknode", "/tmp/f", "/tmp/d") is None


def test_ssh_shim_round_trip(tmp_path, monkeypatch):
    ssh_bin, scp_bin = _write_shims(tmp_path)
    log = tmp_path / "shim.log"
    monkeypatch.setenv("AUTODIST_SSH_BIN", ssh_bin)
    monkeypatch.setenv("AUTODIST_SCP_BIN", scp_bin)
    monkeypatch.setenv("SSH_SHIM_LOG", str(log))
    launcher = ssh.SSHLauncher(_spec(PKGS["port"], tmp_path, SSH_SPEC))
    proc = launcher.remote_exec("worknode", ["echo", "hello-from-remote"],
                                env={"AUTODIST_PROCESS_ID": "1"})
    assert proc.wait(timeout=SUBPROCESS_TIMEOUT_S) == 0
    line = log.read_text()
    for needle in ("-p 2222", "-i /tmp/test_key", "alice@worknode",
                   "export MY_SHARED=42;", "export AUTODIST_PROCESS_ID=1;",
                   "source /srv/venv/bin/activate;",
                   "echo hello-from-remote"):
        assert needle in line
    launcher.remote_file_write("worknode", str(tmp_path / "sub" / "f.txt"),
                               "payload")
    assert (tmp_path / "sub" / "f.txt").read_text() == "payload"
    launcher.remote_copy("worknode", str(tmp_path / "spec.yml"),
                         str(tmp_path / "copied"))
    assert (tmp_path / "copied" / "spec.yml").exists()


# -- a launched two-process job ----------------------------------------------

LINREG_STEPS = 5


def _one_process_params():
    sys.path.insert(0, TESTS)
    try:
        from torch_elastic_script import data, loss_fn
    finally:
        sys.path.remove(TESTS)
    x, y = data()
    autodist_mod._reset_default()
    try:
        ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
        runner = ad.create_distributed_session(ad.capture(
            loss_fn, {"w": torch.zeros(8, 1), "b": torch.zeros(1)},
            functools.partial(torch.optim.SGD, lr=0.1),
            example_batch=(x, y)))
        state = runner.create_state()
        whole = (torch.from_numpy(x), torch.from_numpy(y))
        for _ in range(LINREG_STEPS):
            state, _ = runner.step(state, whole)
        return {k: v.detach().numpy().copy()
                for k, v in runner.logical_params(state).items()}
    finally:
        autodist_mod._reset_default()


def _run_launched(tmp_path, spec_text, extra_env):
    """The chief of a launched job (it starts its worker), with a free
    coordinator port (one retry: the port can be taken before it binds)."""
    for _ in range(2):
        port = _free_port()
        spec = tmp_path / "launch.yml"
        spec.write_text(spec_text.format(port=port, root=ROOT))
        out = tmp_path / f"out{port}.npz"
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("AUTODIST_", "RANK", "WORLD_SIZE",
                                    "MASTER_", "LOCAL_RANK"))}
        env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   AUTODIST_WORKING_DIR=str(tmp_path / "wd"), **extra_env)
        proc = subprocess.run(
            [sys.executable, LAUNCH_SCRIPT, str(spec), str(LINREG_STEPS),
             str(out)], env=env, capture_output=True, text=True,
            timeout=SUBPROCESS_TIMEOUT_S, cwd=ROOT)
        if proc.returncode == 0 or "ddress already in use" not in \
                proc.stderr:
            return proc, out
    return proc, out


LAUNCH_SPECS = {
    "ssh": """
launch: ssh
coordinator: "127.0.0.1:{port}"
nodes:
  - address: node0
    chief: true
    cpus: [0]
  - address: node1
    cpus: [0]
ssh:
  cluster:
    shared_envs:
      PYTHONPATH: "{root}"
      OMP_NUM_THREADS: "1"
""",
    "local": """
launch: local
coordinator: "127.0.0.1:{port}"
nodes:
  - address: proc0
    chief: true
    cpus: [0]
  - address: proc1
    cpus: [0]
""",
}


@pytest.mark.parametrize("tier", sorted(LAUNCH_SPECS))
def test_two_process_launched_linreg_matches_one_process(tmp_path, tier):
    extra = {}
    if tier == "ssh":
        ssh_bin, scp_bin = _write_shims(tmp_path)
        extra = {"AUTODIST_SSH_BIN": ssh_bin, "AUTODIST_SCP_BIN": scp_bin,
                 "SSH_SHIM_LOG": str(tmp_path / "shim.log")}
    proc, out = _run_launched(tmp_path, LAUNCH_SPECS[tier], extra)
    assert proc.returncode == 0, \
        f"STDOUT:\n{proc.stdout[-3000:]}\nSTDERR:\n{proc.stderr[-3000:]}"
    assert "LAUNCH_OK rank=0 world=2" in proc.stdout
    assert "LAUNCH_OK rank=1 world=2" in proc.stdout
    workers = {0: "", 1: "node1" if tier == "ssh" else "proc1"}
    for rank, worker in workers.items():
        assert open(f"{out}.p{rank}").read().split() == \
            ["2"] + ([worker] if worker else [])
    if tier == "ssh":
        line = (tmp_path / "shim.log").read_text()
        assert "node1" in line and "export AUTODIST_PROCESS_ID=1;" in line
    got = np.load(out)
    want = _one_process_params()
    assert set(got.files) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-6, atol=0)
