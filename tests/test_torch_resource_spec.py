"""The port's resource spec against the JAX package's, on the same files.

Every YAML of ``tests/test_resource_spec.py`` and
``tests/test_elastic.py::test_resource_spec_honors_elastic_world``, and the
launch specs of ``tests/distributed/`` and of the port's elastic phase,
loaded by both packages: device name strings and process indices,
``num_processes``, ``chief_address``, ``coordinator``, ``node_addresses``,
``num_hosts``, ``devices_per_host``, ``cpu_devices``, the mesh /
interconnect / memory keys, the launch mode, ``ssh_config_for`` every node,
``connectivity`` of every device pair, and the ``from_string`` round trip
of every name agree exactly. Known difference: one process drives one
device, so under ``launch: local|ssh`` a CPU node is one CPU device however
many its ``cpus:`` lists (the distributed tier's ``cpus: [0, 1, 2, 3]``
nodes), and a node listing several accelerators is refused; the launch
fields agree there too. Also: ``is_chief`` under the env contract, the
elastic-world shrink, the auto source's contract, the world spec keeping
the launch fields, the backend choice, and the refusal of a ``tpu:`` spec
at ``Cluster.start``.
"""
import itertools

import pytest
import torch

from autodist_tpu import resilience as jresilience
from autodist_tpu import resource_spec as jrs
from autodist_tpu_torch import resilience
from autodist_tpu_torch import resource_spec as rs
from autodist_tpu_torch.cluster import Cluster

NODES_YAML = """
nodes:
  - address: 10.0.0.1
    chief: true
    gpus: [0, 1]
  - address: 10.0.0.2
    gpus: [0, 1]
    ssh_config_group: group1
ssh:
  group1:
    username: ubuntu
    port: 22
"""

TPU_YAML = """
tpu:
  accelerator: v5e-16
  num_hosts: 2
  chips_per_host: 8
mesh:
  data: 4
  model: 4
"""

ELASTIC_YAML = """
nodes:
  - address: host-a
    chief: true
    cpus: [0, 1]
  - address: host-b
    cpus: [0, 1]
  - address: host-c
    cpus: [0, 1]
"""

SSH_YAML = """
launch: ssh
nodes:
  - address: chiefnode
    chief: true
    cpus: [0]
  - address: worknode
    cpus: [0]
    ssh_config: group_a
ssh:
  group_a:
    username: alice
    port: 2222
    key_file: /tmp/test_key
    python_venv: "source /srv/venv/bin/activate"
    shared_envs:
      MY_SHARED: "42"
"""

SSH4_YAML = """
launch: ssh
coordinator: "127.0.0.1:23456"
nodes:
  - address: node0
    chief: true
    cpus: [0]
  - address: node1
    cpus: [0]
  - address: node2
    cpus: [0]
  - address: node3
    cpus: [0]
ssh:
  cluster:
    shared_envs:
      AUTODIST_TEST_DEVCOUNT: "2"
"""

GPU_LOCAL_YAML = """
launch: local
coordinator: "127.0.0.1:23457"
interconnect: {ici_gbps: 360, dcn_gbps: 25, dcn_us: 50}
memory: {hbm_gb: 80}
mesh: {data: 2}
nodes:
  - address: proc0
    chief: true
    gpus: [0]
  - address: proc1
    gpus: [0]
"""

TPU_HOSTS_YAML = """
tpu:
  accelerator: v5e-4
  num_hosts: 2
  coordinator: "10.1.1.1:8476"
  hosts: [a, b]
"""

# Specs both packages parse alike, device for device.
SAME = {"nodes": NODES_YAML, "tpu": TPU_YAML, "elastic": ELASTIC_YAML,
        "ssh": SSH_YAML, "ssh4": SSH4_YAML, "gpu_local": GPU_LOCAL_YAML,
        "tpu_hosts": TPU_HOSTS_YAML}

# The distributed tier's launch spec: a CPU node is one CPU device in the
# port (the known difference).
DIST_TIER_YAML = """
launch: local
coordinator: "127.0.0.1:23458"
nodes:
  - address: proc0
    chief: true
    cpus: [0, 1, 2, 3]
  - address: proc1
    cpus: [0, 1, 2, 3]
"""


@pytest.fixture(autouse=True)
def _contract(monkeypatch):
    for name in ("AUTODIST_ELASTIC_WORLD", "AUTODIST_PROCESS_ID",
                 "AUTODIST_WORKER", "AUTODIST_NUM_PROCESSES",
                 "AUTODIST_COORDINATOR"):
        monkeypatch.delenv(name, raising=False)
    resilience.clear_events()
    jresilience.clear_events()
    yield
    resilience.clear_events()
    jresilience.clear_events()


def _both(tmp_path, text):
    path = tmp_path / "spec.yml"
    path.write_text(text)
    return rs.ResourceSpec(str(path)), jrs.ResourceSpec(str(path))


def _launch_fields(spec):
    return {
        "num_processes": spec.num_processes,
        "chief_address": spec.chief_address,
        "coordinator": spec.coordinator,
        "node_addresses": spec.node_addresses,
        "mesh_hints": spec.mesh_hints,
        "interconnect": spec.interconnect,
        "memory": spec.memory,
        "local_launch": spec.local_launch,
        "remote_launch": spec.remote_launch,
        "ssh": {a: (tuple(c) if c is not None else None) for a in
                spec.node_addresses
                for c in [spec.ssh_config_for(a)]},
        "groups": {g: tuple(c) for g, c in spec.ssh_config_map.items()},
    }


def _devices(spec):
    return [(d.name_string(), d.process_index, d.device_type.name)
            for d in spec.devices]


def _layout(spec):
    return {"num_devices": spec.num_devices,
            "num_hosts": spec.num_hosts,
            "devices_per_host": spec.devices_per_host,
            "accelerators": [d.name_string()
                             for d in spec.accelerator_devices],
            "cpus": [d.name_string() for d in spec.cpu_devices]}


@pytest.mark.parametrize("name", sorted(SAME))
def test_spec_matches_jax(tmp_path, name):
    spec, jspec = _both(tmp_path, SAME[name])
    assert _devices(spec) == _devices(jspec)
    assert _layout(spec) == _layout(jspec)
    assert _launch_fields(spec) == _launch_fields(jspec)
    conn = [spec.connectivity(a, b).name
            for a, b in itertools.product(spec.devices, repeat=2)]
    jconn = [jspec.connectivity(a, b).name
             for a, b in itertools.product(jspec.devices, repeat=2)]
    assert conn == jconn
    for d in spec.devices:
        name_ = d.name_string()
        assert rs.DeviceSpec.from_string(name_).name_string() == \
            jrs.DeviceSpec.from_string(name_).name_string() == name_
        assert rs.DeviceSpec.from_string(name_).process_index == \
            jrs.DeviceSpec.from_string(name_).process_index


def test_from_string_roundtrip_matches_jax():
    for name in ["10.0.0.1:GPU:0", "host-3:TPU:5", "localhost:CPU:0",
                 "host:7"]:
        got, want = rs.DeviceSpec.from_string(name), \
            jrs.DeviceSpec.from_string(name)
        assert got.name_string() == want.name_string()
        assert (got.host_address, got.device_type.name, got.device_index) \
            == (want.host_address, want.device_type.name, want.device_index)
    assert [c.name for c in rs.Connectivity] == \
        [c.name for c in jrs.Connectivity]
    assert [c.value for c in rs.Connectivity] == \
        [c.value for c in jrs.Connectivity]


def test_launched_cpu_node_is_one_device(tmp_path):
    """The known difference: under launch: local a CPU node is one CPU
    device (the JAX package gives it four forced-host devices); every
    launch field agrees."""
    spec, jspec = _both(tmp_path, DIST_TIER_YAML)
    assert _launch_fields(spec) == _launch_fields(jspec)
    assert _devices(spec) == [("proc0:CPU:0", 0, "CPU"),
                              ("proc1:CPU:0", 1, "CPU")]
    assert [d for d in _devices(jspec) if d[0].endswith(":0")] == \
        _devices(spec)
    assert jspec.num_devices == 8 and spec.num_devices == 2


def test_launched_node_with_several_cards_is_refused(tmp_path):
    text = GPU_LOCAL_YAML.replace("    gpus: [0]\n  - address: proc1",
                                  "    gpus: [0, 1]\n  - address: proc1")
    assert "gpus: [0, 1]" in text
    path = tmp_path / "spec.yml"
    path.write_text(text)
    with pytest.raises(ValueError, match="one node per card"):
        rs.ResourceSpec(str(path))
    assert jrs.ResourceSpec(str(path)).num_devices == 3  # JAX takes it
    # Without a launch mode the list parses as the JAX package's.
    path.write_text(text.replace("launch: local\n", ""))
    spec, jspec = rs.ResourceSpec(str(path)), jrs.ResourceSpec(str(path))
    assert _devices(spec) == _devices(jspec)


@pytest.mark.parametrize("world", ["0", "1", "2", "5"])
def test_elastic_world_override_matches_jax(tmp_path, monkeypatch, world):
    monkeypatch.setenv("AUTODIST_ELASTIC_WORLD", world)
    spec, jspec = _both(tmp_path, ELASTIC_YAML)
    assert _devices(spec) == _devices(jspec)
    assert _launch_fields(spec) == _launch_fields(jspec)
    kinds = [k for _, k, _ in resilience.events()]
    jkinds = [k for _, k, _ in jresilience.events()]
    assert kinds == jkinds == (["spec-shrink"] if world in ("1", "2")
                               else [])
    if world == "2":
        assert spec.num_processes == 2
        assert {d.host_address for d in spec.devices} == {"host-a",
                                                          "host-b"}


@pytest.mark.parametrize("pid,worker", [(None, None), ("0", None),
                                        ("1", "proc1"), ("0", "proc0"),
                                        ("2", None)])
def test_is_chief_under_the_env_contract(tmp_path, monkeypatch, pid, worker):
    if pid is not None:
        monkeypatch.setenv("AUTODIST_PROCESS_ID", pid)
    if worker is not None:
        monkeypatch.setenv("AUTODIST_WORKER", worker)
    spec, jspec = _both(tmp_path, GPU_LOCAL_YAML)
    assert spec.is_chief() == jspec.is_chief()
    for address in ("proc0", "proc1", "elsewhere"):
        assert spec.is_chief(address) == jspec.is_chief(address)
    assert Cluster(spec).is_chief() == (int(pid or 0) == 0)


def test_auto_source_reads_the_contract(monkeypatch):
    monkeypatch.setenv("AUTODIST_NUM_PROCESSES", "3")
    monkeypatch.setenv("AUTODIST_COORDINATOR", "10.0.0.9:1234")
    spec, jspec = rs.ResourceSpec(), jrs.ResourceSpec()
    for key in ("num_processes", "coordinator", "chief_address",
                "local_launch", "remote_launch"):
        assert getattr(spec, key) == getattr(jspec, key), key


def test_world_spec_keeps_the_launch_fields(tmp_path):
    spec, _ = _both(tmp_path, GPU_LOCAL_YAML)
    world = rs.ResourceSpec.world(torch.device("cpu"), 1, 2,
                                  spec.mesh_hints, parsed=spec)
    assert world.node_addresses == ["proc0", "proc1"]
    assert world.chief_address == "proc0"
    for key in ("coordinator", "interconnect", "memory", "local_launch",
                "remote_launch", "ssh_config_map", "node_ssh_group"):
        assert getattr(world, key) == getattr(spec, key), key
    assert [d.process_index for d in world.devices] == [0, 1]
    # A spec that does not list one node a rank names hosts by rank.
    other = rs.ResourceSpec.world(torch.device("cpu"), 0, 3, None,
                                  parsed=spec)
    assert other.node_addresses == ["process-0", "process-1", "process-2"]
    assert other.chief_address == "process-0"


def test_backend_is_gloo_where_processes_share_a_card(tmp_path):
    spec, _ = _both(tmp_path, GPU_LOCAL_YAML)
    cuda = torch.device("cuda", 0)
    backend, why = Cluster(spec)._backend(cuda, (0, 2))
    assert backend == "gloo" and "share card 0" in why
    own = GPU_LOCAL_YAML.replace("address: proc1\n    gpus: [0]",
                                 "address: proc1\n    gpus: [1]")
    spec2, _ = _both(tmp_path, own)
    assert Cluster(spec2)._backend(cuda, (0, 2))[0] == "nccl"
    assert Cluster(spec)._backend(torch.device("cpu"), (0, 2))[0] == "gloo"
    assert Cluster(spec)._backend(cuda, None)[0] == "nccl"


def test_tpu_spec_is_refused_at_cluster_start(tmp_path):
    spec, jspec = _both(tmp_path, TPU_YAML)
    assert spec.num_devices == jspec.num_devices == 16
    with pytest.raises(ValueError, match="nodes: list .* gpus:"):
        Cluster(spec).start("cpu")
    assert not torch.distributed.is_initialized()
