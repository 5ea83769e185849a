"""SSH remote launch: the chief starts worker processes on remote nodes.

Counterpart of ``autodist_tpu/ssh.py``, with the same argv for the same
spec and environment. Three primitives over the ``ssh`` / ``scp`` CLI:

* :meth:`SSHLauncher.remote_exec` — run a command on a node, with the ssh
  group's env exports (and the chief->worker launch contract), its venv
  activation and a ``cd`` inlined into one ``bash -c`` word;
* :meth:`SSHLauncher.remote_file_write` — write text to a remote path;
* :meth:`SSHLauncher.remote_copy` — scp a local file into a remote dir.

``AUTODIST_SSH_BIN`` / ``AUTODIST_SCP_BIN`` override the binaries (a
loopback shim runs the whole path without an sshd);
``AUTODIST_DEBUG_REMOTE`` logs each argv instead of running it.
"""
import os
import shlex
import subprocess

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging


class SSHLauncher:
    """Executes commands / copies on remote nodes per the spec's SSH
    config."""

    def __init__(self, resource_spec):
        self._spec = resource_spec

    def _config(self, address):
        cfg = self._spec.ssh_config_for(address)
        if cfg is None:
            raise ValueError(
                f"no ssh config for node {address!r}: give the node an "
                f"'ssh_config: <group>' key or define exactly one 'ssh:' "
                f"group in the resource spec")
        return cfg

    def _target(self, address, cfg):
        return f"{cfg.username}@{address}" if cfg.username else address

    def _ssh_args(self, cfg):
        args = [const.ENV.AUTODIST_SSH_BIN.val or "ssh",
                "-o", "StrictHostKeyChecking=no", "-p", str(cfg.port)]
        if cfg.key_file:
            args += ["-i", cfg.key_file]
        return args

    def _remote_shell(self, address, cfg, shell_cmd):
        """Client argv whose remote payload survives ssh's space-join: ONE
        shell-quoted ``bash -c`` word (ssh joins the words after the target
        with spaces and the remote login shell splits them again)."""
        return self._ssh_args(cfg) + [self._target(address, cfg),
                                      f"bash -c {shlex.quote(shell_cmd)}"]

    def remote_exec(self, address, command_args, env=None, cwd=None):
        """Run ``command_args`` on ``address``; returns the client Popen
        (None under ``AUTODIST_DEBUG_REMOTE``, which only logs the argv).
        The remote command line is ``[exports] [venv-activation;] [cd;]
        cmd``: a real ssh session inherits neither the chief's env nor its
        working directory."""
        cfg = self._config(address)
        parts = []
        merged_env = dict(cfg.env or {})
        merged_env.update(env or {})
        for k, v in merged_env.items():
            parts.append(f"export {k}={shlex.quote(str(v))};")
        if cfg.python_venv:
            parts.append(f"{cfg.python_venv};")
        if cwd:
            parts.append(f"cd {shlex.quote(cwd)};")
        parts.append(" ".join(shlex.quote(str(a)) for a in command_args))
        remote_cmd = " ".join(parts)
        argv = self._remote_shell(address, cfg, remote_cmd)
        logging.debug("ssh exec on %s: %s", address, remote_cmd)
        if const.ENV.AUTODIST_DEBUG_REMOTE.val:
            logging.info("[debug-remote] %s", " ".join(map(shlex.quote, argv)))
            return None
        return subprocess.Popen(argv, start_new_session=True)

    def remote_file_write(self, address, remote_path, data):
        """Write ``data`` (str) to ``remote_path`` on the node."""
        cfg = self._config(address)
        argv = self._remote_shell(
            address, cfg,
            f"mkdir -p {shlex.quote(os.path.dirname(remote_path))} && "
            f"cat > {shlex.quote(remote_path)}")
        if const.ENV.AUTODIST_DEBUG_REMOTE.val:
            logging.info("[debug-remote] %s", " ".join(map(shlex.quote, argv)))
            return
        proc = subprocess.run(argv, input=data, text=True,
                              capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(f"remote_file_write to {address}:{remote_path} "
                               f"failed: {proc.stderr[-500:]}")

    def remote_copy(self, address, local_path, remote_dir):
        """Copy a local file into ``remote_dir`` on the node (scp)."""
        cfg = self._config(address)
        mkdir = self.remote_exec(address, ["mkdir", "-p", remote_dir])
        if mkdir is not None:
            mkdir.wait()
        argv = [const.ENV.AUTODIST_SCP_BIN.val or "scp",
                "-o", "StrictHostKeyChecking=no", "-P", str(cfg.port)]
        if cfg.key_file:
            argv += ["-i", cfg.key_file]
        argv += [local_path, f"{self._target(address, cfg)}:{remote_dir}/"]
        if const.ENV.AUTODIST_DEBUG_REMOTE.val:
            logging.info("[debug-remote] %s", " ".join(map(shlex.quote, argv)))
            return
        proc = subprocess.run(argv, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"remote_copy {local_path} -> {address}:"
                               f"{remote_dir} failed: {proc.stderr[-500:]}")
