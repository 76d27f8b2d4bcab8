"""Multi-process launcher: one worker process per rank.

The port of the JAX package's ``parallel/launch.py``::

    python -m tsasr_torch.parallel.launch --nproc_per_node 2 \\
        -m tsasr_torch.train_librispeechmix_scratch <yaml> --device cpu

    python -m tsasr_torch.parallel.launch --nproc_per_node 2 \\
        script.py [script args...]

Each worker gets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` (localhost) and ``MASTER_PORT`` (a
free port below the ephemeral range unless ``--master_port``), the
variables ``torchrun`` sets, so ``parse_arguments`` joins the group
(``distributed.maybe_init_distributed``) before any device is touched.
Each worker's output is streamed line by line with a ``[p{i}]`` prefix
and, with ``--log_dir``, written to ``<log_dir>/proc{i}.log``. When a
worker fails, the others are ended and its exit code is returned (a
worker killed by signal s returns 128 + s). JAX's
``--devices_per_process`` (virtual CPU devices) has no torch
counterpart.
"""

import argparse
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time


# MASTER_PORT is drawn below the kernel's usual ephemeral range
# (32768-60999): a port the kernel handed out as free can be taken again
# by a socket bound to port 0 (gloo's, another run's) before the workers'
# store binds it
PORT_RANGE = (20000, 32767)


def _free_port():
    """A port in PORT_RANGE that binds now."""
    rng = random.Random()
    while True:
        port = rng.randint(*PORT_RANGE)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port


def _pump(proc, idx, log_path):
    log = open(log_path, "w", buffering=1) if log_path else None
    for raw in proc.stdout:
        line = raw.decode("utf-8", "replace")
        sys.stdout.write(f"[p{idx}] {line}")
        sys.stdout.flush()
        if log:
            log.write(line)
    if log:
        log.close()


def _exit_code(rc):
    return 128 - rc if rc < 0 else rc


def launch(target, nproc, log_dir=None, master_port=None, env=None):
    """Run ``nproc`` workers of ``target`` (a script and its arguments, or
    ``["-m", module, ...]``); returns 0, or the first failing worker's
    exit code once the others are ended."""
    port = master_port or _free_port()
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    procs, pumps = [], []
    failed = 0
    try:
        for i in range(nproc):
            wenv = dict(env if env is not None else os.environ)
            wenv.update(WORLD_SIZE=str(nproc), RANK=str(i),
                        LOCAL_RANK=str(i), LOCAL_WORLD_SIZE=str(nproc),
                        MASTER_ADDR="localhost", MASTER_PORT=str(port))
            proc = subprocess.Popen([sys.executable, *target], env=wenv,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            procs.append(proc)
            log_path = (os.path.join(log_dir, f"proc{i}.log")
                        if log_dir else None)
            pump = threading.Thread(target=_pump, args=(proc, i, log_path),
                                    daemon=True)
            pump.start()
            pumps.append(pump)
        while True:
            codes = [p.poll() for p in procs]
            failed = next((_exit_code(c) for c in codes if c), 0)
            if failed or all(c is not None for c in codes):
                break
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        for pump in pumps:
            pump.join(timeout=10)
    return failed


def _split(argv):
    """(launcher options, target): the target starts at ``-m`` or at the
    first argument that is not an option."""
    i = 0
    while i < len(argv) and argv[i].startswith("--"):
        i += 1 if "=" in argv[i] else 2
    return argv[:i], argv[i:]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = argparse.ArgumentParser(
        description="tsasr_torch multi-process launcher",
        usage="python -m tsasr_torch.parallel.launch --nproc_per_node N "
              "[--log_dir DIR] [--master_port PORT] "
              "(script.py | -m module) [arguments...]")
    parser.add_argument("--nproc_per_node", type=int, required=True)
    parser.add_argument("--log_dir", type=str, default=None)
    parser.add_argument("--master_port", type=int, default=None)
    options, target = _split(argv)
    args = parser.parse_args(options)
    if not target or target == ["-m"]:
        parser.error("missing the script or -m module to launch")
    if args.nproc_per_node < 1:
        parser.error("--nproc_per_node must be at least 1")
    return launch(target, args.nproc_per_node, log_dir=args.log_dir,
                  master_port=args.master_port)


if __name__ == "__main__":
    sys.exit(main())
