"""Logging infrastructure: experiment logging setup + environment snapshot.

The port's own copy of the JAX package's ``utils/logger.py`` (the
reference's ``utils/logger.py`` :83-196): configure the Python logging
tree for an experiment (file + console) and an ``env.log`` environment
description (package versions, the CUDA devices, git state) for run
forensics.
"""

import logging
import os
import subprocess
import sys

_handlers = []      # the handlers setup_logging added to the root logger


def setup_logging(log_file=None, console_level=logging.INFO,
                  file_level=logging.DEBUG):
    """Root-logger setup: console + optional debug file. A second call
    (a second experiment in one process) replaces the handlers of the
    first instead of adding to them."""
    root = logging.getLogger()
    root.setLevel(logging.DEBUG)
    # Raising the root level to DEBUG makes third-party loggers emit
    # every DEBUG record. Keep DEBUG for our own tree, clamp the
    # known-noisy libraries (the reference achieves the same selectivity
    # via log-config.yaml limiting handlers to speechbrain loggers).
    for noisy in ("torch", "numba", "matplotlib", "PIL"):
        logging.getLogger(noisy).setLevel(logging.WARNING)
    while _handlers:
        handler = _handlers.pop()
        root.removeHandler(handler)
        handler.close()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - "
                            "%(message)s")
    console = logging.StreamHandler()
    console.setLevel(console_level)
    console.setFormatter(fmt)
    _handlers.append(console)
    if log_file is not None:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setLevel(file_level)
        fh.setFormatter(fmt)
        _handlers.append(fh)
    for handler in _handlers:
        root.addHandler(handler)


def get_environment_description():
    """Text snapshot of the software environment (env.log contents)."""
    lines = ["Environment description", "=" * 40]
    lines.append(f"python: {sys.version.split()[0]}")
    for pkg in ("torch", "numpy", "scipy", "yaml"):
        try:
            mod = __import__(pkg)
            lines.append(f"{pkg}: {getattr(mod, '__version__', '?')}")
        except ImportError:
            lines.append(f"{pkg}: not installed")
    try:
        import torch
        lines.append(f"cuda: {torch.version.cuda}")
        lines.append("devices: " + str(
            [torch.cuda.get_device_name(i)
             for i in range(torch.cuda.device_count())]))
    except Exception as e:  # noqa: BLE001 — forensics must not crash
        lines.append(f"devices: unavailable ({e})")
    try:
        git = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, check=False)
        if git.returncode == 0:
            lines.append(f"git: {git.stdout.strip()}")
    except OSError:
        pass
    return "\n".join(lines) + "\n"
