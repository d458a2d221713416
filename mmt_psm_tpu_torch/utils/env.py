"""Environment report (the port's copy of ``mmt_psm_tpu/utils/env.py``,
after the reference's utils/collect_env.py and utils/env.py).

The JAX module's ``enable_persistent_compilation_cache`` points XLA at an
on-disk cache of compiled programs. The port compiles no XLA program (its
kernels are built once by ``nvcc`` into ``mmt_psm_tpu_torch/_build/``), so
it has no counterpart.
"""

from __future__ import annotations

import platform
import subprocess
import sys


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them: a card may be set
    below its maximum power and then runs slower under load, so every number
    measured on it is kept beside this line."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def collect_env_info() -> str:
    """One ``name: version`` line each for python, torch with its CUDA, the
    devices and numpy, as the JAX module reports python, jax, its devices
    and its libraries."""
    lines = [f"python: {sys.version.split()[0]} ({platform.platform()})"]
    try:
        import torch

        lines.append(f"torch: {torch.__version__} (CUDA {torch.version.cuda or 'none'})")
        if torch.cuda.is_available():
            lines.append(f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}")
        else:
            lines.append("devices: ['cpu']")
    except ImportError:
        lines.append("torch: not installed")
    try:
        import numpy

        lines.append(f"numpy: {numpy.__version__}")
    except ImportError:
        lines.append("numpy: not installed")
    return "\n".join(lines)
