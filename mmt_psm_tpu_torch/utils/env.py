"""Environment report (the port's copy of ``mmt_psm_tpu/utils/env.py``,
after the reference's utils/collect_env.py and utils/env.py).

The JAX module's ``enable_persistent_compilation_cache`` points XLA at an
on-disk cache of compiled programs. The port compiles no XLA program (its
kernels are built once by ``nvcc`` into ``mmt_psm_tpu_torch/_build/``), so
it has no counterpart.
"""

from __future__ import annotations

import platform
import sys


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
