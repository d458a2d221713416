"""Settings of the benchmark's tests, made before any test touches the card.

The float8 control (``perfbench/control.py``, ``reference/lower.py``) makes
float32 temporaries the size of the C4 stage-5 head's input at the cell's
batch of 16. With fixed segments the caching allocator leaves ~24 GB of the
card reserved and unused between them and the control runs out of memory;
growable segments keep them from fragmenting it. A caller's own setting
stands.
"""

import os

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
