"""Papeval on the host (numpy plus the C++ library ``csrc/papeval.cpp``):
the port's own copies of the JAX package's ``evaluation/instmask.py`` and
``evaluation/pap_eval.py``. Nothing here imports torch."""
