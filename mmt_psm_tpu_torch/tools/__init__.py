"""Command-line entry points of the port (``python -m mmt_psm_tpu_torch.tools.<name>``)."""
