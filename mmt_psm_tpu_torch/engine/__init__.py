"""The serving path: ``inference.run_inference`` (device stage, host paste,
Papeval), ``predictor.CellDemo``, and the host modules ``paste`` and
``_eval_worker`` (numpy only)."""
