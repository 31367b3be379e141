"""Measurement scripts for the port's kernels, run on the card as files
(``python3 apex_tpu_torch/tools/<name>.py``); importing this package runs
nothing."""
