"""Measurement aids for the port's kernels; each runs on one NVIDIA GPU as
``python3 -m instruct_tpu_torch.tools.<name>``."""
