"""Front-ends of the port: the batch CLI (``python -m
bpm_analysis_tpu_torch.apps.cli``)."""
