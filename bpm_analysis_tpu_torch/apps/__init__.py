"""Front-ends of the port: the batch CLI (``python -m
bpm_analysis_tpu_torch.apps.cli``), the desktop GUI (``apps.gui``), the web
app (``apps.webapp``, needs gradio) and the ground-truth labeler
(``apps.labeler``)."""
