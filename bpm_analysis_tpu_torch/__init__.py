"""PyTorch/CUDA port of the batched heartbeat analysis engine.

The JAX package ``bpm_analysis_tpu`` is the reference; this package mirrors
its module layout (``ops/``, ``models/``) with functions over tensors that
carry a leading batch axis.  Entry points (``models.envelope.preprocess``,
``models.pipeline.analyze_batch``) run on CUDA unless the caller passes
``device="cpu"``.
"""
