"""Logging and profiling helpers.

Port of ``bpm_analysis_tpu/utils``.  JAX's ``enable_persistent_compile_cache``
has no counterpart: the port's compile cache is ``kernels/build.py``'s
``.torch_build/`` (each CUDA library built once per source hash).
"""
from . import logging as logging_utils, profiling  # noqa: F401
