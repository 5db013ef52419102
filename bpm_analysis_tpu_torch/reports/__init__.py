"""Artifact renderers: own copies of the JAX package's ``reports/`` modules.
They read numpy (a ``PipelineResult`` row after ``host.to_host``) and the
port's ``types``."""
from . import csvout, debug_log, plot, settings, summary, trace  # noqa: F401
