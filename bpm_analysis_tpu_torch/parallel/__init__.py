from . import mesh, seqshard  # noqa: F401
