"""Host ingest: the numpy WAV reader/writer (``wav``, an own copy of the JAX
package's) and the ctypes bindings of the native decoder in ``native/``."""
from . import wav  # noqa: F401
