"""Fleet traffic in a stated dtype: ``fleet.make``'s batches cast to the
traffic's ``dtype`` parameter, which a cell sets to its configuration's
``runtime.dtype`` (the engine entry hands the rows over as they are, and
``envelope.preprocess`` keeps its input's dtype).  The cast is exact: the
rows hold int16 values."""
import numpy as np

from . import fleet


def make(params: dict, seed: int, workdir: str) -> dict:
    """``fleet.make``'s result with every batch in ``params["dtype"]``."""
    out = fleet.make(params, seed, workdir)
    out["batches"] = [b.astype(np.dtype(params["dtype"])) for b in out["batches"]]
    return out
