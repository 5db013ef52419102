"""The upstream analyzer's answers of a pool of recordings
(``answers/<pool>.npz``, made by ``freeze.py``)."""
import functools
import os
from types import SimpleNamespace

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def pool(name: str) -> SimpleNamespace:
    """``ids``, ``rate``, ``post_rate``, ``minutes``, ``generator`` and
    ``answer(id)``: {"positions", "bpm_times", "bpm"} of the recording."""
    with np.load(os.path.join(HERE, "answers", f"{name}.npz")) as z:
        a = {k: z[k] for k in z.files}
    index = {int(i): j for j, i in enumerate(a["ids"])}

    def answer(rid: int) -> dict:
        j = index[int(rid)]
        b0, b1 = a["beat_offsets"][j:j + 2]
        s0, s1 = a["bpm_offsets"][j:j + 2]
        return {"positions": a["positions"][b0:b1], "bpm_times": a["bpm_times"][s0:s1],
                "bpm": a["bpm_values"][s0:s1]}

    return SimpleNamespace(ids=[int(i) for i in a["ids"]], rate=int(a["rate"]),
                           post_rate=int(a["post_rate"]), minutes=float(a["minutes"]),
                           generator=str(a["generator"]), answer=answer)
