"""Logging / observability (reference: logging setup at bpm_analysis.py:50-54
and main.py:12-16, stage banners at :1629,1739,1756, mechanism firings at
:166,295).

Port of ``bpm_analysis_tpu/utils/logging.py`` on the port's ``types``.  The
pipeline runs without per-decision prints, so the mechanism log lines are
replayed post hoc from the structured trace: after a run,
:func:`log_mechanism_firings` reports the cascade-reset and correction
events the reference logged as they happened.  Both functions take one
recording's result row (numpy or tensors)."""
from __future__ import annotations

import logging
import sys

import numpy as np

from .. import types

FORMAT = "%(asctime)s - [%(levelname)s] - %(message)s"


def setup(level=logging.INFO) -> None:
    logging.basicConfig(level=level, format=FORMAT, stream=sys.stdout)


def stage(msg: str) -> None:
    logging.info(f"--- {msg} ---")


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def log_mechanism_firings(result, sample_rate: int) -> None:
    """Post-hoc replay of the reference's mechanism log lines from the
    structured trace (cascade resets: bpm_analysis.py:295-296; gap/conflict
    corrections: :1366,1402)."""
    n = int(result.raw_peak_count)
    classes = _np(result.classes)[:n]
    pre = _np(result.precorrection_classes)[:n]
    pos = _np(result.raw_peak_positions)[:n]
    for i in np.nonzero(pre == types.LONE_S1_CASCADE)[0]:
        logging.info(
            f"CASCADE RESET: Forcing peak at {pos[i] / sample_rate:.2f}s as Lone S1 "
            f"due to repeated rhythmic failures."
        )
    for i in np.nonzero((classes == types.S1_CORRECTED_GAP) & (pre != classes))[0]:
        logging.info(f"Gap correction: re-labeled S1/S2 pair at {pos[i] / sample_rate:.2f}s.")


def summarize(result) -> str:
    m = result.metrics
    return (
        f"{int(result.final_count)} beats; "
        f"BPM avg/min/max {float(m.avg_bpm):.1f}/{float(m.min_bpm):.1f}/{float(m.max_bpm):.1f}; "
        f"RMSSDc {float(m.avg_rmssdc):.2f}; SDNN {float(m.avg_sdnn):.2f} ms"
    )
