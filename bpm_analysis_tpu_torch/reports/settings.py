"""Per-file analysis settings persistence (reference
``ReportGenerator.save_analysis_settings`` bpm_analysis.py:790-799 and the
GUI's read-back gui.py:143-166): the only cross-run state is the BPM hint.

An own copy of ``bpm_analysis_tpu/reports/settings.py``: the port imports nothing
of the JAX package."""
from __future__ import annotations

import json
import logging
import os
from typing import Optional


def settings_path(output_directory: str, base_name: str) -> str:
    return os.path.join(output_directory, f"{base_name}_Analysis_Settings.json")


def save(output_directory: str, base_name: str, start_bpm_hint: Optional[float]) -> None:
    path = settings_path(output_directory, base_name)
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"start_bpm_hint": start_bpm_hint}, f, indent=4)
    except OSError as e:
        logging.error(f"Could not save analysis settings file. Error: {e}")


def load_hint(output_directory: str, base_name: str) -> Optional[float]:
    path = settings_path(output_directory, base_name)
    try:
        with open(path, "r", encoding="utf-8") as f:
            v = json.load(f).get("start_bpm_hint")
        return float(v) if v is not None else None
    except (OSError, ValueError, json.JSONDecodeError):
        return None
