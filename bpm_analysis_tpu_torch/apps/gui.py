"""Desktop front-end (reference L8a: main.py + gui.py, BPMApp).

Port of ``bpm_analysis_tpu/apps/gui.py`` on the port's host.

Tk/ttk application mirroring the reference's UX: multi-file selection with
auto-discovery of supported audio in the working directory (gui.py:88-115),
an optional global BPM-hint entry, per-file saved-hint auto-load
(gui.py:143-166), and an Analyze button that spawns a daemon worker thread
whose progress flows back over a thread-safe ``queue.Queue`` drained by a
100 ms ``root.after`` poll (gui.py:70-85,172-265) — the same
thread-boundary design, with the analysis itself running on the card (or
on the CPU with ``device="cpu"``) via ``host.analyze_any_file``.

ttkbootstrap is used when installed (the reference styles with its "minty"
theme); plain ttk otherwise.
"""
from __future__ import annotations

import enum
import logging
import os
import queue
import threading
from dataclasses import dataclass
from typing import List, Optional

from ..config import DEFAULT_CONFIG
from ..host import SUPPORTED_EXTENSIONS, analyze_any_file
from ..reports import settings as settings_mod

try:  # pragma: no cover - optional dependency
    import ttkbootstrap as ttkb
    HAVE_TTKBOOTSTRAP = True
except ImportError:  # pragma: no cover
    ttkb = None
    HAVE_TTKBOOTSTRAP = False


class UIMessageType(enum.Enum):
    STATUS = "status"
    ANALYSIS_COMPLETE = "complete"
    ERROR = "error"


@dataclass
class UIMessage:
    type: UIMessageType
    payload: str


class BPMApp:
    """Main window.  Constructed with a Tk root (``python -m
    bpm_analysis_tpu_torch.apps.gui``); ``device`` is where the pipeline
    runs (default: the card)."""

    POLL_MS = 100

    def __init__(self, root, output_directory: str = "processed_files", device=None):
        import tkinter as tk
        from tkinter import filedialog, ttk

        self.tk = tk
        self.filedialog = filedialog
        self.root = root
        self.output_directory = output_directory
        self.device = device
        self.cfg = DEFAULT_CONFIG
        self.log_queue: "queue.Queue[UIMessage]" = queue.Queue()
        self.current_files: List[str] = self._discover_files()
        self.worker: Optional[threading.Thread] = None

        root.title("Heartbeat BPM Analyzer (PyTorch)")
        frame = ttk.Frame(root, padding=10)
        frame.grid(sticky="nsew")
        root.columnconfigure(0, weight=1)
        root.rowconfigure(0, weight=1)

        ttk.Button(frame, text="Select Files…", command=self.select_files).grid(
            row=0, column=0, sticky="w")
        ttk.Label(frame, text="Start BPM hint (blank = auto):").grid(row=0, column=1,
                                                                     padx=(16, 4))
        self.hint_var = tk.StringVar()
        ttk.Entry(frame, textvariable=self.hint_var, width=8).grid(row=0, column=2)
        self.analyze_btn = ttk.Button(frame, text="Analyze", command=self.start_analysis)
        self.analyze_btn.grid(row=0, column=3, padx=(16, 0))

        self.files_list = tk.Listbox(frame, height=10, width=80)
        self.files_list.grid(row=1, column=0, columnspan=4, pady=8, sticky="nsew")
        frame.rowconfigure(1, weight=1)
        for f in self.current_files:
            self.files_list.insert(tk.END, f)

        self.status_var = tk.StringVar(value=f"{len(self.current_files)} file(s) ready")
        ttk.Label(frame, textvariable=self.status_var).grid(row=2, column=0,
                                                            columnspan=4, sticky="w")
        root.after(self.POLL_MS, self._poll_queue)

    # -- file handling -------------------------------------------------------
    def _discover_files(self) -> List[str]:
        return sorted(
            f for f in os.listdir(".")
            if f.lower().endswith(SUPPORTED_EXTENSIONS) and os.path.isfile(f)
        )

    def select_files(self):
        picked = self.filedialog.askopenfilenames(
            filetypes=[("Audio", " ".join("*" + e for e in SUPPORTED_EXTENSIONS)),
                       ("All files", "*.*")])
        if picked:
            self.current_files = list(picked)
            self.files_list.delete(0, self.tk.END)
            for f in self.current_files:
                self.files_list.insert(self.tk.END, f)
            self.status_var.set(f"{len(self.current_files)} file(s) ready")

    # -- worker thread -------------------------------------------------------
    def start_analysis(self):
        if self.worker and self.worker.is_alive():
            return
        if not self.current_files:
            self.status_var.set("No files selected.")
            return
        self.analyze_btn.configure(state="disabled")
        hint_text = self.hint_var.get().strip()
        global_hint = float(hint_text) if hint_text else None
        self.worker = threading.Thread(
            target=self._run_analysis_in_background, args=(list(self.current_files),
                                                           global_hint),
            daemon=True)
        self.worker.start()

    @staticmethod
    def resolve_hint(output_directory: str, path: str, global_hint):
        """Per-file saved hint takes precedence over the global entry —
        reference gui.py:143-166, 213-226."""
        base = os.path.splitext(os.path.basename(path))[0]
        saved = settings_mod.load_hint(output_directory, base)
        return saved if saved is not None else global_hint

    def _run_analysis_in_background(self, files: List[str], global_hint):
        errors = []
        for i, path in enumerate(files):
            base = os.path.splitext(os.path.basename(path))[0]
            self.log_queue.put(UIMessage(
                UIMessageType.STATUS, f"[{i + 1}/{len(files)}] analyzing {base}…"))
            hint = self.resolve_hint(self.output_directory, path, global_hint)
            try:
                result = analyze_any_file(path, self.cfg, hint, self.output_directory,
                                          device=self.device)
                if result is None:
                    errors.append((path, "not enough beats detected"))
            except Exception as e:  # per-file isolation (reference gui.py:247-257)
                logging.exception(f"analysis failed for {path}")
                errors.append((path, str(e)))
        if errors:
            roster = "; ".join(f"{os.path.basename(p)}: {m}" for p, m in errors)
            self.log_queue.put(UIMessage(UIMessageType.ERROR,
                                         f"done with {len(errors)} error(s): {roster}"))
        else:
            self.log_queue.put(UIMessage(
                UIMessageType.ANALYSIS_COMPLETE,
                f"done — artifacts in {self.output_directory}/"))

    def _poll_queue(self):
        try:
            while True:
                msg = self.log_queue.get_nowait()
                self.status_var.set(msg.payload)
                if msg.type in (UIMessageType.ANALYSIS_COMPLETE, UIMessageType.ERROR):
                    self.analyze_btn.configure(state="normal")
        except queue.Empty:
            pass
        self.root.after(self.POLL_MS, self._poll_queue)


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - [%(levelname)s] - %(message)s")
    if HAVE_TTKBOOTSTRAP:  # pragma: no cover
        root = ttkb.Window(themename="minty")
    else:
        import tkinter as tk
        root = tk.Tk()
    BPMApp(root)
    root.mainloop()


if __name__ == "__main__":
    main()
