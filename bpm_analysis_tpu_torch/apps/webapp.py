"""Web front-end (reference L8b: hugging-face-space/app.py, Gradio Blocks).

Port of ``bpm_analysis_tpu/apps/webapp.py`` on the port's host; the
analysis runs on the card.

Mirrors the reference Space: multi-file upload, a BPM-hint slider (0 = auto),
a batch loop with per-file error collection, and tabs for the produced
artifacts (downloads, per-file plot selection, per-file summary).  Gradio is
optional; importing this module without it works, and ``main()`` raises a
clear error.

The reference also caches every upload to a HF dataset repo when
``HF_TOKEN`` is set (app.py:14-36).  Both persistence hooks exist here:
``UPLOAD_CACHE_DIR`` copies uploads to a local directory, and the remote
HF-Hub upload runs when ``HF_TOKEN`` is set *and* huggingface_hub is
importable (gated; tests/test_torch_apps.py exercises it through an
injected stub).
"""
from __future__ import annotations

import logging
import os
import shutil
from typing import List, Optional

from ..config import DEFAULT_CONFIG
from ..host import analyze_any_file

OUTPUTS_DIR = "processed_files"
UPLOAD_CACHE_DIR = os.environ.get("UPLOAD_CACHE_DIR")
# Reference app.py:12 — the dataset repo uploads are checkpointed to.
UPLOAD_REPO_ID = os.environ.get("UPLOAD_REPO_ID", "WolfExplode/processed_files")


def cache_file_remote(local_path: str, repo_id: str, auth_token: Optional[str]
                      ) -> Optional[str]:
    """HF-dataset upload checkpoint, mirroring the reference's ``Cache_files``
    (hugging-face-space/app.py:14-36): skip without a token, skip files
    already cached, return a status string on skip/failure and None on
    success."""
    if not auth_token:
        return "Cache skipped: HF_TOKEN not available."
    try:
        from huggingface_hub import HfApi
    except ImportError:
        return "Cache skipped: huggingface_hub not installed."
    api = HfApi()
    filename = os.path.basename(local_path)
    try:
        if api.file_exists(repo_id=repo_id, filename=filename,
                           repo_type="dataset", token=auth_token):
            return "File already cached"
        api.upload_file(path_or_fileobj=local_path, path_in_repo=filename,
                        repo_id=repo_id, token=auth_token, repo_type="dataset")
        return None
    except Exception as e:
        return f"Caching failed. Error: {e}"


def cache_files(paths: List[str]) -> None:
    """Upload-persistence hooks: local directory copy + gated HF-Hub upload."""
    if UPLOAD_CACHE_DIR:
        os.makedirs(UPLOAD_CACHE_DIR, exist_ok=True)
        for p in paths:
            try:
                shutil.copy(p, UPLOAD_CACHE_DIR)
            except OSError as e:
                logging.warning(f"upload cache copy failed for {p}: {e}")
    token = os.environ.get("HF_TOKEN")
    if token:
        for p in paths:
            msg = cache_file_remote(p, UPLOAD_REPO_ID, token)
            if msg:
                logging.info(f"{os.path.basename(p)}: {msg}")


def process_audio_batch(files, bpm_hint: float):
    """Batch worker mirroring app.py:39-95.  Returns (status_text,
    artifact_paths, plot_html_paths, summary_paths)."""
    if not files:
        return "No files uploaded.", [], [], []
    paths = [getattr(f, "name", f) for f in files]
    cache_files(paths)
    hint = float(bpm_hint) or None
    status, artifacts, plots, summaries = [], [], [], []
    for path in paths:
        base = os.path.splitext(os.path.basename(path))[0]
        try:
            result = analyze_any_file(path, DEFAULT_CONFIG, hint, OUTPUTS_DIR)
            if result is None:
                status.append(f"{base}: not enough beats detected")
                continue
            status.append(f"{base}: OK ({int(result.final_count)} beats)")
            for suffix in ("_bpm_plot.csv", "_Analysis_Summary.md", "_Debug_Log.md",
                           "_Analysis_Settings.json", "_bpm_plot.html"):
                p = os.path.join(OUTPUTS_DIR, f"{base}{suffix}")
                if os.path.exists(p):
                    artifacts.append(p)
            plots.append(os.path.join(OUTPUTS_DIR, f"{base}_bpm_plot.html"))
            summaries.append(os.path.join(OUTPUTS_DIR, f"{base}_Analysis_Summary.md"))
        except Exception as e:
            logging.exception(f"analysis failed for {path}")
            status.append(f"{base}: ERROR {e}")
    return "\n".join(status), artifacts, plots, summaries


def build_app():  # pragma: no cover - requires gradio
    import gradio as gr

    with gr.Blocks(title="Heartbeat BPM Analyzer (PyTorch)") as app:
        gr.Markdown("# Heartbeat BPM Analyzer — PyTorch/CUDA build")
        with gr.Row():
            files = gr.File(file_count="multiple", label="Audio recordings")
            hint = gr.Slider(0, 200, value=0, step=1,
                             label="Starting BPM hint (0 = auto)")
        run = gr.Button("Run Analysis")
        status = gr.Textbox(label="Status", lines=6)
        with gr.Tab("Artifacts"):
            artifacts = gr.File(file_count="multiple", label="Download outputs")
        with gr.Tab("Plots"):
            plot_select = gr.Dropdown(label="Recording", choices=[])
            plot_view = gr.HTML()
        with gr.Tab("Summaries"):
            summary_select = gr.Dropdown(label="Recording", choices=[])
            summary_view = gr.Markdown()

        state_plots = gr.State([])
        state_summaries = gr.State([])

        def _run(fs, h):
            text, arts, plots, summaries = process_audio_batch(fs, h)
            names = [os.path.basename(p) for p in plots]
            return (text, arts, gr.update(choices=names), gr.update(choices=names),
                    plots, summaries)

        run.click(_run, [files, hint],
                  [status, artifacts, plot_select, summary_select,
                   state_plots, state_summaries])

        def select_plot(name, plots):
            for p in plots:
                if os.path.basename(p) == name and os.path.exists(p):
                    with open(p) as f:
                        return f.read()
            return "<p>not found</p>"

        def select_summary(name, summaries):
            want = name.replace("_bpm_plot.html", "_Analysis_Summary.md") if name else ""
            for p in summaries:
                if os.path.basename(p) == os.path.basename(want) and os.path.exists(p):
                    with open(p) as f:
                        return f.read()
            return "*not found*"

        plot_select.change(select_plot, [plot_select, state_plots], plot_view)
        summary_select.change(select_summary, [summary_select, state_summaries],
                              summary_view)
    return app


def main():  # pragma: no cover
    try:
        import gradio  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment; the web front-end "
            "requires it (pip install gradio)"
        ) from e
    build_app().launch()


if __name__ == "__main__":
    main()
