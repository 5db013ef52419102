"""The port's remaining front-ends and utils against the JAX package's, on
the CPU (mirrors tests/test_apps.py).

* ``apps/labeler.py``: pairing, range averages, group statistics and the
  labels file equal JAX's on the same labels; the envelope it recomputes
  from a filtered-debug WAV equals JAX's; the HTTP round trip (files, data,
  save, range average).
* ``apps/gui.py``: the saved-hint precedence, and a headless smoke with
  tkinter replaced by stubs — construction, the queue poll, the no-file
  guard, and one analysis through the port's host on the CPU.
* ``apps/webapp.py``: the gated gradio import, the empty batch, the local
  upload cache and the gated HF-Hub upload through an injected stub.
* ``utils/logging.py``: ``summarize`` and ``log_mechanism_firings`` print
  JAX's text on the same float64 result; ``utils/profiling``: a ``span``
  inside ``device_trace`` on the CPU, read back by ``stage_table``.
"""
import dataclasses
import json
import logging
import os
import sys
import threading
import types as pytypes
import urllib.request

import numpy as np
import pytest
import torch

from bpm_analysis_tpu.apps import labeler as jlabeler
from bpm_analysis_tpu.utils import logging as jlogging
from bpm_analysis_tpu_torch import host as thost
from bpm_analysis_tpu_torch import types as ttypes
from bpm_analysis_tpu_torch.apps import labeler as tlabeler
from bpm_analysis_tpu_torch.config import config_from_dict
from bpm_analysis_tpu_torch.io import wav as twav
from bpm_analysis_tpu_torch.models import envelope as tenv
from bpm_analysis_tpu_torch.models import pipeline as tpipe
from bpm_analysis_tpu_torch.reports import settings as tsettings
from bpm_analysis_tpu_torch.utils import logging as tlogging
from bpm_analysis_tpu_torch.utils import profiling as tprofiling

from test_host import SMALL_CFG, _synthetic_wav

torch.set_num_threads(1)

LABELS = [
    {"time": 1.0, "bpm": 100.0, "type": "S1"},
    {"time": 1.3, "bpm": 100.0, "type": "S2"},
    {"time": 2.0, "bpm": 104.0, "type": "S1"},
    {"time": 2.4, "bpm": 104.0, "type": "S2"},
    {"time": 2.9, "bpm": 104.0, "type": "S2"},
    {"time": 9.0, "bpm": 110.0, "type": "S1"},
    {"time": 9.5, "bpm": 110.0, "type": "S2"},
    {"time": 10.1, "bpm": 111.0, "type": "S1"},
    {"time": 10.45, "bpm": 111.0, "type": "S2"},
]


def test_labeler_helpers_equal_jax(tmp_path):
    assert tlabeler.s1_s2_pairs(LABELS) == jlabeler.s1_s2_pairs(LABELS)
    for start, end in ((0.5, 2.5), (3.0, 8.0), (0.0, 20.0), (None, 2.0)):
        assert (tlabeler.avg_delta_t_in_range(LABELS, start, end)
                == jlabeler.avg_delta_t_in_range(LABELS, start, end))
    for gap in (5.0, 0.8):
        assert tlabeler.group_stats(LABELS, gap) == jlabeler.group_stats(LABELS, gap)
    for d, mod in (("t", tlabeler), ("j", jlabeler)):
        os.makedirs(tmp_path / d)
        mod.save_labels(str(tmp_path / d), "rec", LABELS)
    text = (tmp_path / "t" / "rec_labels.csv").read_text()
    assert text == (tmp_path / "j" / "rec_labels.csv").read_text()
    assert tlabeler.load_labels(str(tmp_path / "t"), "rec") == \
        jlabeler.load_labels(str(tmp_path / "j"), "rec")


def _artifacts(directory):
    sig = (np.sin(np.arange(302 * 5) * 0.3) * 1000).astype(np.int16)
    twav.write(str(directory / "rec_filtered_debug.wav"), 302, sig)
    (directory / "rec_bpm_plot.csv").write_text(
        "Time (s),Average BPM\n1.000,100.000\n2.000,101.000\n")


def test_labeler_envelope_and_http_round_trip(tmp_path):
    _artifacts(tmp_path)
    sr, env = tlabeler.load_envelope(str(tmp_path), "rec")
    jsr, jenv_ = jlabeler.load_envelope(str(tmp_path), "rec")
    assert sr == jsr and np.array_equal(env, jenv_)
    assert tlabeler.list_files(str(tmp_path)) == ["rec"]
    assert tlabeler.load_bpm_csv(str(tmp_path), "rec") == jlabeler.load_bpm_csv(str(tmp_path),
                                                                                "rec")

    tlabeler.Handler.directory = str(tmp_path)
    server = tlabeler.ThreadingHTTPServer(("127.0.0.1", 0), tlabeler.Handler)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"

    def post(path, payload):
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        return json.load(urllib.request.urlopen(req, timeout=10))

    try:
        page = urllib.request.urlopen(base + "/", timeout=10).read().decode()
        assert "Heartbeat Labeler" in page
        assert json.load(urllib.request.urlopen(base + "/api/files", timeout=10)) == ["rec"]
        data = json.load(urllib.request.urlopen(base + "/api/data?file=rec", timeout=10))
        assert data["sr"] == sr and len(data["env"]) > 100 and data["bpm_t"] == [1.0, 2.0]
        out = post("/api/save", {"file": "rec", "labels": LABELS})
        assert os.path.exists(out["saved"])
        assert out["groups"] == json.loads(json.dumps(jlabeler.group_stats(LABELS)))
        out = post("/api/range_avg", {"labels": LABELS, "start": 0.5, "end": 2.5})
        exp_dt, exp_bpm, pairs = jlabeler.avg_delta_t_in_range(LABELS, 0.5, 2.5)
        assert out["n_pairs"] == len(pairs) == 2
        np.testing.assert_allclose([out["avg_delta_t"], out["avg_bpm"]], [exp_dt, exp_bpm])
    finally:
        server.shutdown()


def test_gui_hint_precedence(tmp_path):
    from bpm_analysis_tpu_torch.apps.gui import BPMApp

    assert BPMApp.resolve_hint(str(tmp_path), "a/rec.wav", 77.0) == 77.0
    tsettings.save(str(tmp_path), "rec", 123.0)
    assert BPMApp.resolve_hint(str(tmp_path), "a/rec.wav", 77.0) == 123.0
    assert BPMApp.resolve_hint(str(tmp_path), "other.wav", 77.0) == 77.0


class _Var:
    def __init__(self, value=""):
        self.value = value

    def get(self):
        return self.value

    def set(self, value):
        self.value = value


class _Widget:
    def __init__(self, *a, **k):
        self.items, self.config = [], dict(k)

    def grid(self, *a, **k):
        pass

    def columnconfigure(self, *a, **k):
        pass

    rowconfigure = columnconfigure

    def insert(self, index, item):
        self.items.append(item)

    def delete(self, *a):
        self.items.clear()

    def configure(self, **k):
        self.config.update(k)


class _Root(_Widget):
    def __init__(self):
        super().__init__()
        self.scheduled = []

    def title(self, text):
        self.config["title"] = text

    def after(self, ms, fn):
        self.scheduled.append((ms, fn))


@pytest.fixture
def stub_tk(monkeypatch):
    """tkinter, ttk and filedialog replaced by stubs (the suite has no
    display)."""
    tk = pytypes.ModuleType("tkinter")
    tk.StringVar, tk.Listbox, tk.END = _Var, _Widget, "end"
    ttk = pytypes.ModuleType("tkinter.ttk")
    ttk.Frame = ttk.Button = ttk.Label = ttk.Entry = _Widget
    dialog = pytypes.ModuleType("tkinter.filedialog")
    dialog.askopenfilenames = lambda **k: ()
    tk.ttk, tk.filedialog = ttk, dialog
    for name, mod in (("tkinter", tk), ("tkinter.ttk", ttk), ("tkinter.filedialog", dialog)):
        monkeypatch.setitem(sys.modules, name, mod)


def test_gui_headless_smoke(tmp_path, monkeypatch, stub_tk):
    from bpm_analysis_tpu_torch.apps.gui import BPMApp, UIMessage, UIMessageType

    monkeypatch.chdir(tmp_path)
    root = _Root()
    app = BPMApp(root, output_directory=str(tmp_path / "out"), device="cpu")
    assert app.current_files == [] and root.config["title"].startswith("Heartbeat")
    app.log_queue.put(UIMessage(UIMessageType.STATUS, "hello"))
    app._poll_queue()
    assert app.status_var.get() == "hello"
    app.start_analysis()
    assert app.worker is None and "No files" in app.status_var.get()

    src = str(tmp_path / "rec.wav")
    _synthetic_wav(src, seconds=30)
    app.cfg = config_from_dict(dataclasses.asdict(SMALL_CFG))
    app._run_analysis_in_background([src], None)
    app._poll_queue()
    assert app.status_var.get().startswith("done — artifacts in")
    assert app.analyze_btn.config["state"] == "normal"
    assert (tmp_path / "out" / "rec_bpm_plot.csv").exists()


def test_webapp_gated_imports_and_caches(tmp_path, monkeypatch):
    from bpm_analysis_tpu_torch.apps import webapp

    if "gradio" not in sys.modules:
        monkeypatch.setitem(sys.modules, "gradio", None)
        with pytest.raises(SystemExit, match="gradio is not installed"):
            webapp.main()
    status, artifacts, plots, summaries = webapp.process_audio_batch([], 0)
    assert "No files" in status and artifacts == plots == summaries == []

    f = tmp_path / "a.wav"
    f.write_bytes(b"RIFF")
    monkeypatch.setattr(webapp, "UPLOAD_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("HF_TOKEN", raising=False)
    webapp.cache_files([str(f)])
    assert (tmp_path / "cache" / "a.wav").read_bytes() == b"RIFF"
    assert "HF_TOKEN" in webapp.cache_file_remote(str(f), "r/p", None)

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    assert "not installed" in webapp.cache_file_remote(str(f), "r/p", "tok")

    uploads = []

    class _Api:
        def file_exists(self, repo_id, filename, repo_type, token):
            return filename == "cached.wav"

        def upload_file(self, path_or_fileobj, path_in_repo, repo_id, token, repo_type):
            uploads.append((path_or_fileobj, path_in_repo, repo_id, repo_type))

    hub = pytypes.ModuleType("huggingface_hub")
    hub.HfApi = _Api
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    assert webapp.cache_file_remote(str(f), "user/repo", "tok") is None
    assert uploads == [(str(f), "a.wav", "user/repo", "dataset")]
    cached = tmp_path / "cached.wav"
    cached.write_bytes(b"RIFF")
    assert "already cached" in webapp.cache_file_remote(str(cached), "user/repo", "tok")
    assert len(uploads) == 1


def _row_with_mechanisms():
    """One result row with cascade resets and gap corrections in its trace
    (the fields ``log_mechanism_firings`` reads), plus the metrics
    ``summarize`` prints."""
    classes = np.array([ttypes.S1_PAIRED, ttypes.S2_PAIRED, ttypes.S1_CORRECTED_GAP,
                        ttypes.S2_CORRECTED_GAP, ttypes.LONE_S1_CASCADE, ttypes.NOISE,
                        ttypes.S1_CORRECTED_GAP, 0], np.int32)
    pre = classes.copy()
    pre[2], pre[3] = ttypes.LONE_S1_VALIDATED, ttypes.NOISE
    metrics = pytypes.SimpleNamespace(avg_bpm=np.float64(101.26), min_bpm=np.float64(88.04),
                                      max_bpm=np.float64(120.95), avg_rmssdc=np.float64(12.345),
                                      avg_sdnn=np.float64(40.5))
    return pytypes.SimpleNamespace(
        raw_peak_count=np.int32(7), classes=classes, precorrection_classes=pre,
        raw_peak_positions=np.array([100, 190, 410, 505, 700, 811, 900, 0], np.int32),
        final_count=np.int32(5), metrics=metrics)


def _logged(caplog, fn, *args):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        fn(*args)
    return [r.getMessage() for r in caplog.records]


def test_logging_utils_print_jax_text(tmp_path, caplog):
    row = _row_with_mechanisms()
    port = _logged(caplog, tlogging.log_mechanism_firings, row, 302)
    assert port == _logged(caplog, jlogging.log_mechanism_firings, row, 302)
    assert len(port) == 2 and port[0].startswith("CASCADE RESET") and "1.36s" in port[1]
    assert tlogging.summarize(row) == jlogging.summarize(row)

    # A float64 result of the port's pipeline, as tensors and as numpy.
    src = str(tmp_path / "rec.wav")
    _synthetic_wav(src, seconds=30)
    cfg = config_from_dict(dataclasses.asdict(SMALL_CFG))
    _, pcm = twav.read(src)
    env = tenv.preprocess(pcm[None].astype(np.float64), 302, cfg, device="cpu")[0]
    res = thost.tree_row(tpipe.analyze_batch(env, 302, cfg, device="cpu"), 0)
    res_np = thost.to_host(res)
    assert tlogging.summarize(res) == tlogging.summarize(res_np) == jlogging.summarize(res_np)
    assert (_logged(caplog, tlogging.log_mechanism_firings, res, 302)
            == _logged(caplog, jlogging.log_mechanism_firings, res_np, 302))
    with caplog.at_level(logging.INFO):
        caplog.clear()
        tlogging.stage("Stage 1")
        assert caplog.records[-1].getMessage() == "--- Stage 1 ---"


def test_profiling_timed_and_trace(tmp_path):
    with tprofiling.device_trace(str(tmp_path / "trace")) as prof:
        with tprofiling.span("bpm.stage"):
            torch.ones(1000).cumsum(0)
    assert any("cumsum" in e.key for e in prof.key_averages())
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    row = tprofiling.stage_table(events)["bpm.stage"]
    assert row["spans"] == 1 and row["host_ms"] > 0.0
