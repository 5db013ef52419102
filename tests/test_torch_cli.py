"""The port's CLI, ``bpm_analysis_tpu_torch.apps.cli``, on the CPU.

``main([..., "--device", "cpu"])`` on a synthetic WAV, serial and
``--batch``, at tests/test_host.py's ``SMALL_CFG`` (patched in as the CLI's
default configuration, as tests/test_conversion.py does for the JAX CLI);
the printed line in the JAX CLI's format; the flags against the JAX CLI's;
the saved-hint precedence.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from bpm_analysis_tpu.apps import cli as jcli
from bpm_analysis_tpu_torch.apps import cli as tcli
from bpm_analysis_tpu_torch.config import config_from_dict
from bpm_analysis_tpu_torch.reports import settings as tsettings

from test_host import SMALL_CFG, _synthetic_wav

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)


@pytest.fixture
def small_cli(monkeypatch):
    monkeypatch.setattr(tcli, "DEFAULT_CONFIG", config_from_dict(dataclasses.asdict(SMALL_CFG)))


def _options(parser):
    return {opt for action in parser._actions for opt in action.option_strings}


def test_flags_are_the_jax_clis_without_dp_with_device():
    jax_flags, port_flags = _options(jcli.build_parser()), _options(tcli.build_parser())
    assert port_flags == jax_flags | {"--device"}
    args = tcli.build_parser().parse_args(["a.wav"])
    assert args.device == "cuda" and args.dtype is None and args.batch_size == 128
    assert args.dp == 0


@pytest.mark.parametrize("batch", [False, True], ids=["serial", "batch"])
def test_main_on_cpu_prints_the_jax_line(tmp_path, capsys, small_cli, batch):
    src = str(tmp_path / "rec.wav")
    _synthetic_wav(src)
    out = str(tmp_path / "out")
    argv = [src, "--output-dir", out, "--device", "cpu", "--dtype", "float64"]
    assert tcli.main(argv + (["--batch"] if batch else [])) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1
    line = printed[0]
    assert line.startswith(f"{src}: ") and " beats, avg/min/max BPM " in line
    assert line.endswith(f"-> {out}/rec_*")
    beats = int(line.split(": ")[1].split(" beats")[0])
    assert beats > 50
    for suffix in ("_bpm_plot.csv", "_bpm_plot.html", "_Analysis_Summary.md",
                   "_Debug_Log.md", "_Analysis_Settings.json", "_filtered_debug.wav"):
        assert (tmp_path / "out" / f"rec{suffix}").exists(), suffix


def test_print_result_is_the_jax_clis(capsys):
    """The same result row through both CLIs' ``print_result`` prints the
    same line, and a missing report the same message."""
    from bpm_analysis_tpu_torch.models.analytics import Metrics

    metrics = Metrics(*[None] * len(Metrics._fields))._replace(
        avg_bpm=np.float32(101.26), min_bpm=np.float32(88.04), max_bpm=np.float32(120.95))
    row = type("Row", (), {"final_count": np.int32(67), "metrics": metrics})()
    for result in (row, None):
        tcli.print_result("a/rec.wav", result, "out")
        jcli.print_result("a/rec.wav", result, "out")
        port, jax_line = capsys.readouterr().out.strip().splitlines()
        assert port == jax_line


def test_saved_hint_takes_precedence(tmp_path, small_cli):
    """A per-file hint saved in ``{base}_Analysis_Settings.json`` wins over
    ``--bpm-hint``; other files keep the global hint; ``--no-saved-hints``
    ignores the saved one.  The hint used is what the run saves."""
    out = tmp_path / "out"
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    _synthetic_wav(a, seconds=20)
    _synthetic_wav(b, seconds=20, bpm=90.0)
    out.mkdir()
    tsettings.save(str(out), "a", 123.0)

    def saved(base):
        return json.loads((out / f"{base}_Analysis_Settings.json").read_text())[
            "start_bpm_hint"]

    argv = ["--output-dir", str(out), "--device", "cpu", "--bpm-hint", "77"]
    assert tcli.main([a, b, *argv]) == 0
    assert saved("a") == 123.0 and saved("b") == 77.0
    assert tcli.main([a, *argv, "--no-saved-hints", "--batch"]) == 0
    assert saved("a") == 77.0


def test_errors_are_reported_per_file(tmp_path, capsys, small_cli):
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav")
    assert tcli.main([bad, "--output-dir", str(tmp_path / "out"), "--device", "cpu"]) == 1
    assert f"{bad}: " in capsys.readouterr().err


def test_no_card_is_reported_before_any_file(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tcli.main([str(tmp_path / "rec.wav"), "--output-dir", str(tmp_path)]) == 2
    assert "--device cpu" in capsys.readouterr().err
