"""Port vs JAX: band-pass filtfilt and preprocessing; package helpers and
guards (config carry-over, the synthetic generator, the import rule, the
device rule).

Filter and envelope run in float64 on both sides at rtol 1e-9 (the parity
bound tests/test_filter.py holds the JAX filter to against scipy)."""
import ast
import dataclasses
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from bpm_analysis_tpu import config as jcfg
from bpm_analysis_tpu.models import envelope as jenv
from bpm_analysis_tpu.ops import filter as jfilter
from bpm_analysis_tpu_torch import config as tcfg
from bpm_analysis_tpu_torch import synth
from bpm_analysis_tpu_torch.models import envelope as tenv
from bpm_analysis_tpu_torch.models import pipeline as tpipe
from bpm_analysis_tpu_torch.ops import filter as tfilter

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)

SR = 302
REPO = pathlib.Path(__file__).resolve().parents[1]


def _recordings(seconds: int, seeds=(0, 1)) -> np.ndarray:
    n = SR * seconds
    return np.stack([bench._quantize_int16(bench.synth_recording(s)[:n]).astype(np.float64)
                     for s in seeds])


@pytest.mark.parametrize("seconds", [3, 60])
def test_bandpass_filtfilt_matches_jax(seconds):
    xs = _recordings(seconds)
    got = tfilter.bandpass_filtfilt(torch.from_numpy(xs), SR, 20.0, 150.0, 2).numpy()
    exp = np.stack([np.asarray(jfilter.bandpass_filtfilt(jnp.asarray(x), SR, 20.0, 150.0, 2))
                    for x in xs])
    np.testing.assert_allclose(got, exp, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("seconds", [3, 60])
def test_preprocess_matches_jax(seconds):
    xs = _recordings(seconds)
    cfg = jcfg.DEFAULT_CONFIG
    env, filt, rate = tenv.preprocess(xs, SR, tcfg.config_from_dict(dataclasses.asdict(cfg)),
                                      device="cpu")
    assert rate == SR and env.dtype == torch.float64
    exp = [jenv.preprocess(jnp.asarray(x), SR, cfg) for x in xs]
    np.testing.assert_allclose(env.numpy(), np.stack([np.asarray(e[0]) for e in exp]),
                               rtol=1e-9)
    np.testing.assert_allclose(filt.numpy(), np.stack([np.asarray(e[1]) for e in exp]),
                               rtol=1e-9, atol=1e-9)


def test_preprocess_masked_matches_jax():
    """Mixed-length batch: each row's valid prefix equals the JAX masked run."""
    xs = _recordings(3)
    nv = np.array([xs.shape[1], xs.shape[1] - 137], np.int32)
    cfg = jcfg.DEFAULT_CONFIG
    env, _, _, nv_dec = tenv.preprocess(xs, SR, tcfg.config_from_dict(dataclasses.asdict(cfg)),
                                        n_valid=nv, device="cpu")
    exp = jax.vmap(lambda x, v: jenv.preprocess(x, SR, cfg, n_valid=v)[0])(
        jnp.asarray(xs), jnp.asarray(nv))
    exp = np.asarray(exp)
    np.testing.assert_array_equal(nv_dec.numpy(), nv)
    for b in range(2):
        np.testing.assert_allclose(env.numpy()[b, :nv[b]], exp[b, :nv[b]], rtol=1e-9)


def test_synth_is_bench_generator():
    for seed in (0, 7):
        a = synth.synth_recording(seed)
        b = bench.synth_recording(seed)
        assert a.dtype == b.dtype and np.array_equal(a.view(np.int32), b.view(np.int32))
        np.testing.assert_array_equal(synth._quantize_int16(a), bench._quantize_int16(b))


@pytest.mark.parametrize("which", ["default", "engine"])
def test_config_from_dict_round_trips(which):
    if which == "default":
        src = jcfg.DEFAULT_CONFIG
    else:
        src = bench._bench_cfg(64, "auto", prom_factor=2.5, raw_peaks=2560, residual=512,
                               raw_candidates=16384, candidates=1536, troughs=2560,
                               extrema_capacity=22016)
    d = dataclasses.asdict(src)
    port = tcfg.config_from_dict(d)
    assert dataclasses.asdict(port) == d
    assert hash(port) == hash(tcfg.config_from_dict(d))
    with pytest.raises(TypeError):
        tcfg.config_from_dict({**d, "bogus": {}})


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_reference_bench_or_pandas():
    files = sorted((REPO / "bpm_analysis_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    banned = ("jax", "bpm_analysis_tpu", "bench", "pandas")
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in banned, f"{path.relative_to(REPO)} imports {mod}"


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.AnalyzerConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenv.preprocess(np.zeros((1, 600), np.float32), SR, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.analyze_batch(np.zeros((1, 600), np.float32), SR, cfg)
    env = tenv.preprocess(np.zeros((1, 600), np.float32), SR, cfg, device="cpu")[0]
    assert env.device.type == "cpu"
