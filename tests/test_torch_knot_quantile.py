"""Port vs JAX: the knot-domain rolling quantile (the plain version of the
CUDA kernel), its wrapper, and the noise floor that calls it.

The plain version is held against the JAX ``rolling_quantile_knots`` and
against the TPU kernel itself in Pallas interpret mode, on the cases of
tests/test_knot_kernel.py, at that file's tolerance (rtol 3e-6, atol 1e-3,
equal NaN positions).  The CUDA kernel itself runs only on a card:
tests/test_torch_cuda.py."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
import chip_smoke
from bpm_analysis_tpu.config import DEFAULT_CONFIG
from bpm_analysis_tpu.models import envelope as jenv
from bpm_analysis_tpu.models import noise_floor as jnf
from bpm_analysis_tpu.ops import find_peaks as jfp
from bpm_analysis_tpu.ops import knot_quantile as jkq
from bpm_analysis_tpu.ops.pallas import knot_kernel as jkk
from bpm_analysis_tpu_torch.config import config_from_dict
from bpm_analysis_tpu_torch.kernels import build
from bpm_analysis_tpu_torch.models import noise_floor as tnf
from bpm_analysis_tpu_torch.ops import find_peaks as tfp
from bpm_analysis_tpu_torch.ops import knot_quantile as tkq

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)

RTOL, ATOL = 3e-6, 1e-3

# The kernel cases of chip_smoke.py (those of tests/test_knot_kernel.py and
# the engine shapes); the engine shapes are too slow for JAX on the CPU.
CASES = [c for c in chip_smoke.kernel_cases() if c[0] != "engine_shapes"]


def _plain(case, dtype=torch.float32):
    _, pos, val, cnt, n, window, stride, ms, nv = case
    return tkq.rolling_quantile_knots(
        torch.from_numpy(pos), torch.from_numpy(val), torch.from_numpy(cnt), n, window, 0.2,
        min_periods=3, stride=stride, min_spacing=ms,
        n_valid=None if nv is None else torch.from_numpy(nv), dtype=dtype).numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_knots(case):
    _, pos, val, cnt, n, window, stride, ms, nv = case
    got = _plain(case)
    exp = np.stack([np.asarray(jkq.rolling_quantile_knots(
        jnp.asarray(pos[r]), jnp.asarray(val[r]), int(cnt[r]), n, window, 0.2, min_periods=3,
        stride=stride, min_spacing=ms, n_valid=None if nv is None else int(nv[r])))
        for r in range(pos.shape[0])])
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL, equal_nan=True)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_kernel_interpret(case):
    _, pos, val, cnt, n, window, stride, ms, nv = case
    got = _plain(case)
    exp = np.asarray(jkk.knot_quantile_anchors_pallas(
        jnp.asarray(pos), jnp.asarray(val), jnp.asarray(cnt), n, window, 0.2, min_periods=3,
        stride=stride, min_spacing=ms, n_valid=None if nv is None else jnp.asarray(nv),
        interpret=True))
    np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL, equal_nan=True)
    if case[0] == "no_knots":
        assert np.isnan(got).all()


def test_plain_float64_matches_jax_exactly_enough():
    """float64 (the CPU parity dtype of the pipeline tests): same knots,
    float64 descent on both sides."""
    case = CASES[0]
    _, pos, val, cnt, n, window, stride, ms, _ = case
    got = _plain(case, dtype=torch.float64)
    exp = np.stack([np.asarray(jkq.rolling_quantile_knots(
        jnp.asarray(pos[r]), jnp.asarray(val[r].astype(np.float64)), int(cnt[r]), n, window,
        0.2, min_periods=3, stride=stride, min_spacing=ms, dtype=jnp.float64))
        for r in range(pos.shape[0])])
    np.testing.assert_allclose(got, exp, rtol=1e-12, equal_nan=True)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    case = CASES[0]
    _, pos, val, cnt, n, window, stride, ms, _ = case
    before = build.launches["knot_quantile"]
    got = tkq.knot_quantile_anchors_f32(torch.from_numpy(pos), torch.from_numpy(val),
                                        torch.from_numpy(cnt), n, window, 0.2, min_periods=3,
                                        stride=stride, min_spacing=ms).numpy()
    assert build.launches["knot_quantile"] == before   # no kernel launch on the CPU
    np.testing.assert_array_equal(got, _plain(case))
    with pytest.raises(ValueError):
        tkq.knot_quantile_anchors_f32(torch.from_numpy(pos).to("meta"), torch.from_numpy(val),
                                      torch.from_numpy(cnt), n, window, 0.2)


def test_anchors_at_matches_jax():
    rng = np.random.RandomState(9)
    anchors = rng.randn(2, 40)
    query = rng.randint(-5, 40 * 8 + 5, size=(2, 30))
    nv = np.array([40 * 8 - 3, 200])
    got = tkq.anchors_at(torch.from_numpy(anchors), torch.from_numpy(query), 40 * 8, 8,
                         n_valid=torch.from_numpy(nv)).numpy()
    got_nv = tkq.anchors_at(torch.from_numpy(anchors), torch.from_numpy(query), 40 * 8,
                            8).numpy()
    for r in range(2):
        exp = jkq.anchors_at(jnp.asarray(anchors[r]), jnp.asarray(query[r]), 40 * 8, 8,
                             n_valid=int(nv[r]))
        np.testing.assert_array_equal(got[r], np.asarray(exp))
        exp = jkq.anchors_at(jnp.asarray(anchors[r]), jnp.asarray(query[r]), 40 * 8, 8)
        np.testing.assert_array_equal(got_nv[r], np.asarray(exp))


def test_noise_floor_matches_jax_pallas_backend():
    """The module that holds the kernel: the port's noise floor on its
    kernel backend ("auto": the plain version for CPU tensors) against the
    JAX floor on the Pallas kernel in interpret mode, float32, 60 s."""
    n = 302 * 60
    xs = np.stack([bench._quantize_int16(bench.synth_recording(s)[:n]).astype(np.float32)
                   for s in (2, 3)])
    cfg = dataclasses.replace(DEFAULT_CONFIG, runtime=dataclasses.replace(
        DEFAULT_CONFIG.runtime, max_raw_peaks=512, max_troughs=512, max_candidates=256,
        noise_quantile_stride=64, quantile_backend="knots_pallas", dtype="float32"))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    ext_cap = cfg.runtime.find_peaks_work_factor * cfg.runtime.max_raw_peaks

    @jax.jit
    def jax_floor(x):
        env = jenv.preprocess(x, 302, cfg)[0]
        return env, jnf.dynamic_noise_floor(env, 302, cfg,
                                            extrema=jfp.build_extrema(env, ext_cap))

    for r in range(2):
        env, exp = jax_floor(jnp.asarray(xs[r]))
        env_t = torch.from_numpy(np.array(env))[None]
        got = tnf.dynamic_noise_floor(env_t, 302, tcfg,
                                      extrema=tfp.build_extrema(env_t, ext_cap))
        np.testing.assert_array_equal(got.trough_positions.numpy()[0],
                                      np.asarray(exp.trough_positions))
        assert int(got.trough_count[0]) == int(exp.trough_count)
        assert bool(got.overflowed[0]) == bool(exp.overflowed)
        np.testing.assert_allclose(got.floor.numpy()[0], np.asarray(exp.floor),
                                   rtol=RTOL, atol=ATOL)
