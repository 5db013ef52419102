"""Port vs JAX: the scale-out layer (``parallel/mesh.py``, ``parallel/seqshard.py``)
on gloo ranks on the CPU.

One world of 8 ranks is spawned for the whole module
(``_torch_rank_bodies.parallel_cases``) and every case reads its results:

* ``make_mesh`` reshapes a 4-rank group (as a list of ranks, and as the
  process group on its members) into (4, 1), (1, 4) and (2, 2), and the
  world into (8, 1);
* ``analyze_batch_sharded`` + ``gather_result`` on the (4, 1) mesh, one
  recording per rank, at a small float64 configuration: every integer
  field equals the port's local ``analyze_batch`` and JAX's
  ``pipeline.analyze_batch`` on the same envelopes; floats agree at rtol
  1e-12 with the local run and at tests/test_torch_pipeline.py's rtol 1e-8
  with JAX;
* ``fleet_summary`` against JAX's ``fleet_summary`` of JAX's local result:
  counts equal, the four float reductions at rtol 1e-12 (the port and JAX
  agree to the last bits in float64, not bit for bit);
* the three sequence-sharded functions at sp=4 and sp=8, single and
  batched, in float64 against JAX's local functions at
  tests/test_sharding.py's tolerances; the envelope and the quantile are
  also bit-equal to the port's local functions; one case of each against
  JAX's ``seqshard`` on the virtual 8-device mesh; and the float32
  filtfilt within ``F32_FILTFILT_BOUND`` of the port's local float32
  filtfilt.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_rank_bodies as bodies
import bench
from bpm_analysis_tpu.config import DEFAULT_CONFIG
from bpm_analysis_tpu.models import pipeline as jpipe
from bpm_analysis_tpu.ops import filter as jfilter
from bpm_analysis_tpu.ops import quantile as jquantile
from bpm_analysis_tpu.ops import rolling as jrolling
from bpm_analysis_tpu.parallel import mesh as jmesh
from bpm_analysis_tpu.parallel import seqshard as jseqshard
from bpm_analysis_tpu_torch.config import config_from_dict
from bpm_analysis_tpu_torch.models import envelope as tenv
from bpm_analysis_tpu_torch.models import pipeline as tpipe
from bpm_analysis_tpu_torch.ops import filter as tfilter
from bpm_analysis_tpu_torch.ops import quantile as tquantile
from bpm_analysis_tpu_torch.ops import rolling as trolling
from bpm_analysis_tpu_torch.parallel import mesh as tmesh
from bpm_analysis_tpu_torch.parallel import seqshard as tseqshard

torch.set_num_threads(1)

SR = bodies.SR
SEEDS = (0, 1, 2, 3)
# The float32 sharded filtfilt against the local float32 filtfilt: the relay
# re-blocks the recurrence (blocks of 151 samples at sp=8 and sp=4, against
# the local 256), so float32 rounding differs; measured up to 2.3e-6 of the
# output's peak on these inputs.
F32_FILTFILT_BOUND = tseqshard.FLOAT32_FILTFILT_BOUND
JAX_CFG = dataclasses.replace(DEFAULT_CONFIG, runtime=dataclasses.replace(
    DEFAULT_CONFIG.runtime, max_raw_peaks=256, max_troughs=256, max_candidates=128,
    extrema_capacity=2048, noise_quantile_stride=64, quantile_backend="knots",
    dtype="float64"))
CFG = config_from_dict(dataclasses.asdict(JAX_CFG))


def _leaves(tree, prefix=""):
    for name in tree._fields:
        v = getattr(tree, name)
        if hasattr(v, "_fields"):
            yield from _leaves(v, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", v


def _inputs():
    batch = np.stack([bench._quantize_int16(bench.synth_recording(s)[:SR * 30])
                      .astype(np.float64) for s in SEEDS])
    envelopes = tenv.preprocess(batch, SR, CFG, device="cpu")[0].numpy()
    rng = np.random.RandomState(5)
    signal = rng.randn(2, SR * 40) * 100                       # 12080 = 8 x 1510
    series = np.abs(rng.randn(2, 6016)) * 10                   # 6016 = 8 x 752
    series[rng.rand(*series.shape) < 0.05] = np.nan
    return envelopes, signal, series


@pytest.fixture(scope="module")
def world():
    """The ranks' results, and JAX's local ``analyze_batch`` of the same
    envelopes, computed here while the ranks run."""
    envelopes, signal, series = _inputs()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tmesh.spawn, bodies.parallel_cases, 8, "gloo", "cpu",
                            envelopes, CFG, signal, series)
        # One jit around the whole batch: op-by-op it takes ~3x as long.
        jax_local = jax.block_until_ready(jax.jit(
            lambda e: jpipe.analyze_batch(e, SR, JAX_CFG))(jnp.asarray(envelopes)))
        return envelopes, signal, series, ranks.result(), jax_local


@pytest.fixture(scope="module")
def jax_local(world):
    return world[4]


def test_make_mesh_reshapes_the_ranks(world):
    ranks = world[3]
    for r, out in enumerate(ranks):
        assert out["rank"] == r
        shapes = out["shapes"]
        assert shapes["world"] == (8, 1, r, 0)
        if r < 4:
            assert shapes[1] == (4, 1, r, 0)
            assert shapes[4] == (1, 4, 0, r)
            assert shapes[2] == shapes["group"] == (2, 2, r // 2, r % 2)
        else:
            assert shapes[1] is shapes[4] is shapes[2] is shapes["group"] is None


def test_analyze_batch_sharded_matches_local_and_jax(world, jax_local):
    envelopes, ranks = world[0], world[3]
    assert [out.get("local_rows") for out in ranks] == [1, 1, 1, 1] + [None] * 4
    local = tpipe.analyze_batch(envelopes, SR, CFG, device="cpu")
    gathered = dict(_leaves(ranks[0]["gathered"]))
    for r in (1, 2, 3):
        for name, v in _leaves(ranks[r]["gathered"]):
            np.testing.assert_array_equal(v, gathered[name], err_msg=name)
    jax_leaves = dict(_leaves(jax_local))
    assert int(np.asarray(gathered["final_count"]).min()) > 20
    for name, ref in _leaves(local):
        got, ref = gathered[name], ref.numpy()
        exp_jax = np.asarray(jax_leaves[name])
        assert got.shape == ref.shape, name
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(got, ref, rtol=1e-12, equal_nan=True, err_msg=name)
            np.testing.assert_allclose(got, exp_jax, rtol=1e-8, atol=1e-9, equal_nan=True,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
            np.testing.assert_array_equal(got, exp_jax.astype(got.dtype), err_msg=name)


def test_fleet_summary_matches_jax(world, jax_local):
    ranks = world[3]
    exp = {k: float(v) for k, v in jmesh.fleet_summary(None, jax_local).items()}
    assert exp["recordings_ok"] == len(SEEDS)
    for out in ranks[:4]:
        got = out["fleet"]
        assert got["recordings_ok"] == exp["recordings_ok"]
        assert got["total_beats"] == exp["total_beats"]
        for key in ("mean_avg_bpm", "min_bpm", "max_bpm", "mean_hrr"):
            np.testing.assert_allclose(got[key], exp[key], rtol=1e-12, err_msg=key)
        assert got == ranks[0]["fleet"]


def _jax_local(name, x):
    if name == "envelope":
        fn = lambda v: jrolling.rolling_mean_centered(jnp.abs(v), bodies.ENV_WINDOW)  # noqa: E731
    elif name == "filtfilt":
        fn = lambda v: jfilter.bandpass_filtfilt(v, SR, *bodies.FILTER_BAND)  # noqa: E731
    else:
        fn = lambda v: jquantile.rolling_quantile_centered_strided(v, **bodies.QUANTILE)  # noqa: E731
    return np.stack([np.asarray(fn(jnp.asarray(row))) for row in x])


def _port_local(name, x):
    t = torch.from_numpy(x)
    if name == "envelope":
        return trolling.rolling_mean_centered(t.abs(), bodies.ENV_WINDOW).numpy()
    if name == "filtfilt":
        return tfilter.bandpass_filtfilt(t, SR, *bodies.FILTER_BAND).numpy()
    return tquantile.rolling_quantile_centered_strided(t, **bodies.QUANTILE).numpy()


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("sp", [4, 8])
@pytest.mark.parametrize("name", ["envelope", "filtfilt", "quantile"])
def test_seqshard_float64_matches_local_and_jax(world, name, sp, batched):
    _, signal, series, ranks, _ = world
    x = series if name == "quantile" else signal
    x = x if batched else x[:1]
    got = ranks[0]["seqshard"][sp][(name, batched, "float64")]
    got = got if batched else got[None]
    for out in ranks[1:]:
        np.testing.assert_array_equal(out["seqshard"][sp][(name, batched, "float64")],
                                      ranks[0]["seqshard"][sp][(name, batched, "float64")])
    exp = _jax_local(name, x)
    if name == "filtfilt":
        # tests/test_sharding.py: the relay's blocks differ from the serial
        # blocking, so rounding differs at ~1e-12.
        np.testing.assert_allclose(got, exp, rtol=1e-9, atol=1e-9 * float(np.abs(exp).max()))
    else:
        np.testing.assert_allclose(got, exp, rtol=1e-12, equal_nan=True)
        assert np.array_equal(got, _port_local(name, x), equal_nan=True), \
            f"{name} at sp={sp} is not bit-equal to the port's local function"


@pytest.mark.parametrize("name", ["envelope", "filtfilt", "quantile"])
def test_seqshard_matches_jax_seqshard(world, name):
    """sp=4, one recording: the port's sharded function against JAX's
    ``seqshard`` on four virtual CPU devices, at tests/test_sharding.py's
    tolerances."""
    _, signal, series, ranks, _ = world
    devices = jax.devices()
    if len(devices) < 4:
        pytest.skip("needs 4 virtual devices")
    m = jmesh.make_mesh(devices[:4], sp=4)
    if name == "envelope":
        exp = jseqshard.sequence_sharded_envelope(m, jnp.asarray(signal[0]), bodies.ENV_WINDOW)
    elif name == "filtfilt":
        exp = jseqshard.sequence_sharded_bandpass_filtfilt(m, jnp.asarray(signal[0]), SR,
                                                           *bodies.FILTER_BAND)
    else:
        exp = jseqshard.sequence_sharded_rolling_quantile(m, jnp.asarray(series[0]),
                                                          **bodies.QUANTILE)
    exp = np.asarray(exp)
    got = ranks[0]["seqshard"][4][(name, False, "float64")]
    atol = 1e-9 * float(np.abs(exp).max()) if name == "filtfilt" else 0.0
    np.testing.assert_allclose(got, exp, rtol=1e-9 if name == "filtfilt" else 1e-12,
                               atol=atol, equal_nan=True)


@pytest.mark.parametrize("sp", [4, 8])
def test_seqshard_float32(world, sp):
    """In float32 the envelope and the quantile stay bit-equal to the port's
    local functions; the filtfilt is within ``F32_FILTFILT_BOUND`` of the
    signal's peak of the local float32 filtfilt."""
    _, signal, series, ranks, _ = world
    out = ranks[0]["seqshard"][sp]
    sig32, ser32 = signal.astype(np.float32), series.astype(np.float32)
    for name, x in (("envelope", sig32), ("quantile", ser32)):
        assert np.array_equal(out[(name, True, "float32")], _port_local(name, x),
                              equal_nan=True), name
    exp = _port_local("filtfilt", sig32)
    err = float(np.abs(out[("filtfilt", True, "float32")] - exp).max())
    assert err <= F32_FILTFILT_BOUND * float(np.abs(exp).max()), err


def test_spawn_needs_a_card_unless_cpu_and_picks_the_backend(monkeypatch):
    assert tmesh.default_backend(4, "cpu") == "gloo"
    with pytest.raises(ValueError, match="NCCL needs a card per rank"):
        tmesh.spawn(bodies.failing_rank, 2, "nccl", "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.spawn(bodies.failing_rank, 2)


def test_a_failing_rank_ends_the_world(monkeypatch):
    """Rank 1 raises while rank 0 waits in a barrier: the launcher ends
    rank 0 after the grace period and raises with rank 1's traceback."""
    monkeypatch.setattr(tmesh, "FAILURE_GRACE_S", 1)
    with pytest.raises(RuntimeError, match="rank one fails") as info:
        tmesh.spawn(bodies.failing_rank, 2, "gloo", "cpu")
    assert "rank 1 failed" in str(info.value)
