"""The ``exact-f64`` configuration and its cell: every engine cell hands the
program rows in its configuration's dtype (``envelope.preprocess`` keeps its
input's dtype, so float32 rows would run a float64 configuration in
float32 without an error); ``exact-f64`` runs the exact floor and differs
from ``engine-302hz`` only in stride and dtype; the exact floor's readers
give None without their span and known numbers on a hand-made trace; the
cell is correct on the CPU and its bfloat16 control is not."""
import importlib

import numpy as np
import pytest

from bench_port import core, trace
from bench_port.tests.test_bench_metrics import run_of
from bench_port.tests.test_bench_span_metrics import ev, hand_trace, span

CELL = "exact-f64-b256"
SEED = 2**31 + 4099
SMALL = {"traffic": {"batch": 2, "batches": 1}, "warmup_calls": 1}
ENGINE_CELLS = [w["name"] for w in core.load_json(core.ROOT, "BENCHMARK.json")["workloads"]
                if core.cell_spec(w["name"]).workload["entry"]["kind"] == "engine"]
READERS = ("exact_floor_device_ms.engine", "exact_floor_launches_per_call.engine")


@pytest.mark.parametrize("cell", ENGINE_CELLS)
def test_engine_rows_have_the_configurations_dtype(cell, tmp_path):
    spec = core.cell_spec(cell)
    traffic = importlib.import_module(f"bench_port.traffic.{spec.workload['traffic']['kind']}")
    params = core.merged(spec.workload["traffic"], {"batch": 3, "batches": 1})
    batches = traffic.make(params, SEED, str(tmp_path))["batches"]
    want = np.dtype(spec.config["runtime"]["dtype"])
    assert all(b.dtype == want for b in batches), (cell, [b.dtype for b in batches], want)


def test_exact_f64_is_engine_302hz_at_stride_one_in_float64():
    from bpm_analysis_tpu_torch.models import noise_floor

    exact = core.load_json(core.HERE, "configs", "exact-f64.json")
    engine = core.load_json(core.HERE, "configs", "engine-302hz.json")
    assert noise_floor.quantile_path(core.program_config(exact["runtime"])) == "exact"
    changed = {k for k in engine["runtime"] if engine["runtime"][k] != exact["runtime"][k]}
    assert changed == {"noise_quantile_stride", "dtype"}
    assert set(exact["runtime"]) == set(engine["runtime"]) and exact["reduced"] == {}
    assert (exact["runtime"]["noise_quantile_stride"], exact["runtime"]["dtype"]) == (1, "float64")


def exact_trace():
    """``hand_trace`` with two exact-floor spans inside its first noise
    floor: the first holds three launches (10 + 10 + 4 us of kernels, one
    of them ``hand_trace``'s own ``k_floor``) and a memset (3 us), the
    second one launch (6 us); a launch on thread 2 inside the second span's
    time does not belong to it."""
    return hand_trace() + [
        span("bpm.rolling_exact", 121, 40), span("bpm.rolling_exact.build", 122, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 123, 2, 21), ev("kernel", "k_tree", 126, 10, 21),
        ev("cuda_runtime", "cudaLaunchKernel", 150, 2, 22), ev("kernel", "k_sel", 153, 4, 22),
        ev("cuda_runtime", "cudaMemsetAsync", 155, 2, 23), ev("gpu_memset", "Memset", 158, 3, 23),
        span("bpm.rolling_exact", 165, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 170, 2, 24), ev("kernel", "k_sel", 175, 6, 24),
        ev("cuda_runtime", "cudaLaunchKernel", 180, 2, 25, tid=2),
        ev("kernel", "k_other_thread", 185, 7, 25),
    ]


def test_exact_floor_readers_give_known_numbers():
    run = run_of(trace.Trace(exact_trace(), calls=2))
    assert core.reader("exact_floor_device_ms.engine")(run) == pytest.approx(
        (10 + 10 + 4 + 3 + 6) / 2 * 1e-3)
    assert core.reader("exact_floor_launches_per_call.engine")(run) == 4 / 2


@pytest.mark.parametrize("name", READERS)
def test_exact_floor_readers_without_their_span(name):
    assert core.reader(name)(run_of(None)) is None
    assert core.reader(name)(run_of(trace.Trace(hand_trace(), calls=2))) is None


def test_sound_exact_cell_is_correct():
    result = core.run_cell(CELL, SEED, 0.1, False, "cpu", overrides=SMALL)
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    assert result["checks"]["beats_moved_pct"]["value"] == 0.0


def test_exact_cell_control_fails():
    result = core.run_cell(CELL, SEED, 0.1, False, "cpu", overrides=SMALL, control=True)
    assert result["correct"] is False, result["checks"]
