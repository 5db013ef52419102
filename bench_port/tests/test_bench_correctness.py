"""``correct`` comes out false when it should: the control (the program with
its envelope in bfloat16 where the configuration states float32) fails a
limit, and a run whose timed path is broken underneath (half the batch left
out, an answer altered where it is produced) is not correct, while the
sound path is.  CPU, few recordings at their own length."""
import pytest
import torch

from bench_port import core
from bench_port.tests.test_bench_harness import SMALL

SEED = 2**31 + 977


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell):
    result = core.run_cell(cell, SEED, 0.1, False, "cpu", overrides=SMALL[cell], control=True)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["beats_moved_pct"]["value"] > 3 * result["checks"][
        "beats_moved_pct"]["limit"]


def _broken(real, fault):
    def analyze_envelope(envelope, sample_rate, cfg, hints, n_valid=None):
        if fault == "half_batch":
            h = envelope.shape[0] // 2
            return real(envelope[:h], sample_rate, cfg, hints[:h],
                        n_valid=None if n_valid is None else n_valid[:h])
        res = real(envelope, sample_rate, cfg, hints, n_valid=n_valid)
        pos, count = res.final_positions, res.final_count.long()
        slot = torch.arange(pos.shape[1], device=pos.device)[None, :]
        return res._replace(final_positions=torch.where(slot < count[:, None], pos + 1, pos))

    return analyze_envelope


FAULTS = [("fleet-b512", "half_batch"), ("fleet-b512", "altered_answer"),
          ("serial-native-10min", "half_batch"), ("serial-native-10min", "altered_answer")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    from bpm_analysis_tpu_torch.models import pipeline

    monkeypatch.setattr(pipeline, "analyze_envelope", _broken(pipeline.analyze_envelope, fault))
    result = core.run_cell(cell, SEED, 0.1, False, "cpu", overrides=SMALL[cell])
    assert result["correct"] is False, result["checks"]


def test_sound_path_is_correct():
    result = core.run_cell("fleet-b512", SEED, 0.1, False, "cpu", overrides=SMALL["fleet-b512"])
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    assert list(result["checks"])[-1] == "answers_failed"
