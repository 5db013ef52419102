"""The port's dp-sharded batched front-end, ``host_batch.analyze_files_batched(
mesh=...)``, and the CLI's ``--dp``, on gloo ranks on the CPU.

Held to tests/test_host_batch_mesh.py's contract for the JAX package: on its
mixed-length mini-fleet (two length buckets, so a chunk of two rows split
over the ranks and a chunk of one row whose padding row rank 1 skips), the
artifacts of two ranks equal the unsharded port run's (CSV, summary and
settings byte-equal without the timestamp lines, the debug log but for one
0.1 quantum on its amplitude display lines).  Both ranks return the same
roster, equal to the unsharded one, errors included (a file that does not
convert and one that does not probe); each rank's lanes count only its own
chunks; a rank that raises makes every rank raise.  ``--batch --dp 2 --device cpu`` prints what ``--dp 1`` prints.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import _torch_rank_bodies as bodies
from bpm_analysis_tpu_torch import host_batch as thb
from bpm_analysis_tpu_torch.apps import cli as tcli
from bpm_analysis_tpu_torch.config import config_from_dict
from bpm_analysis_tpu_torch.parallel import mesh as tmesh

from test_host import SMALL_CFG, _synthetic_wav
from test_host_batch import ARTIFACTS, CFG as JAX_CFG, _assert_log_equal, _normalized, make_wav

torch.set_num_threads(1)

CFG = config_from_dict(dataclasses.asdict(JAX_CFG))
SECONDS = [21.0, 34.5, 22.8]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    src = d / "src"
    src.mkdir()
    files = []
    for i, sec in enumerate(SECONDS):
        p = str(src / f"rec{i}.wav")
        make_wav(p, sec, seed=70 + i, bpm=92.0 + 8 * i)
        files.append(p)
    bad = str(src / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav at all")
    mp3 = str(src / "take.mp3")
    with open(mp3, "wb") as f:
        f.write(b"\xff\xfb\x90\x00")
    inputs = [files[0], bad, files[1], mp3, files[2]]
    plain = thb.analyze_files_batched(inputs, CFG, str(d / "plain"), max_batch=4,
                                      min_bucket=1 << 13, device="cpu")
    ranks = tmesh.spawn(bodies.host_mesh_rank, 2, "gloo", "cpu", inputs, CFG,
                        str(d / "mesh"), 4, 1 << 13)
    return d, files, inputs, plain, ranks


@pytest.mark.parametrize("suffix", ARTIFACTS)
def test_mesh_artifacts_match_unsharded(runs, suffix):
    d, files = runs[0], runs[1]
    for i in range(len(files)):
        a = str(d / "plain" / f"rec{i}{suffix}")
        b = str(d / "mesh" / f"rec{i}{suffix}")
        assert os.path.exists(a) and os.path.exists(b), (a, b)
        if suffix == "_Debug_Log.md":
            _assert_log_equal(a, b, f"rec{i}{suffix}")
        else:
            assert _normalized(a) == _normalized(b), f"artifact mismatch: rec{i}{suffix}"


def test_mesh_roster_equals_unsharded_on_every_rank(runs):
    d, files, inputs, (results, errors), ranks = runs
    assert [p for p, _ in errors] == [inputs[3], inputs[1]]    # conversion, then probe
    errors = [(p, msg.replace(str(d / "plain"), str(d / "mesh"))) for p, msg in errors]
    for roster, rank_errors, _, _ in ranks:
        assert rank_errors == errors
        assert list(roster) == list(results) and set(roster) == set(files)
        for p in files:
            count = int(results[p].final_count)
            assert count > 10
            np.testing.assert_array_equal(roster[p], results[p].final_positions[:count])
    # Chunk 1 (rec0, rec2) splits one row per rank; chunk 2 (rec1) is rank 0's.
    assert [lanes["chunks"] for _, _, lanes, _ in ranks] == [2.0, 1.0]


def test_a_failing_rank_raises_on_every_rank(runs):
    """Rank 1's device program raises: both ranks leave the call with the
    same RuntimeError naming rank 1's failure, none waits on the other."""
    failures = [failure for _, _, _, failure in runs[4]]
    assert failures[0] == failures[1]
    assert failures[0].startswith("rank 1 failed:") and "injected failure" in failures[0]


def test_cli_dp2_prints_what_dp1_prints(tmp_path, capfd, monkeypatch):
    monkeypatch.setattr(tcli, "DEFAULT_CONFIG", config_from_dict(dataclasses.asdict(SMALL_CFG)))
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    _synthetic_wav(a, seconds=30)
    _synthetic_wav(b, seconds=30, bpm=90.0)
    lines = {}
    for dp in (1, 2):
        out = str(tmp_path / f"out{dp}")
        argv = [a, b, "--output-dir", out, "--device", "cpu", "--batch", "--dp", str(dp),
                "--no-saved-hints"]
        assert tcli.main(argv) == 0
        printed = capfd.readouterr().out.strip().splitlines()
        lines[dp] = [line.replace(out, "OUT") for line in printed]
    assert len(lines[1]) == 2 and lines[1][0].startswith(f"{a}: ")
    assert lines[2] == lines[1]
