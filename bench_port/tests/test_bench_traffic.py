"""The generators: deterministic per seed, every seed the same recordings
of the pool in another order, and each recording bit for bit the port's
synthetic recording of its id."""
import wave

import numpy as np

from bench_port.reference import upstream
from bench_port.traffic import fleet, native, synth


def test_fleet_recording_equals_the_ports():
    from bpm_analysis_tpu_torch import synth as port

    mine = synth.quantize_int16(synth.synth_recording(77))
    assert len(mine) == port.N_SAMPLES
    np.testing.assert_array_equal(mine, port._quantize_int16(port.synth_recording(77)))


def test_native_recording_equals_the_ports():
    from bpm_analysis_tpu_torch import synth as port

    np.testing.assert_array_equal(synth.synth_recording_native(5), port.synth_recording_native(5))


def test_fleet_make_permutes_the_pool(tmp_path):
    params = {"pool": "synth-302hz", "batch": 128, "batches": 2}
    a = fleet.make(params, 2**40 + 99, str(tmp_path))
    b = fleet.make(params, 2**40 + 99, str(tmp_path))
    c = fleet.make(params, 2**40 + 100, str(tmp_path))
    pool = sorted(upstream.pool("synth-302hz").ids)
    assert a["ids"] == b["ids"] != c["ids"]
    assert a["ids"][0] != a["ids"][1]
    for ids in a["ids"] + c["ids"]:
        assert sorted(ids) == pool
    assert [x.shape for x in a["batches"]] == [(128, 181_200)] * 2
    for x, y, ids in zip(a["batches"], b["batches"], a["ids"]):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x[5], synth.quantize_int16(synth.synth_recording(ids[5])))


def test_fleet_batch_above_the_pool_repeats_it(tmp_path):
    out = fleet.make({"pool": "synth-302hz", "batch": 300, "batches": 1}, 7, str(tmp_path))
    ids = out["ids"][0]
    assert len(ids) == 300 and sorted(ids[:128]) == sorted(ids[128:256])
    assert set(ids[256:]) <= set(ids[:128]) and len(set(ids[256:])) == 44


def test_native_make_writes_the_pools_wavs(tmp_path):
    params = {"pool": "synth-native-44k", "files": 2}
    a = native.make(params, 2**35 + 7, str(tmp_path / "a"), workers=2)
    b = native.make(params, 2**35 + 7, str(tmp_path / "b"), workers=2)
    assert a["ids"] == b["ids"] and set(a["ids"]) <= set(upstream.pool("synth-native-44k").ids)
    for pa, pb, rid in zip(a["paths"], b["paths"], a["ids"]):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()
        with wave.open(pa) as w:
            assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (44100, 1, 2)
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        np.testing.assert_array_equal(pcm, synth.quantize_int16(synth.synth_recording_native(rid)))
