"""Port vs JAX: stage 4, ``corrections.rhythm_correction``.

The port's batched function (its scan is ``corrections.rhythm_scan_plain``
on the CPU, the plain version of ``csrc/rhythm_scan.cu``) against
``bpm_analysis_tpu.models.corrections.rhythm_correction`` run row by row,
float32 and float64.  The inputs are the S1 lists and envelopes that stage 4
took in the port's pipeline on tests/test_torch_scan_kernels.py's batch
(four one-minute recordings at 302 Hz and rows cut to 0, 1, 2 and 4 raw
peaks), and rows built from them to reach the scan's edges: a neighbour
inside the conflict distance of every third beat, alternately before it
and quieter (the beat replaces it) and after it, quieter or exactly as loud
(it is dropped); an unsorted row (reversed) and one with adjacent beats swapped; counts
0-6 (stage 4 skips rows below 5); and a row whose one short interval is exactly 0.40 x its
median RR (44 and 110 samples at 302 Hz: the tie of the stress pool's id 71, ROADMAP C8),
which float32 rounds below the threshold (the quieter beat is dropped) and float64 does not.
Final positions and counts are equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bpm_analysis_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
from bpm_analysis_tpu.models import corrections as jcorr
from bpm_analysis_tpu_torch.models import corrections as tcorr
from test_torch_scan_kernels import SR, correction_inputs

torch.set_num_threads(1)

NEAR = 70     # samples: inside 0.4 x these recordings' median RR (~0.6 s)
TIE_RR, TIE_SHORT = 110, 44     # samples: 44 / 302 equals 0.40 x 110 / 302 in exact arithmetic


def _edge_rows(pos, count, env):
    """(positions, count, envelope rows) of the rows built to reach the
    scan's edges, and how many beats come after a quieter neighbour (and
    replace it), before one that is not louder (dropped) and before one
    exactly as loud."""
    cap = pos.shape[1]
    n = env.shape[1]
    env = env.copy()
    rows, louder, quieter, tied = [], 0, 0, 0
    for b in range(4):
        c = int(count[b])
        beats = pos[b, :c].tolist()
        extra = []
        for k, p in enumerate(beats[::3]):
            q = p - NEAR // 2 if k % 2 == 0 else min(p + 15, n - 1)
            if q < 0 or env[b, q] >= env[b, p]:
                continue
            if k % 4 == 3:       # as loud as the beat: not louder, dropped
                env[b, q] = env[b, p]
                tied += 1
            louder += q < p      # the beat comes second and is louder: it replaces q
            quieter += q > p     # q comes second and is not louder: dropped
            extra.append(q)
        row = sorted(beats + extra)[:cap]
        rows.append((row, b))
    c0 = int(count[0])
    rows.append((pos[0, :c0].tolist()[::-1], 0))
    swapped = pos[1, :int(count[1])].tolist()
    for i in range(1, len(swapped) - 1, 4):
        swapped[i], swapped[i + 1] = swapped[i + 1], swapped[i]
    rows.append((swapped, 1))
    for k in range(7):
        rows.append((pos[2, :k].tolist(), 2))
    out_pos = np.full((len(rows), cap), n, np.int32)
    out_count = np.zeros(len(rows), np.int32)
    for r, (row, _) in enumerate(rows):
        out_pos[r, :len(row)], out_count[r] = row, len(row)
    return out_pos, out_count, env[[b for _, b in rows]], louder, quieter, tied


def _tie_row(cap, env):
    """(positions, count, envelope) of one row: beats every ``TIE_RR``
    samples, one quieter beat ``TIE_SHORT`` samples after the tenth."""
    beats = list(range(100, 100 + 40 * TIE_RR, TIE_RR))
    extra = beats[9] + TIE_SHORT
    row = np.full(env.shape[1], 100.0, env.dtype)
    row[beats] = 1000.0
    row[extra] = 500.0
    pos = np.full((1, cap), env.shape[1], np.int32)
    pos[0, :41] = sorted(beats + [extra])
    return pos, np.array([41], np.int32), row[None]


@pytest.mark.parametrize("rows", ["pipeline", "edges", "tie"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rhythm_correction_equals_jax(dtype, rows):
    cfg, pos, count, env = correction_inputs(dtype)
    assert (cfg.correction.rr_correction_threshold_pct
            == JAX_CONFIG.correction.rr_correction_threshold_pct)
    pos, count, env = pos.numpy(), count.numpy(), env.numpy()
    if rows == "edges":
        pos, count, env, louder, quieter, tied = _edge_rows(pos, count, env)
        assert louder > 0 and quieter > tied > 0
    elif rows == "tie":
        pos, count, env = _tie_row(pos.shape[1], env)
    got_pos, got_count = tcorr.rhythm_correction(torch.from_numpy(pos),
                                                 torch.from_numpy(count),
                                                 torch.from_numpy(env), SR, cfg)
    fn = jax.jit(lambda p, c, e: jcorr.rhythm_correction(p, c, e, SR, JAX_CONFIG))
    changed = 0
    for b in range(pos.shape[0]):
        exp_pos, exp_count = fn(jnp.asarray(pos[b]), jnp.asarray(count[b]),
                                jnp.asarray(env[b]))
        assert np.asarray(exp_pos).dtype == np.int32
        np.testing.assert_array_equal(got_pos[b].numpy(), np.asarray(exp_pos),
                                      err_msg=f"row {b}")
        assert int(got_count[b]) == int(exp_count), b
        changed += int(exp_count) != int(count[b])
    if rows == "edges":
        assert changed >= 6          # the neighbour and unsorted rows lose slots
    elif rows == "tie":
        assert changed == (dtype == "float32")
