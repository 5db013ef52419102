"""The blocked filter kernel's three phases (``csrc/block_filter.cu``),
emulated in numpy on the CPU and held bit for bit against their plain
versions, and the sequence-sharded relay through the phase entry points.

The kernel runs only on a card (tests/test_torch_cuda.py).  The emulation
repeats its order of work:

* contributions: tiles of 64 L-blocks a CTA, each tile staged with scalar
  loads up to the first 16-byte boundary, 16-byte loads, then scalar loads
  (the three index sets must cover the tile once, whatever the row's
  alignment); one thread's m accumulators over the block's samples in
  ascending order;
* the carry scan: chunks of 64 steps staged lane by lane, one chain of
  ``S0 @ A_L^T + C[k]`` in ascending term order;
* apply: a thread per 4 consecutive outputs of a block over a sliding
  window of x behind 4 zeros, every chain run to the lag count of the
  thread's last output (the extra terms multiply the padding's zeros), the
  lags h zero past L - 2; then ``(b0 x + S0 @ G^T) + t``.

Against ``ops/filter.BlockFilter``'s pieces and ``ops/filter.lfilter_plain``,
float32 and float64, on chip_smoke.py's filter cases (the engine length cut
to two rows of 20,000 samples: 79 blocks, a tile edge that does not divide
them) and a block-length edge.  The relay test runs
``parallel/seqshard.sequence_sharded_bandpass_filtfilt``'s ranks as threads
of this process with the exchanges through a barrier, once as it is and once
with the phase entry points replaced by the emulation.
"""
import threading
import types

import numpy as np
import pytest
import torch

import chip_smoke
from bpm_analysis_tpu_torch.ops import filter as tfilter
from bpm_analysis_tpu_torch.kernels import build
from bpm_analysis_tpu_torch.parallel import seqshard

torch.set_num_threads(1)

TILE, CHUNK, R = 64, 64, 4     # the kernel's kTile, kChunk, kR
WARP = 32
CUT = (2, 20000)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _assert_bits_equal(got, exp, msg=""):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.dtype == exp.dtype and got.shape == exp.shape, msg
    np.testing.assert_array_equal(_bits(got), _bits(exp), err_msg=msg)


def _cases():
    """chip_smoke.filter_cases() cut to CPU size, plus a row of exactly one
    block and one of a block and one sample."""
    out = []
    for name, b, a, x, zi in chip_smoke.filter_cases():
        if x.size > 100_000:
            x, zi = np.ascontiguousarray(x[:CUT[0], :CUT[1]]), zi[:CUT[0]]
        out.append((name, b, a, x, zi))
    rng = np.random.RandomState(5)
    b, a = tfilter.butter_bandpass(2, 20.0, 150.0, 302)
    for name, n in (("one_block", 256), ("block_and_one", 257)):
        x = (rng.randn(3, n) * 500).astype(np.float32)
        out.append((name, b, a, x, (tfilter.lfilter_zi(b, a)[None, :] * x[:, :1]
                                    ).astype(np.float32)))
    return out


CASES = _cases()


class Tables:
    """The wrapper's table rows as numpy arrays of the working dtype."""

    def __init__(self, bf):
        self.U = bf.U.numpy()
        self.GT = bf.GT.numpy()
        self.A_LT = bf.A_LT.numpy()
        self.L, self.m = self.U.shape
        npd = self.U.dtype.type
        self.h = np.zeros(self.L + R, npd)                 # zero past L - 2
        self.h[:self.L - 1] = np.asarray(bf.h, npd)
        self.b0 = npd(bf.b0)


def stage_indices(addr: int, itemsize: int, valid: int, length: int):
    """The tile indices that stage_tile's three loops write, in loop order,
    for a source at byte address ``addr``; checks the 16-byte loads'
    alignment."""
    V = 16 // itemsize
    mis = (addr % 16) // itemsize
    head = min(valid, (V - mis) % V)
    nvec = (valid - head) // V
    if nvec:
        assert (addr + head * itemsize) % 16 == 0
    tail = head + nvec * V
    return (list(range(head)) + [head + v * V + q for v in range(nvec) for q in range(V)]
            + list(range(tail, length)))


def emulate_contributions(x: np.ndarray, n: int, tb: Tables) -> np.ndarray:
    """(B, nb, m) from the rows of ``x`` (B, n), buffer-aligned."""
    bsz = x.shape[0]
    L, m = tb.L, tb.m
    nb = -(-n // L)
    C = np.zeros((bsz, nb, m), x.dtype)
    flat = x.reshape(-1)
    for r in range(bsz):
        for k0 in range(0, nb, TILE):
            nblk = min(TILE, nb - k0)
            g0 = k0 * L
            valid, length = min(nblk * L, n - g0), nblk * L
            idx = stage_indices((r * n + g0) * x.itemsize, x.itemsize, valid, length)
            assert sorted(idx) == list(range(length))
            tile = np.zeros(length, x.dtype)
            i = np.asarray(idx)
            src = flat[r * n + g0 + np.minimum(i, valid - 1)]
            tile[i] = np.where(i < valid, src, x.dtype.type(0))
            rows = tile.reshape(nblk, L)          # thread t: rows[t]
            acc = rows[:, 0:1] * tb.U[0]
            for s in range(1, L):
                acc = acc + rows[:, s:s + 1] * tb.U[s]
            C[r, k0:k0 + nblk] = acc
    return C


def emulate_carry(C: np.ndarray, s: np.ndarray, tb: Tables):
    """(exit state, S0): lane 0's chain over chunks staged lane by lane."""
    bsz, nb, m = C.shape
    flat = C.reshape(bsz, -1)
    total = nb * m
    per = CHUNK * m // WARP
    S0 = np.zeros_like(C)
    a = tb.A_LT
    for c in range(-(-nb // CHUNK)):
        buf = np.zeros((bsz, CHUNK * m), C.dtype)
        for i in range(per):
            v = c * CHUNK * m + i * WARP + np.arange(WARP)
            buf[:, i * WARP:(i + 1) * WARP] = np.where(
                v < total, flat[:, np.minimum(v, total - 1)], C.dtype.type(0))
        for u in range(min(CHUNK, nb - c * CHUNK)):
            ns = np.empty_like(s)
            for j in range(m):
                acc = s[:, 0] * a[0, j]
                for q in range(1, m):
                    acc = acc + s[:, q] * a[q, j]
                ns[:, j] = acc + buf[:, u * m + j]
            S0[:, c * CHUNK + u] = s
            s = ns
    return s, S0


def emulate_apply(x: np.ndarray, n: int, S0: np.ndarray, tb: Tables) -> np.ndarray:
    """(B, n) outputs: every (row, block, thread) at once, each thread's
    chains masked past its own lag count."""
    bsz = x.shape[0]
    L, m = tb.L, tb.m
    nb = -(-n // L)
    zero = x.dtype.type(0)
    xp = np.zeros((bsz, nb * L), x.dtype)
    xp[:, :n] = x
    xs = np.zeros((bsz, nb, L + 2 * R), x.dtype)            # R zeros, block, R zeros
    xs[:, :, R:R + L] = xp.reshape(bsz, nb, L)
    valid = np.minimum(L, n - np.arange(nb) * L)            # per block
    threads = -(-L // R)
    i0 = np.arange(threads) * R
    live = i0[None, :] < valid[:, None]                     # (nb, threads)
    # X[j] for j (threads,); below -R only where a thread has stopped.
    gather = lambda j: xs[:, :, np.maximum(R + j, 0)]       # noqa: E731
    w = np.stack([gather(i0 + q - 1) for q in range(R)], axis=-1)   # (B, nb, thr, R)
    t = np.zeros_like(w)
    nd = i0 + R - 1
    for d in range(int(nd.max())):
        run = (d < nd)[None, None, :, None] & live[None, :, :, None]
        t = np.where(run, t + w * tb.h[d], t)
        w = np.concatenate([gather(i0 - 2 - d)[..., None], w[..., :-1]], axis=-1)
    y = np.zeros((bsz, nb, threads * R), x.dtype)
    for q in range(R):
        i = np.minimum(i0 + q, L - 1)
        p = S0[:, :, 0:1] * tb.GT[0, i]
        for j in range(1, m):
            p = p + S0[:, :, j:j + 1] * tb.GT[j, i]
        y[:, :, i0 + q] = (tb.b0 * gather(i) + p) + t[..., q]
    keep = (i0[None, :, None] + np.arange(R)) < valid[:, None, None]   # (nb, thr, R)
    y = np.where(keep.reshape(nb, -1)[None], y, zero)[:, :, :L]
    return y.reshape(bsz, -1)[:, :n]


def _filter_of(b, a, x):
    n = x.shape[1]
    L = min(256, max(8, n))
    bf = tfilter.BlockFilter.build(b, a, L, torch.from_numpy(x).dtype, "cpu")
    return bf, L, -(-n // L)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_filter_kernel_emulation_equals_plain_version(case):
    name, b, a, x, zi = case
    bf, L, nb = _filter_of(b, a, x)
    tb = Tables(bf)
    n = x.shape[1]
    C = emulate_contributions(x, n, tb)
    s_exit, S0 = emulate_carry(C, zi.copy(), tb)
    y = emulate_apply(x, n, S0, tb)
    _assert_bits_equal(y, tfilter.lfilter_plain(b, a, torch.from_numpy(x),
                                                torch.from_numpy(zi)).numpy(), name)
    # Phase by phase against BlockFilter's pieces (the entry points' plain versions).
    X = torch.nn.functional.pad(torch.from_numpy(x), (0, nb * L - n)).reshape(-1, nb, L)
    C_exp = bf.contributions(X)
    _assert_bits_equal(C, C_exp.numpy(), name)
    s_exp, S0_exp = bf.carry_scan(C_exp, torch.from_numpy(zi))
    _assert_bits_equal(S0, S0_exp.numpy(), name)
    _assert_bits_equal(s_exit, s_exp.numpy(), name)
    _assert_bits_equal(emulate_apply(X.reshape(X.shape[0], -1).numpy(), nb * L, S0, tb),
                       bf.apply(X, S0_exp).reshape(X.shape[0], -1).numpy(), name)


def test_filter_cases_reach_each_edge():
    """A row shorter than a block, a ragged last block, a tile edge, both
    dtypes and 2-6 states, and rows whose starts are not 16-byte aligned."""
    names = {c[0]: c for c in CASES}
    assert names["short_rows"][3].shape[1] < 8
    shapes = [(c[3].shape[1], c[3].dtype, len(c[2]) - 1) for c in CASES]
    assert any(n % 256 and n > 256 for n, _, _ in shapes)
    assert any(-(-n // 256) % TILE and -(-n // 256) > TILE for n, _, _ in shapes)
    assert {np.dtype(np.float32), np.dtype(np.float64)} == {d for _, d, _ in shapes}
    assert {2, 4, 6} <= {m for _, _, m in shapes}
    assert any((n * np.dtype(d).itemsize) % 16 for n, d, _ in shapes)


def test_phase_wrappers_take_the_plain_pieces_on_the_cpu():
    _, b, a, x, zi = CASES[1]
    bf, L, nb = _filter_of(b, a, x)
    X = torch.nn.functional.pad(torch.from_numpy(x), (0, nb * L - x.shape[1])).reshape(-1, nb, L)
    before = build.launches.copy()
    C = tfilter.contributions(bf, X)
    s, S0 = tfilter.carry_scan(bf, C, torch.from_numpy(zi))
    y = tfilter.apply(bf, X, S0)
    assert build.launches == before
    C_exp = bf.contributions(X)
    s_exp, S0_exp = bf.carry_scan(C_exp, torch.from_numpy(zi))
    for got, exp in ((C, C_exp), (s, s_exp), (S0, S0_exp), (y, bf.apply(X, S0_exp))):
        assert torch.equal(got, exp)


# ---------------------------------------------------------------------------
# The sequence-sharded relay through the phase entry points
# ---------------------------------------------------------------------------

class _ThreadRow:
    """The sp ranks of one row as threads: each exchange posts this rank's
    tensor and returns every rank's, in rank order."""

    def __init__(self, sp: int):
        self.barrier = threading.Barrier(sp)
        self.slots = [None] * sp

    def exchange(self, mesh, t):
        self.slots[mesh.sp_index] = t
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


def _sharded(x: torch.Tensor, sp: int, monkeypatch, phases=None):
    """The sharded filtfilt of ``x`` (B, n) with sp thread ranks, gathered;
    ``phases`` replaces ``ops/filter``'s phase entry points."""
    row = _ThreadRow(sp)
    monkeypatch.setattr(seqshard, "all_gather",
                        lambda mesh, t, axis="dp": torch.stack(row.exchange(mesh, t)))

    def all_reduce(mesh, t, op=None, axis="dp"):
        parts = row.exchange(mesh, t)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    monkeypatch.setattr(seqshard, "all_reduce", all_reduce)
    for name, fn in (phases or {}).items():
        monkeypatch.setattr(tfilter, name, fn)
    blk = x.shape[1] // sp
    out, errors = [None] * sp, []

    def rank(i):
        try:
            mesh = types.SimpleNamespace(sp=sp, sp_index=i)
            out[i] = seqshard.sequence_sharded_bandpass_filtfilt(
                mesh, x[:, i * blk:(i + 1) * blk], 302, 20.0, 150.0, batched=True)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)
            row.barrier.abort()

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return torch.cat(out, dim=1)


def _emulated_phases(calls):
    def contributions(bf, X):
        calls.append("contributions")
        bsz, nb, L = X.shape
        return torch.from_numpy(emulate_contributions(X.reshape(bsz, -1).numpy(), nb * L,
                                                      Tables(bf)))

    def carry_scan(bf, C, s):
        calls.append("carry_scan")
        s_out, S0 = emulate_carry(C.numpy(), s.numpy().copy(), Tables(bf))
        return torch.from_numpy(s_out), torch.from_numpy(S0)

    def apply(bf, X, S0):
        calls.append("apply")
        bsz, nb, L = X.shape
        y = emulate_apply(X.reshape(bsz, -1).numpy(), nb * L, S0.numpy(), Tables(bf))
        return torch.from_numpy(y).reshape(bsz, nb, L)

    return {"contributions": contributions, "carry_scan": carry_scan, "apply": apply}


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sharded_relay_runs_the_phase_entry_points(sp, dtype, monkeypatch):
    """The relay calls ``ops/filter``'s phase entry points (each rank one
    contributions and one apply a pass, its carry scan once a pass), and
    with the entry points replaced by the kernel's emulation it gives the
    same bits as through the plain pieces."""
    rng = np.random.RandomState(11)
    n = 2 * 3 * 2416                     # blocks of 2416 / 3 at sp=2 / 4: L = 151
    x = torch.from_numpy((rng.randn(2, n) * 300).astype(dtype))
    seen = []
    real = {name: getattr(tfilter, name) for name in ("contributions", "carry_scan", "apply")}

    def counted(name):
        def fn(*a):
            seen.append(name)
            return real[name](*a)
        return fn

    plain = _sharded(x, sp, monkeypatch, {name: counted(name) for name in real})
    assert sorted(seen) == sorted(["contributions", "carry_scan", "apply"] * 2 * sp)
    calls = []
    emulated = _sharded(x, sp, monkeypatch, _emulated_phases(calls))
    assert len(calls) == 6 * sp
    _assert_bits_equal(emulated.numpy(), plain.numpy())
    local = tfilter.bandpass_filtfilt(x, 302, 20.0, 150.0)
    err = float((plain - local).abs().max())
    assert err <= seqshard.FLOAT32_FILTFILT_BOUND * float(local.abs().max())
