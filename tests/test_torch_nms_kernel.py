"""The distance-NMS kernel (``csrc/distance_nms.cu``) on the CPU: its design
emulated in numpy and held bit for bit against
``ops/find_peaks._select_by_distance_plain`` and a sequential greedy oracle,
the wrapper's plan and checks, and the seam that chooses between kernel and
plain version.

The emulation follows the kernel for each row: the float32 priority's
sortable key with -0.0 as +0.0, the float32 positions, d = ceil(float32
distance); the row's slots split into ``split`` parts of ``chunk`` slots,
as a cluster's blocks hold them, each window walked slot by slot across the
parts (the halo read from the neighbouring part) until the row's edge,
``reach`` slots, an invalid slot or the float32 position bound; then rounds
of phase A (an alive slot beaten by no higher-ranked alive slot of its
window marks itself kept-this-round, last round's marks turn into kept) and
phase B (an alive slot with a kept-this-round slot in its window dies)
until no slot is alive.  Each phase visits the slots in a random order and
writes the state in place, as the kernel's threads do in no order: the
result must not depend on it.

The cases are ``chip_smoke.nms_cases`` (the card test runs the same ones);
the test asserts that they reach what they are named for: ties resolved by
the later slot, windows cut by ``reach``, several rounds, windows across
parts, rows with no valid slot and rows valid to capacity.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from bpm_analysis_tpu_torch.ops import find_peaks as fp
from bpm_analysis_tpu_torch.ops.cuda import nms_kernel

VALID, ALIVE, NEW, KEEP = 1, 2, 4, 8
CASES = chip_smoke.nms_cases()
SPLITS = [1, 2, 3, 8]


def key_of(priority: np.ndarray) -> np.ndarray:
    """csrc ``key_of`` of the priorities rounded to float32."""
    bits = priority.astype(np.float32).view(np.uint32).copy()
    bits[bits == 0x80000000] = 0
    return np.where(bits & 0x80000000, ~bits, bits ^ 0x80000000).astype(np.uint32)


def distance_of(distance, b: int) -> np.float32:
    d = distance[b] if isinstance(distance, np.ndarray) else distance
    return np.float32(np.ceil(np.float32(d)))


def window(posf, valid, i: int, d, reach: int):
    """The slots of slot i's window, as the kernel's walks see them."""
    lo_lim, hi_lim = posf[i] - d, posf[i] + d
    out = []
    for step, inside in ((-1, lambda p: p > lo_lim), (1, lambda p: p < hi_lim)):
        for s in range(1, reach + 1):
            j = i + step * s
            if j < 0 or j >= len(posf) or not valid[j] or not inside(posf[j]):
                break
            out.append(j)
    return out


def greedy(positions, priority, valid, distance, reach):
    """The sequential greedy keep-highest: valid slots by (key, slot)
    descending, each kept unless an earlier kept one suppressed it."""
    keep = np.zeros(valid.shape, bool)
    for b in range(valid.shape[0]):
        key, posf = key_of(priority[b]), positions[b].astype(np.float32)
        d = distance_of(distance, b)
        gone = np.zeros(valid.shape[1], bool)
        for i in sorted(np.flatnonzero(valid[b]), key=lambda i: (key[i], i), reverse=True):
            if not gone[i]:
                keep[b, i] = True
                gone[window(posf, valid[b], i, d, reach)] = True
    return keep


def emulate(positions, priority, valid, distance, reach, split, chunk, rng, stats=None):
    """csrc/distance_nms.cu's keep mask, row by row, with the row in
    ``split`` parts of ``chunk`` slots."""
    stats = {} if stats is None else stats
    bsz, cap = valid.shape
    keep = np.zeros((bsz, cap), bool)
    for b in range(bsz):
        key, posf = key_of(priority[b]), positions[b].astype(np.float32)
        d = distance_of(distance, b)
        parts = []
        for r in range(split):
            first = r * chunk
            n = max(0, min(chunk, cap - first))
            part = {"key": np.zeros(chunk, np.uint32), "pos": np.zeros(chunk, np.float32),
                    "st": np.zeros(chunk, np.uint8), "first": first, "len": n}
            part["key"][:n] = key[first:first + n]
            part["pos"][:n] = posf[first:first + n]
            part["st"][:n] = np.where(valid[b, first:first + n], VALID | ALIVE, 0)
            parts.append(part)

        def scan(step, i, r, o, lim, hit):
            p = parts[r]
            for s in range(1, reach + 1):
                j = i + step * s
                if j < 0 or j >= cap:
                    return False
                o += step
                if o < 0 or o >= chunk:
                    r += step
                    o = chunk - 1 if o < 0 else 0
                    p = parts[r]
                    stats["crossed"] = stats.get("crossed", 0) + 1
                sj = p["st"][o]
                if not sj & VALID:
                    return False
                pj = p["pos"][o]
                if not (pj > lim if step < 0 else pj < lim):
                    return False
                if hit(sj, p, o):
                    return True
            return False

        slots = [(r, o) for r, p in enumerate(parts) for o in range(p["len"])]
        rounds = 0
        while True:
            rounds += 1
            for idx in rng.permutation(len(slots)):                 # phase A
                r, o = slots[idx]
                p = parts[r]
                s = p["st"][o]
                if s & NEW:
                    p["st"][o] = (int(s) & ~NEW) | KEEP
                    continue
                if not s & ALIVE:
                    continue
                i, k, pos = p["first"] + o, p["key"][o], p["pos"][o]
                beaten = (scan(-1, i, r, o, pos - d,
                               lambda sj, q, oj: bool(sj & ALIVE) and q["key"][oj] > k)
                          or scan(1, i, r, o, pos + d,
                                  lambda sj, q, oj: bool(sj & ALIVE) and q["key"][oj] >= k))
                if not beaten:
                    p["st"][o] = s | NEW
            alive = False
            for idx in rng.permutation(len(slots)):                 # phase B
                r, o = slots[idx]
                p = parts[r]
                s = p["st"][o]
                if not s & ALIVE:
                    continue
                if s & NEW:
                    p["st"][o] = VALID | NEW
                    continue
                i, pos = p["first"] + o, p["pos"][o]

                def kept(sj, q, oj):
                    return bool(sj & NEW)

                if scan(-1, i, r, o, pos - d, kept) or scan(1, i, r, o, pos + d, kept):
                    p["st"][o] = VALID
                else:
                    alive = True
            if not alive:
                break
        stats["rounds"] = max(stats.get("rounds", 0), rounds)
        for p in parts:
            n, first = p["len"], p["first"]
            keep[b, first:first + n] = (p["st"][:n] & (NEW | KEEP)) != 0
    return keep


def plain(positions, priority, valid, distance):
    dist = torch.from_numpy(distance) if isinstance(distance, np.ndarray) else distance
    return fp._select_by_distance_plain(torch.from_numpy(positions),
                                        torch.from_numpy(priority), torch.from_numpy(valid),
                                        dist).numpy()


def reach_of(distance, cap: int) -> int:
    win = fp._window_slots(distance if not isinstance(distance, np.ndarray)
                           else torch.from_numpy(distance), cap)
    return win if win <= 128 else cap


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_kernel_equals_plain_version_and_greedy(case, split):
    """Bit for bit against the plain version and the greedy oracle, with
    the row in ``split`` parts (a cluster of that many blocks; 1: one
    block's shared memory or global scratch)."""
    name, positions, priority, valid, distance = case
    cap = valid.shape[1]
    reach = reach_of(distance, cap)
    exp = plain(positions, priority, valid, distance)
    np.testing.assert_array_equal(greedy(positions, priority, valid, distance, reach), exp)
    stats = {}
    got = emulate(positions, priority, valid, distance, reach, split, -(-cap // split),
                  np.random.default_rng(split), stats)
    np.testing.assert_array_equal(got, exp)
    if split > 1 and name != "no_valid_slot":
        assert stats.get("crossed", 0) > 0, "no window crosses a part's edge"


def test_cases_reach_what_they_are_named_for():
    by_name = {c[0]: c for c in CASES}
    for name, positions, priority, valid, distance in CASES:
        assert all((np.diff(p[v]) > 0).all() for p, v in zip(positions, valid)), name
        assert (valid[:, 1:] <= valid[:, :-1]).all(), name      # a valid prefix
    _, positions, priority, valid, distance = by_name["ties"]
    keys = key_of(priority)
    assert any(len(set(keys[b][valid[b]].tolist())) < valid[b].sum() / 4
               for b in range(valid.shape[0]))
    _, positions, priority, valid, distance = by_name["signed_zeros"]
    bits = priority.view(np.uint32)
    assert (bits == 0x80000000).any() and (bits == 0).any()
    _, positions, priority, valid, distance = by_name["float64_ties"]
    assert priority.dtype == np.float64
    assert len(np.unique(priority[valid])) > len(np.unique(priority[valid].astype(np.float32)))
    # Windows cut by reach: gaps of one sample at a distance of 15 (reach 9).
    _, positions, priority, valid, distance = by_name["reach_cut"]
    reach = reach_of(distance, valid.shape[1])
    assert reach == 9
    assert not np.array_equal(greedy(positions, priority, valid, distance, reach),
                              greedy(positions, priority, valid, distance, valid.shape[1]))
    for name in ("wide_static", "per_row", "wider_static"):
        c = by_name[name]
        assert reach_of(c[4], c[3].shape[1]) == {"wide_static": 102}.get(name, c[3].shape[1])
    stats = {}
    c = by_name["monotone"]
    emulate(*c[1:], reach_of(c[4], c[3].shape[1]), 1, c[3].shape[1],
            np.random.default_rng(0), stats)
    assert stats["rounds"] >= 20
    assert not by_name["no_valid_slot"][3].any()
    assert by_name["full_capacity"][3].all()


def test_plan_holds_every_cells_row_in_shared_memory():
    """One block for the fleet's rows, a cluster of 2 for the stress cell's
    and the native rate's B=1 rows, global scratch past 8 blocks."""
    per_block = nms_kernel.SHARED_BYTES // nms_kernel.SLOT_BYTES
    assert nms_kernel.plan(22_014) == (1, 22_014, False)
    assert nms_kernel.plan(16_384) == (1, 16_384, False)
    assert nms_kernel.plan(40_958) == (2, 20_479, False)
    assert nms_kernel.plan(32_766) == (2, 16_383, False)
    assert nms_kernel.plan(8 * per_block) == (8, per_block, False)
    assert nms_kernel.plan(8 * per_block + 1) == (1, 8 * per_block + 1, True)
    for cap in (1, 100, per_block, per_block + 1, 123_457, 8 * per_block):
        split, chunk, scratch = nms_kernel.plan(cap)
        assert not scratch and chunk * nms_kernel.SLOT_BYTES <= nms_kernel.SHARED_BYTES
        assert split * chunk >= cap > (split - 1) * chunk


def _wrapper_calls(monkeypatch) -> list:
    """Record the wrapper's calls; each gives a keep mask on the ``meta``
    device, which stands in for the card here."""
    calls = []

    def record(positions, priority, valid, distance, reach, length):
        calls.append((positions.shape, priority.dtype,
                      distance.dtype if isinstance(distance, torch.Tensor) else distance,
                      reach, length))
        return torch.empty(positions.shape, dtype=torch.bool, device=positions.device)

    monkeypatch.setattr(nms_kernel, "select_by_distance", record)
    return calls


def test_every_non_cpu_tensor_takes_the_kernel(monkeypatch):
    """On a card the kernel, with the plain version's reach: a static
    distance's shifted compares (distance 15: 9 slots; 200: 102), else the
    whole row (300, a per-row distance); CPU tensors take the plain
    version."""
    calls = _wrapper_calls(monkeypatch)
    meta = dict(device="meta")
    pos = torch.zeros((3, 40), dtype=torch.int64, **meta)
    prio = torch.zeros((3, 40), dtype=torch.float64, **meta)
    valid = torch.zeros((3, 40), dtype=torch.bool, **meta)
    for distance in (15, 200, 300, 15.5):
        fp._select_by_distance(pos, prio, valid, distance, 1000)
    fp._select_by_distance(pos, prio, valid, torch.tensor([4, 5, 6], dtype=torch.int32), 1000)
    fp._select_by_distance(pos, prio, valid, torch.tensor(7.0, dtype=torch.float64), 1000)
    assert calls == [((3, 40), torch.float64, 15, 9, 1000),
                     ((3, 40), torch.float64, 200, 102, 1000),
                     ((3, 40), torch.float64, 300, 40, 1000),
                     ((3, 40), torch.float64, 15.5, 10, 1000),
                     ((3, 40), torch.float64, torch.float32, 40, 1000),
                     ((3, 40), torch.float64, torch.float32, 40, 1000)]
    name, positions, priority, valid_np, distance = CASES[0]
    got = fp._select_by_distance(torch.from_numpy(positions), torch.from_numpy(priority),
                                 torch.from_numpy(valid_np), distance, 1 << 30)
    assert len(calls) == 6
    np.testing.assert_array_equal(got.numpy(), plain(positions, priority, valid_np, distance))


def _inputs(bsz=2, cap=8, **change):
    t = dict(positions=torch.zeros((bsz, cap), dtype=torch.int64),
             priority=torch.zeros((bsz, cap), dtype=torch.float32),
             valid=torch.zeros((bsz, cap), dtype=torch.bool), distance=15, reach=9,
             length=1000)
    t.update(change)
    return t


@pytest.mark.parametrize("change, what", [
    ({}, "CUDA"),
    ({"positions": torch.zeros((2, 8), dtype=torch.int32)}, "expected"),
    ({"positions": torch.zeros(8, dtype=torch.int64)}, "B, cap"),
    ({"priority": torch.zeros((2, 8), dtype=torch.float16)}, "float32 or float64"),
    ({"priority": torch.zeros((2, 9), dtype=torch.float32)}, "expected"),
    ({"valid": torch.zeros((2, 8), dtype=torch.uint8)}, "expected"),
    ({"valid": torch.zeros((2, 8), dtype=torch.bool, device="meta")}, "expected"),
    ({"priority": torch.zeros((8, 2), dtype=torch.float32).t()}, "contiguous"),
    ({"distance": torch.zeros(2, dtype=torch.float64)}, "expected"),
    ({"distance": torch.zeros(3, dtype=torch.float32)}, "expected"),
    ({"distance": "15"}, "number or a tensor"),
    ({"length": (1 << 24) + 1}, "2\\^24"),
], ids=["cpu_tensors", "int32_positions", "one_axis", "float16", "priority_shape",
        "uint8_valid", "valid_device", "non_contiguous", "float64_distance",
        "distance_shape", "distance_type", "position_2_24"])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, what):
    """CPU tensors; positions not (B, cap) int64; priorities not float32 or
    float64 or of another shape; a mask not bool or on another device; a
    non-contiguous input; a per-row distance not (B,) float32; a distance
    neither number nor tensor; positions that may reach 2^24."""
    with pytest.raises(ValueError, match=what):
        nms_kernel.select_by_distance(**_inputs(**change))
    nms_kernel.check_inputs(**{k: v for k, v in _inputs(length=1 << 24).items()
                               if k != "reach"})
