"""Least times of the hand-written kernels from the shapes of their calls:
frozen copies of ``chip_smoke.scan_bound`` (the classifier scan) and
``chip_smoke.filter_bound`` (the blocked filter) as they stood when the
benchmark was defined, so the work a roofline share reads stays fixed when
a kernel changes.  Peaks: NVIDIA's H100 SXM data sheet (float32 outside the
tensor cores, HBM bandwidth) and its 1,980 MHz maximum SM clock."""
import numpy as np

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
# The classifier scan: the longest carry-dependent chain of one step, as
# (ALU operations, IEEE divisions by a carried value) per chain, at 4 and 40
# cycles; bytes are the slot inputs read and the outputs written once.
ALU_CYCLES, DIV_CYCLES = 4, 40
CLASSIFY_CHAINS = {"base confidence": (33, 0), "penalty": (37, 1),
                   "interval penalty": (22, 2), "lone check": (30, 2)}
CLASSIFY_TRACE_FIELDS = 18      # the kernel's own trace fields


def classify_scan_ms(bsz: int, cap: int, itemsize: int, want_trace: bool,
                     clock_hz: float = SM_CLOCK_HZ) -> tuple:
    """(ms, 'bytes'|'operations') of one classifier scan over (bsz, cap)
    slots."""
    per_slot = 4 + 5 * itemsize + 1 + 4
    if want_trace:
        per_slot += CLASSIFY_TRACE_FIELDS * itemsize + 4 + 1
    t_bytes = (bsz * cap * per_slot + bsz * (4 + itemsize)) / PEAK_BYTES_S * 1e3
    step = max(alu * ALU_CYCLES + div * DIV_CYCLES for alu, div in CLASSIFY_CHAINS.values())
    t_ops = cap * step / clock_hz * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def filter_ms(bsz: int, n: int, L: int, m: int, itemsize: int,
              clock_hz: float = SM_CLOCK_HZ) -> tuple:
    """(ms, 'bytes'|'operations') of one blocked filter pass over (bsz, n)
    with blocks of L samples and m states: the rows read and written once,
    and the larger of the unfused operations (block contributions, the carry
    scan, each output's carry-in product and in-block Toeplitz sum) at the
    float32 peak and a row's carry chain (nb steps of m + 1 operations)."""
    nb = -(-n // L)
    lags = int((np.arange(n) % L).sum())
    ops_row = (nb * (L * m + (L - 1) * m)
               + nb * (m * m + (m - 1) * m + m)
               + n * (1 + m + (m - 1) + 2)
               + 2 * lags)
    t_ops = max(bsz * ops_row / PEAK_F32_FLOPS, nb * (m + 1) * ALU_CYCLES / clock_hz) * 1e3
    t_bytes = (2 * bsz * n + bsz * m) * itemsize / PEAK_BYTES_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def distance_capacity(n: int, distance) -> int:
    """The peak finder's bound on distance-NMS survivors (a multiple of 128)."""
    return -(-(n // max(int(-(-distance // 1)), 1) + 2) // 128) * 128
