"""Which tensors of the port's pipeline round differently for one recording
alone (B=1) and in a batch of 16, on a CUDA card.

    python3 tools/torch_batch_shapes.py

From the repository root.  Runs recording 0 of ``chip_smoke.py``'s batch
through ``host.analyze_padded`` (the host path's device program, padded to
196,608 samples with ``n_valid``) alone and as row 0 of the 16, and the 16
twice; prints, per tensor of the result, how many elements differ and the
largest absolute difference.  Both runs pad to one length, so position
arrays (filled past their counts) compare whole.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def run(batch_i16, rows, cfg, length):
    from bpm_analysis_tpu_torch import host

    dev = torch.device("cuda")
    n = batch_i16.shape[1]
    audio = np.zeros((len(rows), length), np.int16)
    audio[:, :n] = batch_i16[rows]
    out = host.analyze_padded(
        torch.from_numpy(audio).to(dev),
        torch.full((len(rows),), float("nan"), dtype=torch.float32, device=dev),
        torch.full((len(rows),), n, dtype=torch.int32, device=dev), cs.SR, cfg, False)
    torch.cuda.synchronize()
    return host.tree_row(host.to_host(out), 0)


def differences(a, b, prefix=""):
    """(name, differing elements, max abs difference) of row-0 leaves."""
    if a is None:
        return []
    if hasattr(a, "_fields"):
        return [d for f in a._fields
                for d in differences(getattr(a, f), getattr(b, f), f"{prefix}{f}.")]
    x, y = np.asarray(a), np.asarray(b)
    same_nan = np.isnan(x) & np.isnan(y) if x.dtype.kind == "f" else np.zeros(x.shape, bool)
    differ = (x != y) & ~same_nan
    if not differ.any():
        return []
    gap = float(np.nanmax(np.abs(x.astype(np.float64) - y))) if x.dtype.kind == "f" else None
    return [(prefix[:-1], int(differ.sum()), gap)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_batch_shapes: no CUDA device", file=sys.stderr)
        return 2
    from bpm_analysis_tpu_torch import host_batch, synth

    cs.build_all()
    cfg = cs.engine_config()
    batch_i16 = np.stack([synth._quantize_int16(synth.synth_recording(s)) for s in cs.SEEDS])
    length = host_batch.length_bucket(batch_i16.shape[1])
    every = list(range(len(cs.SEEDS)))
    for label, rows_a, rows_b in (("B=1 vs B=16", [0], every), ("B=16 twice", every, every)):
        a = run(batch_i16, rows_a, cfg, length)
        b = run(batch_i16, rows_b, cfg, length)
        res_a, res_b = a[3], b[3]
        count = int(res_a.final_count)
        same_beats = (int(res_b.final_count) == count and np.array_equal(
            res_a.final_positions[:count], res_b.final_positions[:count]))
        found = [d for name, x, y in zip(("envelope", "filtered", "n_valid", "result"), a, b)
                 for d in differences(x, y, f"{name}.")]
        rows = [f"{name}: {k} differ" + (f", max abs {gap:.3g}" if gap is not None else "")
                for name, k, gap in found]
        print(f"{label} (length {length}): final beats equal: {same_beats}; "
              + ("; ".join(rows) or "every tensor equal"), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
