"""All audio-minutes of the answers completed in the window (a row that
overflowed a capacity or found no beats counts as failed), over the
window's seconds."""
from bench_port.yardstick import readers


def read(run):
    return readers.audio_rate(run)
