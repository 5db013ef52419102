"""Entries: ``<kind>.py`` drives one entry point of the port.  Each exposes
``setup(ctx)`` (the program's state for a run), ``call(state, i)`` (one
timed call, returning its record), ``answers(state, record)`` ((recording
id, answer or None) for every recording of a call, read after the window),
``csvs(state)`` ((recording id, BPM CSV) of the artifacts left on disk, or
nothing) and ``shapes(state)`` (what the per-layer readers need of the
call's inputs)."""
