"""Metric readers: ``<name>.py`` gives ``read(run)``, the metric of one run,
or None where the run holds nothing to read."""
