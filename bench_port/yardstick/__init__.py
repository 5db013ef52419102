"""The yardstick the per-layer readers share: the card's published peaks,
the kernels' least times from their call shapes (``bounds``), and the
arithmetic the readers have in common (``readers``)."""
