"""Signal-processing primitives over (B, n) tensors."""
