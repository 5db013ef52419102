"""Pipeline stages over batched envelopes."""
