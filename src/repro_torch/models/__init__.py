"""The dense decoder on one card: layers, attention, embedding ops and
the transformer (init, prefill, decode)."""
