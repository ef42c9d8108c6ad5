"""Decoder models on one card: layers, attention, embedding ops, the MoE
FFN, the RWKV-6 blocks and the transformer (init, prefill, decode)."""
