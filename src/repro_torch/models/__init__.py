"""Decoder models on one card: layers, attention, embedding ops, the MoE
FFN, the RWKV-6 and RG-LRU blocks and the transformer (init, prefill,
decode)."""
