"""Models on one card: layers, attention, embedding ops, the MoE FFN, the
RWKV-6 and RG-LRU blocks, the transformer (init, prefill, decode; decoder
stacks and the encoder-decoder), the frontend stubs and the chain-CNN
split executor."""
