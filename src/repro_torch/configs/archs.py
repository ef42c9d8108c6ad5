"""The ten transformer architectures the repository models.

A copy of the JAX package's ``repro/configs/archs.py``: each is a
zero-argument builder returning a :class:`ModelConfig`; the registry
(``get_config``) lives in ``repro_torch.configs``.  The port runs the
decoder families: global and sliding-window attention with SwiGLU or
MoE feed-forwards, RWKV-6 and the RG-LRU hybrid, and a VLM's patch
prefix at prefill.  The encoder-decoder stack is listed here so that
configs and profiles match the reference, and is refused at run time.
"""
from __future__ import annotations

from .base import (
    ATTN_GLOBAL, ATTN_LOCAL, RGLRU, RWKV6,
    AUDIO, DENSE, HYBRID, MOE, SSM, VLM,
    ModelConfig,
)


def granite_moe_1b_a400m() -> ModelConfig:
    # [hf:ibm-granite/granite-3.0-1b-a400m-base] 24L d1024 16H (kv8) ff512/e,
    # 32 experts top-8.
    return ModelConfig(
        name="granite-moe-1b-a400m", family=MOE,
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49_155,
        num_experts=32, experts_per_token=8,
        rope_theta=10_000.0, tie_embeddings=True,
    )


def moonshot_v1_16b_a3b() -> ModelConfig:
    # [hf:moonshotai/Moonlight-16B-A3B] 48L d2048 16H (kv16) ff1408/e,
    # 64 experts top-6.
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family=MOE,
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=163_840,
        num_experts=64, experts_per_token=6,
        rope_theta=50_000.0,
    )


def qwen3_8b() -> ModelConfig:
    # [hf:Qwen/Qwen3-8B] 36L d4096 32H (kv8) ff12288, qk_norm.
    return ModelConfig(
        name="qwen3-8b", family=DENSE,
        num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
        head_dim=128, d_ff=12_288, vocab_size=151_936,
        qk_norm=True, rope_theta=1_000_000.0,
    )


def gemma3_27b() -> ModelConfig:
    # [hf:google/gemma-3] 62L d5376 32H (kv16) ff21504, 5:1 local:global,
    # window 1024, 128k context.
    return ModelConfig(
        name="gemma3-27b", family=DENSE,
        num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
        head_dim=128, d_ff=21_504, vocab_size=262_144,
        pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
        qk_norm=True, window_size=1024,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0,
        tie_embeddings=True,
    )


def starcoder2_3b() -> ModelConfig:
    # [arXiv:2402.19173] 30L d3072 24H (kv2) ff12288, GQA + RoPE.
    return ModelConfig(
        name="starcoder2-3b", family=DENSE,
        num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
        head_dim=128, d_ff=12_288, vocab_size=49_152,
        rope_theta=100_000.0,
    )


def yi_34b() -> ModelConfig:
    # [arXiv:2403.04652] 60L d7168 56H (kv8) ff20480, llama arch.
    return ModelConfig(
        name="yi-34b", family=DENSE,
        num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
        head_dim=128, d_ff=20_480, vocab_size=64_000,
        rope_theta=5_000_000.0,
    )


def internvl2_1b() -> ModelConfig:
    # [arXiv:2404.16821] InternViT(stub) + Qwen2-0.5B backbone:
    # 24L d896 14H (kv2) ff4864.  ViT frontend is a stub per assignment:
    # input_specs() provides 256 precomputed patch embeddings.
    return ModelConfig(
        name="internvl2-1b", family=VLM,
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        head_dim=64, d_ff=4864, vocab_size=151_655,
        rope_theta=1_000_000.0, tie_embeddings=True,
        frontend="vit", frontend_len=256,
    )


def recurrentgemma_9b() -> ModelConfig:
    # [arXiv:2402.19427] 38L d4096 16H (kv1/MQA) ff12288, RG-LRU + local
    # attention with a (recurrent, recurrent, attention) repeating pattern
    # (attention:recurrent = 1:2), window 2048.
    return ModelConfig(
        name="recurrentgemma-9b", family=HYBRID,
        num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
        head_dim=256, d_ff=12_288, vocab_size=256_000,
        pattern=(RGLRU, RGLRU, ATTN_LOCAL),
        window_size=2048, d_rnn=4096, conv_width=4,
        rope_theta=10_000.0, tie_embeddings=True,
    )


def rwkv6_3b() -> ModelConfig:
    # [arXiv:2404.05892] Finch 32L d2560 (attention-free) ff8960,
    # data-dependent decay, head size 64.
    return ModelConfig(
        name="rwkv6-3b", family=SSM,
        num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
        head_dim=64, d_ff=8960, vocab_size=65_536,
        pattern=(RWKV6,),
        rwkv_head_dim=64, rwkv_decay_lora=64, d_ff_rwkv=8960,
    )


def seamless_m4t_large_v2() -> ModelConfig:
    # [arXiv:2308.11596] enc-dec transformer backbone, 24L enc + 24L dec,
    # d1024 16H (kv16) ff8192.  Speech frontend is a stub per assignment:
    # input_specs() provides precomputed frame embeddings.
    return ModelConfig(
        name="seamless-m4t-large-v2", family=AUDIO,
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        head_dim=64, d_ff=8192, vocab_size=256_206,
        enc_dec=True, num_enc_layers=24,
        frontend="audio", frontend_len=0,   # encoder input IS the frontend output
        rope_theta=10_000.0,
    )


ARCH_BUILDERS = {
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "qwen3-8b": qwen3_8b,
    "gemma3-27b": gemma3_27b,
    "starcoder2-3b": starcoder2_3b,
    "yi-34b": yi_34b,
    "internvl2-1b": internvl2_1b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "rwkv6-3b": rwkv6_3b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
}
