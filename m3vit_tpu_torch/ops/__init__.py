"""Hand-written Hopper kernels (``_build``, ``flash_attention``,
``expert_ffn``, ``ln_mlp``), each module with its plain PyTorch version."""
