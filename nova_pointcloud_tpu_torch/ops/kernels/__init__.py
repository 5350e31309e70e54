"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from nova_pointcloud_tpu_torch.ops.kernels.fused_block import (  # noqa: F401
    LAUNCHES, fused_attention_block, fused_ln_int8_mlp, reset_launch_counts,
    use_plain_kernels)
