"""Hand-written CUDA kernels of the port and their plain PyTorch versions."""

from nova_pointcloud_tpu_torch.ops.kernels._launch import (  # noqa: F401
    LAUNCHES, reset_launch_counts, use_plain_kernels)
from nova_pointcloud_tpu_torch.ops.kernels import flash_attention  # noqa: F401  (the module)
from nova_pointcloud_tpu_torch.ops.kernels.fused_block import (  # noqa: F401
    fused_attention_block, fused_ln_int8_matmul, fused_ln_int8_mlp,
    int8_matmul_residual)
