"""PyTorch / CUDA port of nova_pointcloud_tpu for NVIDIA Hopper (H100).

The JAX package ``nova_pointcloud_tpu`` is the reference; this package mirrors
its module layout so each module's counterpart is easy to find. It imports
``torch`` and ``numpy`` only. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (utils/device.py).

Ported so far: flagship text-to-point-cloud serving (pipelines/pointcloud_gen),
with hand-written CUDA kernels for the two fused int8 block kernels
(ops/kernels/fused_block.py, sources in csrc/).
"""
