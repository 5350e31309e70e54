"""PyTorch / CUDA port of nova_pointcloud_tpu for NVIDIA Hopper (H100).

The JAX package ``nova_pointcloud_tpu`` is the reference; this package mirrors
its module layout so each module's counterpart is easy to find. It imports
``torch`` and ``numpy`` only. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (utils/device.py).

Ported so far: text-to-point-cloud serving (pipelines/pointcloud_gen,
pipelines/builder): the patched flagship and the per-point (2048-token) int8
and float paths, with hand-written CUDA kernels for the four fused int8 block
kernels (ops/kernels/fused_block.py) and the flash attention forward
(ops/kernels/flash_attention.py); sources in csrc/.
"""
