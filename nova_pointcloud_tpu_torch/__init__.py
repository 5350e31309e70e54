"""PyTorch / CUDA port of nova_pointcloud_tpu for NVIDIA Hopper (H100).

The JAX package ``nova_pointcloud_tpu`` is the reference; this package mirrors
its module layout so each module's counterpart is easy to find. It imports
``torch``, ``numpy`` and ``einops`` only. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (utils/device.py).

Ported so far: text-to-point-cloud serving (pipelines/pointcloud_gen,
pipelines/builder): the patched flagship and the per-point (2048-token) int8
and float paths; NOVA text-to-image and text-to-video serving
(pipelines/nova, models/nova): int8 and float, to latents or, through the
VAEs (models/autoencoders, utils/image_processor), to uint8 pixels; c2i
serving, the Phi-2 prompt encoder and loading a reference checkpoint
directory (pipelines/pretrained.from_pretrained); the training and
point-cloud AR slices (ROADMAP.md lists them). Hand-written CUDA kernels for the six fused
int8 block kernels and the ViT's int8 projections
(ops/kernels/fused_block.py), the flash attention forward and the
calibrated static-offset attention (ops/kernels/flash_attention.py); sources
in csrc/.
"""
