"""VAE decode and postprocess (port of
``nova_pointcloud_tpu/utils/image_processor.py``): latents decoded through
the VAE in micro-batches, the [-1, 1] samples turned into uint8 on the
samples' device and copied to the host, optionally PIL images.

The VAE (a module of ``models/autoencoders``) holds its own weights, so the
processor takes no parameter tree. A video VAE's own ``decode`` tiles in
time, and in eager PyTorch a window's activations are freed when its
decoder returns, so the peak is one window's without a window loop here
(JAX's ``_decode_video`` needs one because each window is its own jit
program). Host offload of the VAE's weights is not ported yet and raises.
"""

from typing import Any, List

import numpy as np
import torch


class VaeImageProcessor:
    """Decode + postprocess around a VAE (or none: the latents pass
    through)."""

    def __init__(self, vae=None, micro_batch: int = 2):
        self.vae, self.micro_batch = vae, micro_batch

    def device_params(self):
        raise NotImplementedError("host offload of the VAE weights is not ported yet: "
                                  "ROADMAP.md, module queue, parallelism and infra")

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, ..., C) scaled latents -> (B, ..., 3) samples in [-1, 1], on
        the VAE's device; the latents themselves without a VAE."""
        if self.vae is None:
            return latents
        z = self.vae.unscale(torch.as_tensor(latents, device=self.vae.device))
        return torch.cat([self.vae.decode(z[i:i + self.micro_batch])
                          for i in range(0, z.shape[0], self.micro_batch)], dim=0)

    @staticmethod
    def to_uint8(x) -> np.ndarray:
        """[-1, 1] floats -> uint8 numpy (truncated, as the JAX cast)."""
        x = np.asarray(x, np.float32)
        return ((x + 1.0) * 127.5).clip(0, 255).astype(np.uint8)

    @staticmethod
    def to_pil(images: np.ndarray) -> List[Any]:
        """uint8 (B, H, W, 3) -> PIL images."""
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError("output_type='pil' needs the PIL package (Pillow), which is "
                              "not installed here; use output_type='np'") from e
        return [Image.fromarray(im) for im in images]

    def postprocess(self, samples, output_type: str = "np"):
        """Samples in [-1, 1] -> uint8 numpy (or PIL images): a tensor is
        converted on its device, ``clip((x + 1) * 127.5, 0, 255)`` in
        float32 truncated to uint8, so the copy to the host moves a quarter
        of the float32 bytes."""
        if isinstance(samples, torch.Tensor):
            u8 = torch.clamp((samples.float() + 1.0) * 127.5, 0, 255).to(torch.uint8)
            arr = u8.cpu().numpy()
        else:
            arr = self.to_uint8(samples)
        return self.to_pil(arr) if output_type == "pil" else arr
