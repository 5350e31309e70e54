"""Class-conditional image generation (port of
``nova_pointcloud_tpu/pipelines/nova_c2i.py``): ``NOVAPipeline`` whose
prompt is a list of class ids; the ids go through the model's label table,
and the CFG negative is the null class ``num_classes``.
"""

from typing import Optional, Sequence

import numpy as np
import torch

from nova_pointcloud_tpu_torch.models.guidance import GuidanceConfig
from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline


class NOVAC2IPipeline(NOVAPipeline):
    """NOVAPipeline over a label-conditioned NOVATransformer (``num_classes``
    set, no text): no text encoder; ``negative_prompt`` and
    ``prompt_embeds`` are ignored."""

    def __init__(self, model, scheduler=None, vae=None, mesh=None):
        super().__init__(model, scheduler, vae=vae, text_encoder=None, mesh=mesh)

    @torch.no_grad()
    def encode_prompt(self, prompt: Sequence[int], negative_prompt=None,
                      guidance: GuidanceConfig = GuidanceConfig(),
                      num_images_per_prompt: int = 1,
                      prompt_embeds: Optional[np.ndarray] = None) -> torch.Tensor:
        """Class ids (B,) -> the expanded conditioning ``[cond | null]``,
        (n_passes * B * num_images_per_prompt, 1, D)."""
        labels = torch.as_tensor(np.asarray(prompt, np.int64), device=self.device)
        c_cond = self.model.embed_label(labels)
        c_null = self.model.embed_label(torch.full_like(labels, self.model.num_classes))
        c = guidance.expand_text(c_cond, c_null)
        if num_images_per_prompt > 1:
            c = torch.repeat_interleave(c, num_images_per_prompt, dim=0)
        return c
