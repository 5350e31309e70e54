"""Pipeline construction from declarative configs (port of
``nova_pointcloud_tpu/pipelines/builder.py``, the point-cloud branch).

``build_pipeline`` builds the model, the scheduler and the pipeline from a
top-level config dict, with the JAX function's defaults: ``pc_d8w768``, 2048
points, ``patch_size=1`` (every point a token), text token dim 256. As the
JAX function, it returns the pipeline without a text encoder: the caller sets
``pipeline.text_encoder`` or passes ``prompt_embeds``. The NOVA image / video
pipelines and mesh (pipeline-parallel) construction are not ported yet.
"""

from typing import Dict, Optional, Tuple

import torch

from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import (
    NOVAPointCloudGenerationPipeline)
from nova_pointcloud_tpu_torch.schedulers.builder import build_scheduler
from nova_pointcloud_tpu_torch.utils.config import Config


def build_pipeline(config: Dict, state_dict: Optional[Dict] = None, seed: int = 0,
                   dtype: Optional[torch.dtype] = None, device=None, mesh=None
                   ) -> Tuple[NOVAPointCloudGenerationPipeline, Dict]:
    """Build (pipeline, state_dict) from a top-level config.

    config["pipeline"]["name"] must name the point-cloud pipeline
    ("NOVAPointCloudGenerationPipeline"). ``state_dict``: the model's weights
    (e.g. ``models.convert.convert_params`` of a JAX tree); without one the
    model is initialised from ``seed``. ``dtype`` is the compute dtype of the
    model; ``device`` is ``cuda`` unless ``"cpu"`` is asked for."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh (pipeline-parallel) construction is not ported yet: "
            "ROADMAP.md, module queue, parallelism")
    config = Config.wrap(config)
    pipe_name = config["pipeline"].get("name", "NOVAPipeline")
    if "PointCloud" not in pipe_name:
        raise NotImplementedError(
            f"pipeline {pipe_name!r} is not ported yet: ROADMAP.md, module "
            f"queue, NOVA t2i serving and the slices after it")
    noise_sched = build_scheduler(dict(config.get("scheduler", {})), "noise")
    mcfg = dict(config["model"])
    model = NOVAPointCloudTransformer(
        arch=mcfg.get("arch", "pc_d8w768"),
        point_cloud_size=mcfg.get("point_cloud_size", 2048),
        patch_size=mcfg.get("patch_size", 1),
        text_token_dim=mcfg.get("text_token_dim", 256),
        dtype=dtype, device=device)
    if state_dict is None:
        model.init_weights(torch.Generator(device=model.device).manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return NOVAPointCloudGenerationPipeline(model, noise_sched), model.state_dict()
