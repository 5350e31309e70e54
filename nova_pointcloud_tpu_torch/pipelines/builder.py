"""Pipeline construction from declarative configs (port of
``nova_pointcloud_tpu/pipelines/builder.py``: ``build_transformer`` and
``build_pipeline``'s point-cloud, NOVA serving and NOVA training branches).

``build_pipeline`` builds the model, the scheduler and the pipeline from a
top-level config dict, with the JAX function's defaults. The point-cloud
branch: ``pc_d8w768``, 2048 points, ``patch_size=1`` (every point a token),
text token dim 256. The NOVA branch: a ``NOVATransformer`` from a
reference-style ``model:`` section (``nova_pointcloud_tpu/configs/*.yaml``)
behind ``NOVAPipeline``, ``NOVAC2IPipeline`` (a ``num_classes`` model
without text) or the training pipeline the config names. As the JAX
function, it returns the pipeline without a text encoder: the caller sets
``pipeline.text_encoder`` or passes ``prompt_embeds``. Mesh
(pipeline-parallel) construction is not ported yet and raises.
"""

from typing import Dict, Optional

import torch

from nova_pointcloud_tpu_torch.models.nova import NOVATransformer
from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import (
    NOVAPointCloudGenerationPipeline)
from nova_pointcloud_tpu_torch.schedulers.builder import build_scheduler
from nova_pointcloud_tpu_torch.utils.config import Config


def build_transformer(cfg: Dict, noise_scheduler=None, dtype: Optional[torch.dtype] = None,
                      device=None) -> NOVATransformer:
    """A NOVATransformer from a reference-style transformer config: image_dim,
    image_size, image_stride, text_token_dim / len, num_classes,
    rotary_pos_embed, image_base_size, video_base_size, video_mixer_rank,
    arch (the JAX function's fields and defaults; the patch size is
    ``15 // image_stride + 1``)."""
    cfg = dict(cfg)
    image_stride = cfg.pop("image_stride", 8)
    cfg.pop("image_size", None)  # derivable: base_size * patch * stride
    return NOVATransformer(
        arch=tuple(cfg.pop("arch")),
        image_dim=cfg.pop("image_dim", 4),
        image_base_size=tuple(cfg.pop("image_base_size")),
        video_base_size=tuple(cfg.pop("video_base_size", (1, 8, 8))),
        patch_size=15 // image_stride + 1,
        text_token_dim=cfg.pop("text_token_dim", None),
        text_token_len=cfg.pop("text_token_len", 256),
        num_classes=cfg.pop("num_classes", None),
        rotary_pos_embed=cfg.pop("rotary_pos_embed", False),
        video_mixer_rank=cfg.pop("video_mixer_rank", None),
        loss_repeat=cfg.pop("loss_repeat", 4),
        noise_scheduler=noise_scheduler,
        remat=bool(cfg.pop("gradient_checkpointing", 0)),
        attn_impl=cfg.pop("attn_impl", "auto"),
        dtype=dtype, device=device)


def build_pipeline(config: Dict, state_dict: Optional[Dict] = None, seed: int = 0,
                   dtype: Optional[torch.dtype] = None, device=None, mesh=None):
    """Build (pipeline, state_dict) from a top-level config.

    config["pipeline"]["name"]: "NOVAPointCloudGenerationPipeline",
    "NOVAPipeline" (the default), "NOVAC2IPipeline" or a NOVA training pipeline
    ("NOVATrainT2IPipeline", "NOVATrainT2VPipeline", "NOVATrainC2IPipeline"). ``state_dict``: the model's weights (e.g.
    ``models.convert.convert_params`` of a JAX tree); without one the model is
    initialised from ``seed``. ``dtype`` is the compute dtype of the model;
    ``device`` is ``cuda`` unless ``"cpu"`` is asked for."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh (pipeline-parallel) construction is not ported yet: "
            "ROADMAP.md, module queue, parallelism")
    config = Config.wrap(config)
    pipe_name = config["pipeline"].get("name", "NOVAPipeline")
    sched_cfg = dict(config.get("scheduler", {}))
    noise_sched = build_scheduler(sched_cfg, "noise")
    if "PointCloud" in pipe_name:
        mcfg = dict(config["model"])
        model = NOVAPointCloudTransformer(
            arch=mcfg.get("arch", "pc_d8w768"),
            point_cloud_size=mcfg.get("point_cloud_size", 2048),
            patch_size=mcfg.get("patch_size", 1),
            text_token_dim=mcfg.get("text_token_dim", 256),
            dtype=dtype, device=device)
        _load(model, state_dict, seed)
        return NOVAPointCloudGenerationPipeline(model, noise_sched), model.state_dict()
    model = build_transformer(dict(config["model"]), noise_sched, dtype, device)
    _load(model, state_dict, seed)
    if pipe_name == "NOVAC2IPipeline":
        from nova_pointcloud_tpu_torch.pipelines.nova_c2i import NOVAC2IPipeline

        return NOVAC2IPipeline(model, build_scheduler(sched_cfg, "sample")), model.state_dict()
    if pipe_name.startswith("NOVATrain"):
        from nova_pointcloud_tpu_torch.pipelines import train_nova

        cls = getattr(train_nova, pipe_name, None)
        if cls is None:
            raise KeyError(f"Unknown pipeline {pipe_name!r}")
        return cls(model, **dict(config["pipeline"].get("params", {}))), model.state_dict()
    from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline

    return NOVAPipeline(model, build_scheduler(sched_cfg, "sample")), model.state_dict()


def _load(model: torch.nn.Module, state_dict: Optional[Dict], seed: int) -> None:
    if state_dict is None:
        model.init_weights(torch.Generator(device=model.device).manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
