from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline, NOVAPipelineOutput  # noqa: F401
from nova_pointcloud_tpu_torch.pipelines.nova_c2i import NOVAC2IPipeline  # noqa: F401
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import (  # noqa: F401
    NOVAPointCloudGenerationPipeline, NOVAPointCloudPipelineOutput)
from nova_pointcloud_tpu_torch.pipelines.pretrained import from_pretrained  # noqa: F401
