from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline, NOVAPipelineOutput  # noqa: F401
from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import (  # noqa: F401
    NOVAPointCloudGenerationPipeline, NOVAPointCloudPipelineOutput)
