from nova_pointcloud_tpu_torch.models.nova import (  # noqa: F401
    MLP_ARCHES, VIT_ARCHES, NOVATransformer)
from nova_pointcloud_tpu_torch.models.pointcloud import (  # noqa: F401
    PC_ARCHES, NOVAPointCloudTransformer)
