from nova_pointcloud_tpu_torch.models.pointcloud import (  # noqa: F401
    PC_ARCHES, NOVAPointCloudTransformer)
