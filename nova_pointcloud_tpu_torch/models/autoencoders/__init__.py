from nova_pointcloud_tpu_torch.models.autoencoders.modeling_utils import (  # noqa: F401
    DiagonalGaussian,
    IdentityDistribution,
    tiled_temporal_apply,
)
from nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl import AutoencoderKL  # noqa: F401
from nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl_opensora import (  # noqa: F401
    AutoencoderKLOpenSora,
)
