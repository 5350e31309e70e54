from nova_pointcloud_tpu_torch.schedulers.ddpm import (  # noqa: F401
    DDPMSchedule, DDPMScheduler)
