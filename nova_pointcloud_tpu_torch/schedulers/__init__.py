from nova_pointcloud_tpu_torch.schedulers.flow_match import (  # noqa: F401
    FlowMatchEulerScheduler, FlowMatchSchedule)
from nova_pointcloud_tpu_torch.schedulers.ddpm import (  # noqa: F401
    DDPMSchedule, DDPMScheduler)
