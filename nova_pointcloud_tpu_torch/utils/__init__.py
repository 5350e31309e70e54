from nova_pointcloud_tpu_torch.utils.device import resolve_device  # noqa: F401
