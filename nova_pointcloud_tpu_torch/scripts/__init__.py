"""Command-line entry points of the port: ``python -m nova_pointcloud_tpu_torch.scripts.<name>``."""
