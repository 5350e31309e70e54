from nova_pointcloud_tpu_torch.models.text_encoders.dummy import (  # noqa: F401
    DummyTextEncoder, DummyTokenizer)
