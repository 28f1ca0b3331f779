"""Experimental APIs (reference: `python/ray/experimental/`)."""

from ray_tpu_torch.experimental.channel import (  # noqa: F401
    TAG_ERR,
    TAG_OK,
    ChannelClosedError,
    FrameScratch,
    ShmChannel,
)
