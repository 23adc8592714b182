"""The host-side cluster mirror and its side-effect seams."""

from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.cache.fake import (
    FakeBinder,
    FakeStatusUpdater,
    FakeVolumeBinder,
)
from kube_batch_tpu_torch.cache.interface import (
    Binder,
    StatusUpdater,
    VolumeBinder,
)

__all__ = [
    "Binder",
    "StatusUpdater",
    "VolumeBinder",
    "FakeBinder",
    "FakeStatusUpdater",
    "FakeVolumeBinder",
    "SchedulerCache",
]
