"""The host-side cluster mirror and its side-effect seams."""

from kube_batch_tpu_torch.cache.cache import SchedulerCache
from kube_batch_tpu_torch.cache.fake import (
    FakeBinder,
    FakeEvictor,
    FakeStatusUpdater,
    FakeVolumeBinder,
)
from kube_batch_tpu_torch.cache.interface import (
    Binder,
    Evictor,
    StatusUpdater,
    VolumeBinder,
)

__all__ = [
    "Binder",
    "Evictor",
    "StatusUpdater",
    "VolumeBinder",
    "FakeBinder",
    "FakeEvictor",
    "FakeStatusUpdater",
    "FakeVolumeBinder",
    "SchedulerCache",
]
