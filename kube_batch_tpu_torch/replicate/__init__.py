"""replicate/ — the follower read plane's replication stream.

Mirrors ``kube_batch_tpu/replicate``.  The leader publishes each resident
swap as a KBR1 record: per-field row scatters with the resident cache's
full-upload break-even, and the dirty tracker's version token.  Followers
apply them to their own device-resident copy of the snapshot and serve
what-ifs from it with the query plane (``serve/``), answering as the
leader does for the same applied record.

- :mod:`.stream`    — the KBR1 frame: encode, decode, the config wire;
- :mod:`.publisher` — the leader side: host mirrors, the deferred encode,
  the ring and ``record_for(since)``;
- :mod:`.follower`  — the follower side: the pull loop over
  ``k8s/transport.py``, the applier (delta apply, resync escalation) and
  the read-only cache.
"""

from kube_batch_tpu_torch.replicate.stream import (  # noqa: F401
    ReplicationRecord, decode_record, encode_record,
)
from kube_batch_tpu_torch.replicate.publisher import ReplicationPublisher  # noqa: F401
from kube_batch_tpu_torch.replicate.follower import (  # noqa: F401
    FollowerApplier, FollowerCache, ReplicationFollower,
)
