"""Action registry (actions/factory.go:29-35): the five actions of the
shipped conf."""

from kube_batch_tpu_torch.actions.allocate import AllocateAction
from kube_batch_tpu_torch.actions.backfill import BackfillAction
from kube_batch_tpu_torch.actions.enqueue import EnqueueAction
from kube_batch_tpu_torch.actions.preempt import PreemptAction
from kube_batch_tpu_torch.actions.reclaim import ReclaimAction
from kube_batch_tpu_torch.framework.interface import register_action

ALL_ACTIONS = (EnqueueAction, ReclaimAction, AllocateAction, BackfillAction,
               PreemptAction)

for cls in ALL_ACTIONS:
    register_action(cls.name, cls)

__all__ = ["AllocateAction", "BackfillAction", "EnqueueAction",
           "PreemptAction", "ReclaimAction", "ALL_ACTIONS"]
