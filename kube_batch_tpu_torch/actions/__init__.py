"""Action registry (actions/factory.go:29-35): the port has allocate."""

from kube_batch_tpu_torch.actions.allocate import AllocateAction
from kube_batch_tpu_torch.framework.interface import register_action

ALL_ACTIONS = (AllocateAction,)

for cls in ALL_ACTIONS:
    register_action(cls.name, cls)

__all__ = ["AllocateAction", "ALL_ACTIONS"]
