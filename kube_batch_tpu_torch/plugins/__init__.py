"""Plugin registry (plugins/factory.go:31-42 + binpack), mirroring
``kube_batch_tpu/plugins/__init__.py`` into the port's own registry."""

from kube_batch_tpu_torch.framework.interface import register_plugin_builder
from kube_batch_tpu_torch.plugins.binpack import BinpackPlugin
from kube_batch_tpu_torch.plugins.conformance import ConformancePlugin
from kube_batch_tpu_torch.plugins.drf import DrfPlugin
from kube_batch_tpu_torch.plugins.gang import GangPlugin
from kube_batch_tpu_torch.plugins.nodeorder import NodeOrderPlugin
from kube_batch_tpu_torch.plugins.predicates import PredicatesPlugin
from kube_batch_tpu_torch.plugins.priority import PriorityPlugin
from kube_batch_tpu_torch.plugins.proportion import ProportionPlugin

ALL_PLUGINS = (
    GangPlugin,
    DrfPlugin,
    ProportionPlugin,
    PriorityPlugin,
    PredicatesPlugin,
    NodeOrderPlugin,
    ConformancePlugin,
    BinpackPlugin,
)

for cls in ALL_PLUGINS:
    register_plugin_builder(cls.name, cls)

__all__ = [cls.__name__ for cls in ALL_PLUGINS] + ["ALL_PLUGINS"]
