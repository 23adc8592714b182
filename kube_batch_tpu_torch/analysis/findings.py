"""One audit finding, as the JAX package's analyzer prints it
(``kube_batch_tpu/analysis/engine.py`` ``Finding``): ``path:line:col:
RULE message``.  The device-program audits have no source line, so their
path names the program and the shape point (``<programs:entry>``,
``<memory:entry@point>``) and line and column are 0."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
