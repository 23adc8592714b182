"""Plugin argument map with typed getters (framework/arguments.go:26-66),
mirroring ``kube_batch_tpu/framework/arguments.py``."""

from __future__ import annotations


class Arguments(dict):
    """map[string]string with GetInt/GetBool/GetFloat semantics: missing or
    unparsable values leave the caller's default untouched."""

    def get_int(self, key: str, default: int) -> int:
        v = self.get(key)
        if v is None:
            return default
        try:
            return int(str(v).strip())
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        v = self.get(key)
        if v is None:
            return default
        try:
            return float(str(v).strip())
        except ValueError:
            return default

    def get_bool(self, key: str, default: bool) -> bool:
        v = self.get(key)
        if v is None:
            return default
        s = str(v).strip().lower()
        if s in ("true", "1", "yes"):
            return True
        if s in ("false", "0", "no"):
            return False
        return default
