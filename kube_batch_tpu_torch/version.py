"""Version info, mirroring ``kube_batch_tpu/version.py`` (the reference's
pkg/version/version.go, injected there through LD_FLAGS): the same text,
so ``/version`` and ``--version`` read alike in both packages."""

VERSION = "0.1.0"
GIT_SHA = "dev"


def version_string() -> str:
    return f"kube-batch-tpu {VERSION} ({GIT_SHA})"
