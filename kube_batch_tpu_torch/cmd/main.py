"""Process entry (cmd/kube-batch/main.go), mirroring
``kube_batch_tpu/cmd/main.py``: ``python -m kube_batch_tpu_torch.cmd.main``.

``--version`` prints and returns 0; an invalid option returns 2.  The
device is the keyword ``device=`` (default CUDA, raising without a card),
not a flag: the process schedules on the card."""

from __future__ import annotations

import logging
import sys

from kube_batch_tpu_torch.cmd import options, server
from kube_batch_tpu_torch.version import version_string


def main(argv=None, device=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname).1s%(asctime)s %(name)s] %(message)s",
    )
    opt = options.parse(argv)
    if opt.print_version:
        print(version_string())
        return 0
    try:
        opt.check_option_or_die()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    server.run(opt, device=device)  # validated: run() itself doesn't re-check
    return 0


if __name__ == "__main__":
    sys.exit(main())
