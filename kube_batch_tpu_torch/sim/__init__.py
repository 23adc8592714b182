"""Virtual-time cluster simulator: event-driven workload replay, fault
injection, and longitudinal scheduling metrics over the real
Scheduler/SchedulerCache, mirroring ``kube_batch_tpu/sim``. See
sim/runner.py for the loop and `python -m kube_batch_tpu_torch.sim --help`
for the CLI (CUDA; in process, ``main(argv, device="cpu")`` runs on the
CPU)."""

from kube_batch_tpu_torch.sim.runner import SimConfig, SimRunner, preset, run_preset

__all__ = ["SimConfig", "SimRunner", "preset", "run_preset"]
