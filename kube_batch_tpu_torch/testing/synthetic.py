"""Synthetic workloads at the sizes users run (50k pods × 5k nodes).

Mirrors ``kube_batch_tpu/testing/synthetic.py``, with the same
``np.random.default_rng(seed)`` draws in the same order, so each
generator's output equals the JAX package's:

  synthetic_device_snapshot — the snapshot arrays directly, moved to the
    device: pending gangs of ``gang_size`` over ``n_queues`` queues; a
    ``gpu_task_frac`` of the gangs asks for GPUs, which only the first
    ``gpu_node_frac`` of the nodes carry
  synthetic_cluster, synthetic_overcommit_cluster — a real
    ``SchedulerCache`` built through its ingest handlers, for the whole
    scheduling cycle; ``synthetic_cluster`` optionally adds the features
    the JAX package's generator lacks (PodDisruptionBudget gangs, claims on
    a PV ledger), drawn from a generator of their own
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from kube_batch_tpu_torch.api.convert import snapshot_from_numpy
from kube_batch_tpu_torch.api.resources import GPU, ResourceSpec
from kube_batch_tpu_torch.api.snapshot import (
    UNBOUNDED,
    DeviceSnapshot,
    SnapshotMeta,
    bucket,
)
from kube_batch_tpu_torch.api.types import TaskStatus

GiB = float(2**30)

NODE_CPU = 32000.0       # 32 cores in milli
NODE_MEM = 128 * GiB
NODE_PODS = 110.0
NODE_GPU = 8000.0        # 8 GPUs in milli

CPU_CHOICES = np.array([250.0, 500.0, 1000.0, 2000.0, 4000.0])
MEM_CHOICES = np.array([1, 2, 4, 8]) * GiB


def synthetic_device_snapshot(
    n_tasks: int = 50_000,
    n_nodes: int = 5_000,
    gang_size: int = 4,
    n_queues: int = 3,
    gpu_task_frac: float = 0.0,
    gpu_node_frac: float = 0.25,
    seed: int = 0,
    spec: Optional[ResourceSpec] = None,
    device=None,
) -> Tuple[DeviceSnapshot, SnapshotMeta]:
    """A pending synthetic workload as a snapshot of tensors on ``device``
    (default CUDA; see :func:`kube_batch_tpu_torch.device.resolve_device`)."""
    rng = np.random.default_rng(seed)
    spec = spec or ResourceSpec(scalar_names=(GPU,))
    R = spec.n
    gpu_col = spec.index(GPU)

    n_jobs = -(-n_tasks // gang_size)
    T, N, J, Q = bucket(n_tasks), bucket(n_nodes), bucket(n_jobs), bucket(n_queues)

    # ---- tasks ----------------------------------------------------------
    task_req = np.zeros((T, R), np.float32)
    task_req[:n_tasks, 0] = rng.choice(CPU_CHOICES, n_tasks)
    task_req[:n_tasks, 1] = rng.choice(MEM_CHOICES, n_tasks)
    task_req[:n_tasks, 2] = 1.0
    task_job = np.zeros(T, np.int32)
    task_job[:n_tasks] = np.arange(n_tasks) // gang_size
    if gpu_task_frac > 0:
        # whole gangs ask for GPUs so gang semantics stay heterogeneous
        gpu_jobs = rng.random(n_jobs) < gpu_task_frac
        is_gpu_task = gpu_jobs[task_job[:n_tasks]]
        task_req[:n_tasks, gpu_col] = np.where(
            is_gpu_task, rng.choice([1000.0, 2000.0, 4000.0], n_tasks), 0.0
        )
    task_valid = np.zeros(T, bool)
    task_valid[:n_tasks] = True

    # ---- nodes ----------------------------------------------------------
    node_alloc = np.zeros((N, R), np.float32)
    node_alloc[:n_nodes, 0] = NODE_CPU
    node_alloc[:n_nodes, 1] = NODE_MEM
    node_alloc[:n_nodes, 2] = NODE_PODS
    n_gpu_nodes = int(n_nodes * gpu_node_frac)
    node_alloc[:n_gpu_nodes, gpu_col] = NODE_GPU
    node_valid = np.zeros(N, bool)
    node_valid[:n_nodes] = True

    # ---- jobs -----------------------------------------------------------
    job_min = np.zeros(J, np.int32)
    job_min[:n_jobs] = np.minimum(
        gang_size, n_tasks - np.arange(n_jobs) * gang_size
    )  # last gang may be short
    job_queue = np.zeros(J, np.int32)
    job_queue[:n_jobs] = np.arange(n_jobs) % n_queues
    job_prio = np.zeros(J, np.int32)
    job_prio[:n_jobs] = np.where(rng.random(n_jobs) < 0.05, 100, 0)
    job_valid = np.zeros(J, bool)
    job_valid[:n_jobs] = True

    # ---- queues ---------------------------------------------------------
    queue_weight = np.ones(Q, np.float32)
    queue_weight[:n_queues] = 1.0 + np.arange(n_queues)
    queue_valid = np.zeros(Q, bool)
    queue_valid[:n_queues] = True
    queue_request = np.zeros((Q, R), np.float32)
    np.add.at(queue_request, job_queue[task_job[:n_tasks]], task_req[:n_tasks])

    total = node_alloc[:n_nodes].sum(axis=0).astype(np.float32)

    arrays = DeviceSnapshot(
        task_req=task_req,
        task_resreq=task_req.copy(),
        task_job=task_job,
        task_prio=np.zeros(T, np.int32),
        task_creation=np.arange(T, dtype=np.int32),
        task_status=np.where(
            task_valid, TaskStatus.PENDING, TaskStatus.UNKNOWN
        ).astype(np.int32),
        task_valid=task_valid,
        task_pending=task_valid.copy(),
        task_best_effort=np.zeros(T, bool),
        task_sel_bits=np.zeros((T, 1), np.uint32),
        task_sel_impossible=np.zeros(T, bool),
        task_tol_bits=np.zeros((T, 1), np.uint32),
        task_node=np.full(T, -1, np.int32),
        task_critical=np.zeros(T, bool),
        task_needs_host=np.zeros(T, bool),
        task_aff_idx=np.full(1, -1, np.int32),
        task_aff_mask=np.ones((1, N), bool),
        task_pref_idx=np.full(1, -1, np.int32),
        task_pref_node=np.zeros((1, N), np.float32),
        task_pref_pod=np.zeros((1, N), np.float32),
        node_idle=node_alloc.copy(),
        node_releasing=np.zeros((N, R), np.float32),
        node_used=np.zeros((N, R), np.float32),
        node_alloc=node_alloc,
        node_valid=node_valid,
        node_sched=node_valid.copy(),
        node_label_bits=np.zeros((N, 1), np.uint32),
        node_taint_bits=np.zeros((N, 1), np.uint32),
        job_min_avail=job_min,
        job_ready=np.zeros(J, np.int32),
        job_queue=job_queue,
        job_prio=job_prio,
        job_creation=np.arange(J, dtype=np.int32),
        job_valid=job_valid,
        job_schedulable=job_valid.copy(),
        job_allocated=np.zeros((J, R), np.float32),
        queue_weight=queue_weight,
        queue_capability=np.full((Q, R), UNBOUNDED, np.float32),
        queue_alloc=np.zeros((Q, R), np.float32),
        queue_request=queue_request,
        queue_valid=queue_valid,
        total=total,
        quanta=spec.quanta.astype(np.float32),
    )
    meta = SnapshotMeta(
        spec=spec,
        task_keys=[f"bench/t{i}" for i in range(n_tasks)],
        node_names=[f"n{i}" for i in range(n_nodes)],
        job_uids=[f"bench/j{i}" for i in range(n_jobs)],
        queue_names=[f"q{i}" for i in range(n_queues)],
        label_pair_bit={},
        taint_bit={},
        n_tasks=n_tasks,
        n_nodes=n_nodes,
        n_jobs=n_jobs,
        n_queues=n_queues,
    )
    return snapshot_from_numpy(arrays, device), meta


def synthetic_overcommit_cluster(
    n_running: int = 800,
    n_pending: int = 400,
    n_nodes: int = 100,
    gang_size: int = 4,
    seed: int = 0,
):
    """An overcommitted 2-queue cluster: queue q0 (weight 1) runs gangs that
    fill every node's cpu; queue q1 (weight 3) has pending gangs that fit
    only where capacity frees up."""
    from kube_batch_tpu_torch.api.pod import GROUP_NAME_ANNOTATION, Node, Pod, PodGroup, Queue
    from kube_batch_tpu_torch.api.types import PodPhase
    from kube_batch_tpu_torch.cache.cache import SchedulerCache

    rng = np.random.default_rng(seed)
    cache = SchedulerCache()
    cache.add_queue(Queue(name="q0", weight=1))
    cache.add_queue(Queue(name="q1", weight=3))
    for i in range(n_nodes):
        cache.add_node(Node(name=f"n{i}", allocatable={
            "cpu": NODE_CPU, "memory": NODE_MEM, "pods": NODE_PODS}))
    # running workload in q0, round-robin across nodes, saturating cpu
    per_node = max(1, n_running // n_nodes)
    cpu_each = NODE_CPU / per_node
    n_run_jobs = -(-n_running // gang_size)
    for j in range(n_run_jobs):
        cache.add_pod_group(PodGroup(name=f"run{j}", namespace="bench", min_member=1,
                                     queue="q0", creation_index=j))
    for i in range(n_running):
        cache.add_pod(Pod(
            name=f"r{i}", namespace="bench",
            requests={"cpu": cpu_each, "memory": 1 * GiB},
            annotations={GROUP_NAME_ANNOTATION: f"run{i // gang_size}"},
            phase=PodPhase.RUNNING,
            node_name=f"n{i % n_nodes}",
            creation_index=i,
        ))
    # pending gangs in the heavier queue
    n_pend_jobs = -(-n_pending // gang_size)
    for j in range(n_pend_jobs):
        cache.add_pod_group(PodGroup(
            name=f"pend{j}", namespace="bench",
            min_member=min(gang_size, n_pending - j * gang_size),
            queue="q1", creation_index=n_run_jobs + j))
    for i in range(n_pending):
        cache.add_pod(Pod(
            name=f"p{i}", namespace="bench",
            requests={"cpu": float(rng.choice(CPU_CHOICES)),
                      "memory": float(rng.choice(MEM_CHOICES))},
            annotations={GROUP_NAME_ANNOTATION: f"pend{i // gang_size}"},
            phase=PodPhase.PENDING,
            creation_index=n_running + i,
        ))
    return cache


def synthetic_cluster(
    n_tasks: int = 200,
    n_nodes: int = 20,
    gang_size: int = 4,
    n_queues: int = 2,
    seed: int = 0,
    host_ports_frac: float = 0.0,
    pdb_gang_frac: float = 0.0,
    pvc_pods: int = 0,
    pvc_impossible: int = 0,
):
    """A pending synthetic workload through the real cache handlers: gangs
    of ``gang_size`` over ``n_queues`` queues on identical nodes.  A
    ``host_ports_frac`` of the tasks asks for a hostPort from a 64-port
    pool, a host-only constraint that routes their job through the allocate
    replay's slow path.  Returns the ``SchedulerCache`` (fake binder).

    The features below draw from their own generator (seeded from
    ``seed``), so with all of them off the cluster is the JAX package's:

    - ``pdb_gang_frac`` of the gangs are defined by a PodDisruptionBudget
      (the legacy gang source): no PodGroup, the pods owned by controller
      ``rs-pg<j>``, ``min_available`` the gang size, in the ``default``
      queue (added).  Every fourth such gang has a member asking for twice
      a node's cpu, so it never fits and must bind nothing.
    - ``pvc_pods`` pods claim one PersistentVolume each from a
      ``StandalonePVBinder`` (attached before the nodes, so node ingest
      feeds it labels) holding as many PVs: half restricted by hostname
      topology to one node each and pre-bound to their claim (the node
      carries its ``kubernetes.io/hostname`` label and the pod selects it,
      as a local-volume user pins the pod), half wildcard.
    - ``pvc_impossible`` more pods claim PVCs whose durable binding names a
      PV that does not exist: they can never bind."""
    from kube_batch_tpu_torch.api.pod import (
        GROUP_NAME_ANNOTATION,
        HOSTNAME_TOPOLOGY,
        Node,
        PersistentVolume,
        Pod,
        PodDisruptionBudget,
        PodGroup,
        Queue,
    )
    from kube_batch_tpu_torch.api.types import PodPhase
    from kube_batch_tpu_torch.cache.cache import SchedulerCache

    rng = np.random.default_rng(seed)
    frng = np.random.default_rng([seed, 8])
    n_jobs = -(-n_tasks // gang_size)
    volume_binder = None
    pinned: dict = {}   # pod index → (claim, node)
    claims: dict = {}   # pod index → claim
    if pvc_pods or pvc_impossible:
        from kube_batch_tpu_torch.cache.volume import StandalonePVBinder

        volume_binder = StandalonePVBinder()
        picks = frng.choice(n_tasks, pvc_pods + pvc_impossible, replace=False).tolist()
        n_pinned = pvc_pods // 2
        stride = max(1, n_nodes // max(1, n_pinned))
        for k, i in enumerate(picks):
            if k < n_pinned:
                pinned[i] = (f"claim-{k}", f"n{(k * stride) % n_nodes}")
                claims[i] = f"claim-{k}"
            elif k < pvc_pods:
                claims[i] = f"claim-{k}"
            else:
                claims[i] = f"ghost-{k}"
                # a durable binding to a PV that is gone
                volume_binder.bound[f"ghost-{k}"] = f"pv-gone-{k}"
    cache = SchedulerCache(spec=ResourceSpec(scalar_names=(GPU,)),
                           volume_binder=volume_binder)

    pdb_jobs = (frng.random(n_jobs) < pdb_gang_frac) if pdb_gang_frac > 0 else None
    for q in range(n_queues):
        cache.add_queue(Queue(name=f"q{q}", weight=q + 1))
    if pdb_jobs is not None and pdb_jobs.any():
        cache.add_queue(Queue(name=cache.default_queue))
    pinned_nodes = {node for _claim, node in pinned.values()}
    for i in range(n_nodes):
        name = f"n{i}"
        cache.add_node(Node(
            name=name, allocatable={"cpu": NODE_CPU, "memory": NODE_MEM, "pods": NODE_PODS},
            labels={HOSTNAME_TOPOLOGY: name} if name in pinned_nodes else {}))
    if volume_binder is not None:
        for k, (claim, node) in enumerate(sorted(pinned.values())):
            volume_binder.add_pv(PersistentVolume(
                name=f"pv-{claim}", node=node, claim=claim,
                node_terms=[[(HOSTNAME_TOPOLOGY, "In", (node,))]]))
        for k in range(pvc_pods - len(pinned)):
            volume_binder.add_pv(PersistentVolume(name=f"pv-w{k}"))
    too_large = set()
    n_pdb = 0
    for j in range(n_jobs):
        size = min(gang_size, n_tasks - j * gang_size)
        if pdb_jobs is not None and pdb_jobs[j]:
            cache.add_pdb(PodDisruptionBudget(
                name=f"pdb{j}", namespace="bench", min_available=size,
                owner=f"rs-pg{j}", creation_index=j))
            if n_pdb % 4 == 0:
                too_large.add(j * gang_size)
            n_pdb += 1
            continue
        cache.add_pod_group(PodGroup(
            name=f"pg{j}", namespace="bench", min_member=size,
            queue=f"q{j % n_queues}", creation_index=j))
    ported = rng.random(n_tasks) < host_ports_frac if host_ports_frac > 0 else None
    for i in range(n_tasks):
        j = i // gang_size
        cpu = float(rng.choice(CPU_CHOICES))
        mem = float(rng.choice(MEM_CHOICES))
        ports = ((7000 + int(rng.integers(64)),)
                 if ported is not None and ported[i] else ())
        pdb = pdb_jobs is not None and pdb_jobs[j]
        pin = pinned.get(i)
        cache.add_pod(Pod(
            name=f"t{i}", namespace="bench",
            requests={"cpu": 2 * NODE_CPU if i in too_large else cpu, "memory": mem},
            annotations={} if pdb else {GROUP_NAME_ANNOTATION: f"pg{j}"},
            owner=f"rs-pg{j}" if pdb else None,
            phase=PodPhase.PENDING,
            creation_index=i,
            host_ports=ports,
            node_selector={HOSTNAME_TOPOLOGY: pin[1]} if pin else {},
            volume_claims=(claims[i],) if i in claims else (),
        ))
    return cache
