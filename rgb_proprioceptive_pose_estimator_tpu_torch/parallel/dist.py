"""Data parallelism over ``torch.distributed``, one process per device
(counterpart of the JAX package's ``parallel/mesh.py``).

The reference runs pure data parallelism on a 1-D mesh: the batch is
sharded on its leading dimension, parameters, optimizer state and
BatchNorm statistics are replicated, and XLA compiles the gradient and
statistics all-reduces into the step. Here each device runs a process (a
rank), and the same parts are explicit:

- ``launch`` starts the ranks (start method ``spawn``: a forked child
  cannot use CUDA) and ``init`` joins each to the group;
- the host pipeline builds each rank's contiguous slice of the one seeded
  global batch (``data/pipeline.HostPipeline``, ``rank``/``world``);
- ``DistributedDataParallel`` (``data_parallel``) averages the gradients;
- BatchNorm sums its per-channel statistics over the ranks with
  ``all_reduce_sum``, so they are the global batch's, as under pjit;
- camera dropout draws the global batch's mask on every rank and keeps
  the rank's rows (``models/fusion.py``);
- logged losses and eval metrics are averaged over the ranks (``mean``).

Backends: "nccl" when every rank has a card of its own, "gloo" on the CPU
and for several ranks sharing one card (NCCL refuses that). The backend is
always the caller's argument: nothing falls back from one to the other.

Across hosts (``dist.multihost``, the reference's
``jax.distributed.initialize``): each host runs one launcher
(``launch_host``) with its ``dist.process_id`` p of
``dist.num_processes`` P, which starts one rank per local device, L of
them (every visible card; one process on the CPU). The launcher of host 0
serves a ``TCPStore`` at ``dist.coordinator`` (``host:port``); every host
checks there that all have L devices, and every rank joins the one group
through it, as global rank ``p * L + local rank`` of ``P * L``. Global
rank r's rows of a batch are then process p's contiguous slice, cut into
its local devices. Global rank 0 writes the checkpoints, which every host
reads back from ``train.ckpt_dir`` (a filesystem they share, as orbax
assumes in the reference).
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import inspect
import os
import signal
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as tdist

BACKENDS = ("nccl", "gloo")
Device = Union[str, torch.device]
# how long a host waits for the others at the coordinator
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


def is_initialized() -> bool:
    """Whether this process is a rank of an initialized process group."""
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def world() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def check_multihost(cfg) -> None:
    """Raise ValueError, naming the field, for a ``dist.multihost`` config
    the launcher cannot run: a device count (the reference's refusal: the
    group spans every device of every host), an empty or malformed
    ``coordinator``, or a ``process_id`` outside ``[0, num_processes)``."""
    d = cfg.dist
    if not d.multihost:
        return
    if d.num_devices:
        raise ValueError(
            "dist.num_devices is single-process only; under multihost the "
            "mesh must span all global devices (got "
            f"num_devices={d.num_devices}, processes={d.num_processes})")
    if d.num_processes < 1:
        raise ValueError(f"dist.num_processes must be >= 1, got "
                         f"{d.num_processes}")
    if not 0 <= d.process_id < d.num_processes:
        raise ValueError(
            f"dist.process_id={d.process_id} is outside [0, "
            f"dist.num_processes={d.num_processes})")
    coordinator_address(cfg)


def coordinator_address(cfg) -> Tuple[str, int]:
    """(host, port) of ``dist.coordinator``."""
    c = cfg.dist.coordinator
    host, _, port = c.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"dist.coordinator must be 'host:port' (where host 0 of the "
            f"run listens) under dist.multihost, got {c!r}")
    return host, int(port)


def local_devices(cfg, device: Device) -> List[torch.device]:
    """The devices of this host's ranks under dist.multihost: every
    visible CUDA card, or the CPU once."""
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.device("cpu")]
    return rank_devices(device, resolve_local(device))


def resolve_local(device: torch.device) -> int:
    """Visible CUDA cards (raising when there is none)."""
    if device.type != "cuda":
        raise ValueError(f"data parallelism runs on cuda or cpu, not "
                         f"{device.type}")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible == 0:
        raise RuntimeError("no CUDA card is visible; pass device='cpu' to "
                           "run the plain versions on the CPU")
    return visible


def resolve_num_devices(cfg, device: Device) -> int:
    """The data-parallel width that ``cfg.dist.num_devices`` asks for on
    ``device``'s kind, as the reference's ``make_mesh``: 0 means every
    visible CUDA card (1 on the CPU, where N > 0 means N processes); a
    count above the visible cards raises. Under dist.multihost it is
    every host's local devices together. Inside a process group the width
    is the group's, which a nonzero count must equal."""
    check_multihost(cfg)
    n = cfg.dist.num_devices
    if n < 0:
        raise ValueError(f"dist.num_devices must be >= 0, got {n}")
    if is_initialized():
        if n and n != world():
            raise ValueError(
                f"dist.num_devices={n}, but this process is a rank of a "
                f"group of {world()}")
        return world()
    if cfg.dist.multihost:
        return cfg.dist.num_processes * len(local_devices(cfg, device))
    device = torch.device(device)
    if device.type == "cpu":
        return n or 1
    visible = resolve_local(device)
    if n > visible:
        raise ValueError(f"requested {n} devices, have {visible}")
    return n or visible


def rank_devices(device: Device, n: int) -> List[torch.device]:
    """The devices of ``n`` ranks: cuda:0 .. cuda:n-1, or the CPU n
    times."""
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.device("cpu")] * n
    return [torch.device("cuda", i) for i in range(n)]


def default_backend(device: Device) -> str:
    """"gloo" on the CPU, "nccl" on CUDA (one card per rank)."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def init(rank: int, world: int, device: Device, backend: str,
         init_method: Union[str, Tuple[str, int]]) -> None:
    """Join this process to the group as ``rank`` of ``world``, on
    ``device`` (made the current CUDA device). ``init_method`` is a
    torch URL, or the (host, port) of a multihost coordinator's store."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    options = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend == "nccl":
        options["device_id"] = device       # binds the rank to its card
    if isinstance(init_method, str):
        options["init_method"] = init_method
    else:
        host, port = init_method
        options["store"] = tdist.PrefixStore("group", tdist.TCPStore(
            host, port, is_master=False, timeout=RENDEZVOUS_TIMEOUT))
    tdist.init_process_group(backend, rank=rank, world_size=world,
                             **options)


def _comm_device() -> torch.device:
    """Where a collective's own small tensors live: NCCL takes only CUDA
    tensors."""
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the cotangent of x is the sum over ranks
    of y's cotangent (every rank's loss depends on every rank's x)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks (x itself on one)."""
    if world() == 1:
        return x
    return _AllReduceSum.apply(x)


def sum_(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the ranks in place, outside autograd; returns x."""
    if world() > 1:
        tdist.all_reduce(x)
    return x


def mean(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar of ``values`` averaged over the ranks, in one
    all-reduce (the dict itself on one rank)."""
    if world() == 1 or not values:
        return values
    keys = sorted(values)
    stacked = torch.stack([values[k].detach().float().reshape(())
                           for k in keys])
    sum_(stacked)
    stacked /= world()
    return dict(zip(keys, stacked.unbind(0)))


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (every rank gets the answer)."""
    if world() == 1:
        return flag
    t = torch.tensor([int(flag)], device=_comm_device())
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX)
    return bool(t.item())


def barrier() -> None:
    if world() > 1:
        tdist.barrier()


def data_parallel(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` in DistributedDataParallel, which averages its gradients
    over the ranks. Buffers are not broadcast before each forward:
    BatchNorm's running statistics come from the global batch and are
    equal on every rank already (torch 2.13 renames the option)."""
    from torch.nn.parallel import DistributedDataParallel

    dev = next(model.parameters()).device
    options = inspect.signature(DistributedDataParallel).parameters
    no_sync = ({"forward_sync_buffers": False}
               if "forward_sync_buffers" in options
               else {"broadcast_buffers": False})
    return DistributedDataParallel(
        model, device_ids=[dev] if dev.type == "cuda" else None, **no_sync)


def rows(tree: Any, rank_: int, world_: int) -> Any:
    """Rank ``rank_``'s contiguous slice of the leading dimension of every
    array in ``tree`` (a global batch: dicts of numpy arrays or
    tensors)."""
    if isinstance(tree, dict):
        return {k: rows(v, rank_, world_) for k, v in tree.items()}
    per = tree.shape[0] // world_
    return tree[rank_ * per:(rank_ + 1) * per]


# ---------------------------------------------------------------------------
# launching the ranks
# ---------------------------------------------------------------------------

def _backend_flags() -> Dict[str, bool]:
    """This process's cuDNN and TF32 settings, which the ranks take."""
    b = torch.backends
    return {"deterministic": b.cudnn.deterministic,
            "benchmark": b.cudnn.benchmark,
            "cudnn_tf32": b.cudnn.allow_tf32,
            "matmul_tf32": b.cuda.matmul.allow_tf32}


def _set_backend_flags(flags: Dict[str, bool]) -> None:
    b = torch.backends
    b.cudnn.deterministic = flags["deterministic"]
    b.cudnn.benchmark = flags["benchmark"]
    b.cudnn.allow_tf32 = flags["cudnn_tf32"]
    b.cuda.matmul.allow_tf32 = flags["matmul_tf32"]


def _rank_main(local: int, first: int, world_: int, devices: Sequence[str],
               backend: str, init_method, workdir: str, threads: int,
               flags: Dict[str, bool]) -> None:
    torch.set_num_threads(threads)
    _set_backend_flags(flags)
    device = torch.device(devices[local])
    init(first + local, world_, device, backend, init_method)
    try:
        fn, cfg, args = torch.load(os.path.join(workdir, "payload.pt"),
                                   weights_only=False)
        out = fn(cfg, device, *args)
        torch.save(out, os.path.join(workdir, f"rank{local}.pt"))
        barrier()
    finally:
        tdist.destroy_process_group()


@contextlib.contextmanager
def _forwarding_sigterm(pids: Sequence[int]):
    """While open, a SIGTERM to this process is sent on to ``pids``: a
    scheduler's preemption signal goes to the process it started, and the
    ranks act on it (``train.save_on_signal``: every rank checkpoints the
    same step and returns). Only from the main thread, where Python
    allows signal handlers."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def forward(signum, frame):
        for pid in pids:
            try:
                os.kill(pid, signum)
            except ProcessLookupError:
                pass

    previous = signal.signal(signal.SIGTERM, forward)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, previous)


def stop_resource_tracker() -> None:
    """Stop and reap multiprocessing's resource tracker, the process that
    starting ranks with ``spawn`` starts beside them to unlink their
    semaphores. Python 3.12.3 stops it only when its pipe closes at this
    process's exit, so it outlives the launching program by a moment; the
    next launch starts it anew. Unreachable semaphores are collected
    first, as their finalizers would start it again. A process that
    inherited its parent's tracker (a spawned process, as each host of
    ``launch_host`` may be) leaves it to that parent: 3.12.3 would wait
    for a pid it does not have."""
    from multiprocessing import resource_tracker

    gc.collect()
    tracker = resource_tracker._resource_tracker
    stop = getattr(tracker, "_stop", None)
    if stop is not None and getattr(tracker, "_pid", None) is not None:
        stop()


def child_processes() -> List[int]:
    """Pids of this process's children still in the process table
    (running, or exited and not yet reaped), read from /proc."""
    me, pids = os.getpid(), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # "pid (comm) state ppid ...", where comm may hold spaces
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            pids.append(int(entry))
    return pids


def launch(fn: Callable, cfg, devices: Sequence[Device], backend: str,
           *args, first_rank: int = 0, world_size: Optional[int] = None,
           init_method: Optional[Tuple[str, int]] = None) -> List[Any]:
    """Run ``fn(cfg, device, *args)`` in ``len(devices)`` new processes,
    rank r on ``devices[r]``, joined in a ``backend`` group; return each
    rank's result, in rank order. (``launch_host`` passes this host's
    ``first_rank`` of a group of ``world_size`` and its coordinator's
    ``init_method``.)

    ``fn`` must be importable by its module path (it is pickled by
    reference), and ``cfg``, ``args`` and the results are passed through
    files in a private temporary directory. The group meets at a
    ``file://`` store in that directory, so that concurrent launches never
    share a port. Each rank takes its share of this process's intra-op
    threads and this process's cuDNN and TF32 settings. For
    ranks on CUDA the kernels are built here first, once rather than by
    every rank, and this process's cached blocks go back to the card. A
    SIGTERM to this process goes on to the ranks. A rank that raises
    stops the others, and the error is raised here. No process of the
    launch is left when it returns or raises."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if world_size is None and n < 2:
        raise ValueError(f"launch starts 2 or more ranks, got {n}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and len(set(devices)) < n:
        raise ValueError(
            "NCCL refuses two ranks on one device; give each rank its own "
            "card, or pass backend='gloo' to share one")
    threads = max(1, torch.get_num_threads() // n)
    if any(d.type == "cuda" for d in devices):
        from rgb_proprioceptive_pose_estimator_tpu_torch.ops import _build

        _build.build()
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="rppt_dist_") as workdir:
        torch.save((fn, cfg, args), os.path.join(workdir, "payload.pt"))
        ranks = torch.multiprocessing.start_processes(
            _rank_main, args=(first_rank, world_size or n,
                              [str(d) for d in devices], backend,
                              init_method or f"file://{workdir}/rendezvous",
                              workdir, threads, _backend_flags()),
            nprocs=n, join=False, start_method="spawn")
        error = None
        try:
            with _forwarding_sigterm([p.pid for p in ranks.processes]):
                while not ranks.join():
                    pass
        except Exception as e:
            # the message holds the rank's traceback; this process's
            # frames would keep the ranks' queues alive past the stop
            error = e.with_traceback(None)
        del ranks
        stop_resource_tracker()
        if error is not None:
            raise error
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(n)]


def launch_host(fn: Callable, cfg, devices: Sequence[Device], backend: str,
                *args) -> List[Any]:
    """This host's part of a ``dist.multihost`` run: meet the other
    hosts at ``dist.coordinator`` (host 0 serves the store there), check
    that every host brings ``len(devices)`` = L devices, then ``launch``
    ``fn`` on them as global ranks ``process_id * L ..`` of
    ``num_processes * L``; returns this host's ranks' results. Host 0
    keeps the store until every host's ranks have ended."""
    check_multihost(cfg)
    host, port = coordinator_address(cfg)
    p, hosts, n = cfg.dist.process_id, cfg.dist.num_processes, len(devices)
    store = tdist.PrefixStore("hosts", tdist.TCPStore(
        host, port, is_master=p == 0, wait_for_workers=False,
        timeout=RENDEZVOUS_TIMEOUT))
    store.set(f"devices/{p}", str(n))
    try:
        counts = [int(store.get(f"devices/{q}")) for q in range(hosts)]
        if len(set(counts)) > 1:
            raise ValueError(
                f"dist.multihost: the hosts' device counts differ ({counts} "
                "by dist.process_id); every host must bring as many cards")
        return launch(fn, cfg, devices, backend, *args, first_rank=p * n,
                      world_size=hosts * n, init_method=(host, port))
    finally:
        store.set(f"done/{p}", "1")
        if p == 0:
            store.wait([f"done/{q}" for q in range(hosts)])


def launch_ranks(fn: Callable, cfg, device: Device, n: int,
                 *args) -> List[Any]:
    """``fn`` on the ``n`` ranks that ``resolve_num_devices`` gave: this
    host's part of a ``dist.multihost`` run (``launch_host``), else one
    rank per card over NCCL, or ``n`` processes on the CPU over gloo."""
    if cfg.dist.multihost:
        return launch_host(fn, cfg, local_devices(cfg, device),
                           default_backend(device), *args)
    return launch(fn, cfg, rank_devices(device, n), default_backend(device),
                  *args)


def run_each(calls: Sequence[tuple], device: Device) -> List[Any]:
    """``fn(cfg, device, *args)`` for each ``(fn, cfg, args)`` of
    ``calls``, in order: several rank targets in one ``launch(run_each,
    calls, ...)``, which starts the processes once."""
    return [fn(cfg, device, *args) for fn, cfg, args in calls]


# ---------------------------------------------------------------------------
# a rank target: steps on given global batches
# ---------------------------------------------------------------------------


def run_steps(cfg, device: Device, state_dict: Dict[str, torch.Tensor],
              batches: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Train ``cfg``'s model from ``state_dict`` on ``device``, one
    optimizer step per global batch of ``batches`` (dicts of numpy
    arrays), on this rank's rows of each (all of them on one rank), in
    DistributedDataParallel when the group has more than one rank: the
    rank target that holds a data-parallel step against one process.

    Returns, on the CPU: each step's loss components (averaged over the
    ranks) and kernel launches, the gradients of the first step (after
    the average, before the optimizer), and the final state_dict."""
    from rgb_proprioceptive_pose_estimator_tpu_torch.data.pipeline import (
        _to_device,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.state import (
        create_state,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.engine.train_step import (
        train_step,
    )
    from rgb_proprioceptive_pose_estimator_tpu_torch.ops import fused

    device = torch.device(device)
    state = create_state(cfg, device, state_dict)
    if world() > 1:
        state.ddp = data_parallel(state.model)
    counters = ("normalize_u8", "scale_bias_relu",
                "scale_bias_relu_backward", "channel_stats")
    first: Dict[str, torch.Tensor] = {}
    optimizer_step = state.optimizer.step

    def step_keeping_grads() -> None:
        if not first:
            first.update({n: p.grad.detach().cpu().clone() for n, p in
                          state.model.named_parameters()
                          if p.grad is not None})
        optimizer_step()

    state.optimizer.step = step_keeping_grads
    losses, launches = [], []
    for batch in batches:
        local = _to_device(rows(batch, rank(), world()), device)
        before = {k: getattr(fused, k).launches for k in counters}
        m = train_step(state, local, cfg.train)
        losses.append({k: float(v) for k, v in m.items()})
        launches.append({k: getattr(fused, k).launches - before[k]
                         for k in counters})
    return {"losses": losses, "launches": launches, "grads": first,
            "state_dict": {k: v.detach().cpu() for k, v in
                           state.model.state_dict().items()}}
