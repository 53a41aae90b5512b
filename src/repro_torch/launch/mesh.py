"""Meshes of ranks on ``torch.distributed``, the counterpart of
``repro/launch/mesh.py`` (``make_tp_mesh``, ``make_production_mesh``,
``make_host_mesh``), and the launcher of their ranks.

The port runs tensor parallelism SPMD: one process per rank, each holding
its shard of the model as plain tensors (``sharding/partition.py``) and
calling the collectives itself where the reference places a sharding
constraint: ``all_reduce`` (fp32 partial sums) and ``gather`` along a dim
(``gather_last`` the last one).  ``make_tp_mesh`` joins the calling process to its group and
returns a ``TPMesh``: the group of the ``("tp",)`` device mesh, which the
model's collectives run on, a gloo group for the serving engine's host
broadcasts, and the collectives themselves.

Two arrangements:

* **NCCL**, one GPU per rank (rank r on ``cuda:r``): collectives run on the
  device and can be captured in a CUDA graph.
* **gloo**, on the CPU, or on GPUs that ranks share (rank r on ``cuda:(r %
  count)``; on one card every rank on ``cuda:0``).  Gloo is given CUDA
  tensors through host buffers, staged explicitly (``TPMesh.staged``),
  and cannot be captured: a serving engine on such a mesh refuses
  ``cuda_graph=True``.  This arrangement checks correctness; its latencies
  are those of host copies and loopback sockets, not of tensor
  parallelism.

Training runs on a two-axis ``("data", "model")`` mesh (``make_mesh``):
rank ``i·tp + j`` is data index i and model index j.  ``Mesh.model`` is a
``TPMesh`` over the model axis, which the model's tensor-parallel
collectives run on as they do for serving; ``Mesh.data`` is one over the
data axis, which FSDP gathers parameters and reduce-scatters gradients on
(``sharding/fsdp.py``).  ``make_production_mesh`` is the reference's 16 x
16 over the world's ranks (``multi_pod``: its two pods, a data axis of 32
with a ``pod`` axis across them); ``make_host_mesh`` puts every rank on
data (one rank: the one-device run).  ``Mesh.count(log)`` counts each
axis's collectives into a ``sharding.record.CollectiveLog`` (off by
default), by the rule the dry-run's recording mesh counts them.

``spawn_mesh(fn, shape, device, *args)`` starts ``prod(shape)`` rank
processes (``torch.multiprocessing``, "spawn"), makes each rank's mesh
(a ``TPMesh`` for ``(tp,)``, a ``Mesh`` for ``(dp, tp)``) and returns what
``fn(mesh, *args)`` returned on each rank; ``spawn_tp(fn, tp, ...)`` is
its ``(tp,)`` case.  ``fn`` is pickled by name, so it must live in an
importable module.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_lib
import math
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.sharding.record import CollectiveLog, tensor_bytes

# how long a rank waits in a host broadcast for rank 0's next command: a
# served engine may sit idle between requests
HOST_TIMEOUT = datetime.timedelta(days=7)
# how long ``spawn_tp`` waits for every rank's result
SPAWN_TIMEOUT_S = 3600.0


@dataclasses.dataclass
class TPMesh:
    """One rank's view of a ``("tp",)`` mesh of ``size`` ranks."""
    size: int
    rank: int
    device: torch.device
    backend: str                 # "nccl" or "gloo"
    staged: bool                 # CUDA tensors go through host buffers (gloo)
    shared: bool                 # ranks share a device (draw weights in turn)
    group: Any                   # the ("tp",) device mesh's group: the model's collectives
    host_group: Any              # gloo: the engine's host broadcasts
    axis: str = "tp"             # the axis's name in a ``CollectiveLog``
    log: Optional[CollectiveLog] = None  # where the collectives are counted (off: None)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture the collectives."""
        return self.backend == "nccl"

    def describe(self) -> str:
        how = ("host-staged through gloo, eager steps" if self.staged else self.backend)
        return (f"tp={self.size} rank {self.rank} on {self.device} ({how}"
                f"{', ranks share the device' if self.shared else ''})")

    # -- the model's collectives ----------------------------------------------
    def _count(self, kind: str, t: torch.Tensor) -> None:
        """Log a collective whose result is ``t`` (``sharding/record.py``)."""
        if self.log is not None:
            self.log.add(self.axis, kind, tensor_bytes(t))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, the same bytes on every rank."""
        self._count("all-reduce", t)
        return self._all_reduce(t)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.staged:
            host = t.cpu()
            dist.all_reduce(host, group=self.group)
            return host.to(t.device)
        t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Each rank's ``t`` side by side along ``dim``, rank order: the
        dim grows ``size`` times, the same bytes on every rank (a cache's
        L slices, a recurrent block's width, a state's heads)."""
        dim = dim % t.dim()
        if self.backend == "nccl":
            out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        else:
            src = t.cpu() if self.staged else t.contiguous()
            parts = [torch.empty_like(src) for _ in range(self.size)]
            dist.all_gather(parts, src, group=self.group)
            out = torch.stack(parts).to(t.device)
        shape = list(t.shape)
        shape[dim] *= self.size
        out = out.movedim(0, dim).reshape(shape)
        self._count("all-gather", out)
        return out

    def gather_root(self, t: torch.Tensor, dim: int) -> Optional[torch.Tensor]:
        """Each rank's ``t`` side by side along ``dim`` on the axis's rank 0
        (on the host where the mesh is staged), None on the others: one
        receiver, for what only one rank keeps (a checkpoint)."""
        dim = dim % t.dim()
        src = t.cpu() if self.staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)] if self.rank == 0 else None
        dist.gather(src, parts, dst=dist.get_global_rank(self.group, 0), group=self.group)
        return torch.cat(parts, dim) if self.rank == 0 else None

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of ``t`` over the ranks, cut into ``size`` equal parts
        along ``dim``: the rank's part (``size`` divides the dim).  Gloo
        all-reduces, keeps a copy of the part and frees the whole; it
        counts as one reduce-scatter."""
        dim = dim % t.dim()
        n = t.shape[dim] // self.size
        if self.backend == "nccl":
            src = t.movedim(dim, 0).contiguous()
            out = torch.empty((n,) + tuple(src.shape[1:]), dtype=t.dtype, device=t.device)
            dist.reduce_scatter_tensor(out, src, group=self.group)
            out = out.movedim(0, dim)
        else:
            whole = self._all_reduce(t if self.staged else t.clone())
            out = whole.narrow(dim, self.rank * n, n).clone()
        self._count("reduce-scatter", out)
        return out

    def gather_last(self, t: torch.Tensor) -> torch.Tensor:
        """Each rank's ``t`` (..., n) side by side along the last dim, rank
        order: (..., size * n), the same bytes on every rank."""
        return self.gather(t, -1)

    def warm(self) -> None:
        """One collective on the device, so a communicator created lazily
        (NCCL) exists before a CUDA graph capture needs it."""
        self.all_reduce(torch.zeros(1, device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)

    # -- host objects (the serving engine's commands and ledgers) -------------
    def broadcast_object(self, obj: Any = None) -> Any:
        """Rank 0's ``obj`` on every rank (the argument is ignored elsewhere)."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]

    def gather_objects(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's ``obj`` in rank order on rank 0, None elsewhere."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.host_group)
        return out


def make_tp_mesh(tp: int, device="cuda", backend: Optional[str] = None) -> TPMesh:
    """Join this process to a ``("tp",)`` mesh of ``tp`` ranks and return
    its view.  The rank and the rendezvous come from the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` and ``spawn_tp`` set them).  On ``cuda`` the default
    backend is NCCL, one GPU per rank, and fewer visible GPUs than ``tp``
    raise, as the reference raises for fewer devices; ``backend="gloo"``
    lets ranks share GPUs.  On ``cpu`` the backend is gloo."""
    if tp < 1:
        raise ValueError(f"--tp must be >= 1, got {tp}")
    dev, backend, count, rank = _join(tp, device, backend)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", (tp,),
                            mesh_dim_names=("tp",))
    host_group = dist.new_group(backend="gloo", timeout=HOST_TIMEOUT)
    return TPMesh(size=tp, rank=rank, device=dev, backend=backend,
                  staged=backend == "gloo" and dev.type == "cuda",
                  shared=dev.type == "cuda" and count < tp,
                  group=mesh.get_group("tp"), host_group=host_group)


@dataclasses.dataclass
class Mesh:
    """One rank's view of a ``("data", "model")`` mesh of ``dp`` x ``tp``
    ranks: ``data`` and ``model`` are ``TPMesh`` views of its two axes
    (each with the axis's group, size and this rank's index on it), so
    the model's tensor-parallel collectives run on ``model`` unchanged.
    A mesh of several pods (the reference's ``("pod", "data", "model")``
    with the data axis over pod and data) has ``pod``: the axis across
    the pods, which a parameter that the whole data axis does not divide
    splits over (``rules.data_split``)."""
    shape: Tuple[int, int]
    rank: int
    device: torch.device
    backend: str
    staged: bool
    shared: bool
    data: TPMesh
    model: TPMesh
    host_group: Any              # gloo over every rank: preemption votes, turns
    pod: Optional[TPMesh] = None

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def pods(self) -> int:
        return self.pod.size if self.pod is not None else 1

    def count(self, log: Optional[CollectiveLog]) -> None:
        """Count every axis's collectives into ``log`` (None: stop)."""
        for axis in (self.data, self.model, self.pod):
            if axis is not None:
                axis.log = log

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (an all-reduce on the host
        group): every rank gets the same answer."""
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        dist.all_reduce(t, group=self.host_group)
        return bool(t.item())


def _join(world: int, device, backend: Optional[str]) -> Tuple[torch.device, str, int, int]:
    """Join this process to the world's process group (once): returns the
    rank's device, the backend, the visible GPU count and the rank."""
    dev = resolve_device(device) if torch.device(device).type == "cuda" else torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on cuda or cpu, not {dev.type}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"backend {backend!r} does not run on {dev.type}")
    count = torch.cuda.device_count() if dev.type == "cuda" else world
    if backend == "nccl" and world > count:
        raise ValueError(
            f"a mesh of {world} ranks exceeds the {count} visible GPU(s): NCCL takes one GPU per rank; "
            f"ranks that share GPUs run over gloo (backend='gloo')")
    have = int(os.environ.get("WORLD_SIZE", "1"))
    if have != world:
        raise ValueError(f"a mesh of {world} rank(s) but the process group has {have} "
                         f"rank(s) (WORLD_SIZE); start the ranks with spawn_mesh or torchrun")
    rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":  # the rank's GPU on its own host
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % count)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world,
                                device_id=dev if backend == "nccl" else None)
    return dev, backend, count, rank


def make_mesh(shape: Sequence[int], device="cuda", backend: Optional[str] = None,
              pods: int = 1) -> Mesh:
    """Join this process to a ``("data", "model")`` mesh of ``shape`` = (dp,
    tp) ranks and return its view; the world (``WORLD_SIZE``) must hold dp
    x tp ranks.  ``pods`` > 1 splits the data axis into that many pods
    (data index ``p·dp/pods + k`` is index k of pod p) and adds the
    ``pod`` axis across them.  The backend is chosen as ``make_tp_mesh``
    chooses it.  A process already in the world's group (another mesh of
    the same ranks) makes the new mesh's groups only: every rank must
    call it."""
    dp, tp = (int(n) for n in shape)
    if dp < 1 or tp < 1:
        raise ValueError(f"a mesh's axes must be >= 1, got (data {dp}, model {tp})")
    if pods < 1 or dp % pods:
        raise ValueError(f"{pods} pods do not split a data axis of {dp}")
    dev, backend, count, rank = _join(dp * tp, device, backend)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", (dp, tp),
                            mesh_dim_names=("data", "model"))
    host_group = dist.new_group(backend="gloo", timeout=HOST_TIMEOUT)
    staged = backend == "gloo" and dev.type == "cuda"
    shared = dev.type == "cuda" and count < dp * tp

    def axis(name: str, size: int, index: int, group) -> TPMesh:
        return TPMesh(size=size, rank=index, device=dev, backend=backend, staged=staged,
                      shared=shared, group=group, host_group=host_group, axis=name)

    pod = None
    if pods > 1:  # every rank makes every pod group, in one order
        per = dp // pods
        for k in range(per):
            for j in range(tp):
                group = dist.new_group([(p * per + k) * tp + j for p in range(pods)])
                if (rank // tp) % per == k and rank % tp == j:
                    pod = axis("pod", pods, (rank // tp) // per, group)
    return Mesh(shape=(dp, tp), rank=rank, device=dev, backend=backend, staged=staged,
                shared=shared, data=axis("data", dp, rank // tp, mesh.get_group("data")),
                model=axis("model", tp, rank % tp, mesh.get_group("model")),
                host_group=host_group, pod=pod)


PRODUCTION_SHAPE = (16, 16)
# two pods of it: (pod 2, data 16, model 16), the data axis over pod and data
PRODUCTION_PODS = 2


def make_production_mesh(device="cuda", backend: Optional[str] = None,
                         multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, 16 x 16 over ``("data", "model")``,
    or with ``multi_pod`` two pods of it (512 ranks, the data axis of 32
    over pod and data), over the world's ranks; another world size raises
    ``ValueError`` naming the count, as the reference's ``jax.make_mesh``
    raises for too few devices."""
    pods = PRODUCTION_PODS if multi_pod else 1
    dp, tp = PRODUCTION_SHAPE[0] * pods, PRODUCTION_SHAPE[1]
    need = dp * tp
    have = int(os.environ.get("WORLD_SIZE", "1"))
    if have != need:
        what = f"{pods} x " if pods > 1 else ""
        raise ValueError(f"--mesh production is {what}{PRODUCTION_SHAPE[0]} x "
                         f"{PRODUCTION_SHAPE[1]} = {need} ranks (data, model), but the world "
                         f"has {have}; start {need} ranks with torchrun, or use --mesh host")
    return make_mesh((dp, tp), device, backend, pods=pods)


def make_host_mesh(device="cuda", backend: Optional[str] = None) -> Mesh:
    """Every rank of the world on ``data`` (model 1): one rank, as under a
    plain ``python -m``, is the one-device run."""
    return make_mesh((int(os.environ.get("WORLD_SIZE", "1")), 1), device, backend)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, shape, port: int, device, backend, threads, fn, args, results):
    world = math.prod(shape)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = (make_tp_mesh(shape[0], device, backend) if len(shape) == 1
                else make_mesh(shape, device, backend))
        try:
            results.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))


def spawn_mesh(fn: Callable, shape: Sequence[int], device="cuda", *args,
               backend: Optional[str] = None, threads: int = 0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``prod(shape)`` new rank processes, rank
    r's mesh from ``make_tp_mesh(tp, device, backend)`` for ``shape`` =
    (tp,) or ``make_mesh((dp, tp), device, backend)``, over a rendezvous on
    a free loopback port; returns each rank's result in rank order.
    ``threads`` > 0 sets each rank's intra-op threads.  If a rank fails,
    the others are stopped and its traceback raised."""
    shape = tuple(int(n) for n in shape)
    if len(shape) not in (1, 2):
        raise ValueError(f"a mesh shape is (tp,) or (data, model), got {shape}")
    world = math.prod(shape)
    what = f"tp={shape[0]}" if len(shape) == 1 else f"mesh {shape}"
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, shape, port, device, backend, threads, fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * world
    done, deadline = 0, time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while done < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and out[r] is None]
                if dead and results.empty():
                    raise RuntimeError(f"rank(s) {dead} of {what} died without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{what} ranks gave no result in {SPAWN_TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {what} failed:\n{value}")
            out[rank] = value
            done += 1
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return out


def spawn_tp(fn: Callable, tp: int, device="cuda", *args, backend: Optional[str] = None,
             threads: int = 0) -> List[Any]:
    """``spawn_mesh`` of a ``(tp,)`` mesh: ``fn(mesh, *args)`` on ``tp``
    ranks, each with ``make_tp_mesh(tp, device, backend)``'s ``TPMesh``."""
    return spawn_mesh(fn, (tp,), device, *args, backend=backend, threads=threads)
