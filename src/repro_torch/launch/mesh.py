"""Tensor-parallel meshes on ``torch.distributed``, the counterpart of
``repro/launch/mesh.py:make_tp_mesh``, and the launcher of their ranks.

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

``spawn_tp(fn, tp, device, *args)`` starts ``tp`` rank processes
(``torch.multiprocessing``, "spawn"), makes each rank's mesh and returns
what ``fn(mesh, *args)`` returned on each rank.  ``fn`` is pickled by
name, so it must live in an importable module.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_lib
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device

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

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture the collectives."""
        return self.backend == "nccl"

    def describe(self) -> str:
        how = ("host-staged through gloo, eager steps" if self.staged else self.backend)
        return (f"tp={self.size} rank {self.rank} on {self.device} ({how}"
                f"{', ranks share the device' if self.shared else ''})")

    # -- the model's collectives ----------------------------------------------
    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, the same bytes on every rank."""
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
        return out.movedim(0, dim).reshape(shape)

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
    dev = resolve_device(device) if torch.device(device).type == "cuda" else torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"tensor parallelism runs on cuda or cpu, not {dev.type}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"backend {backend!r} does not run on {dev.type}")
    count = torch.cuda.device_count() if dev.type == "cuda" else tp
    if backend == "nccl" and tp > count:
        raise ValueError(
            f"--tp {tp} exceeds the {count} visible GPU(s): NCCL takes one GPU per rank; "
            f"ranks that share GPUs run over gloo (backend='gloo')")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != tp:
        raise ValueError(f"--tp {tp} but the process group has {world} rank(s) "
                         f"(WORLD_SIZE); start the ranks with spawn_tp or torchrun")
    rank = int(os.environ.get("RANK", "0"))
    if dev.type == "cuda":  # the rank's GPU on its own host
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % count)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=tp,
                                device_id=dev if backend == "nccl" else None)
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", (tp,),
                            mesh_dim_names=("tp",))
    host_group = dist.new_group(backend="gloo", timeout=HOST_TIMEOUT)
    return TPMesh(size=tp, rank=rank, device=dev, backend=backend,
                  staged=backend == "gloo" and dev.type == "cuda",
                  shared=dev.type == "cuda" and count < tp,
                  group=mesh.get_group("tp"), host_group=host_group)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, tp: int, port: int, device, backend, threads, fn, args, results):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      LOCAL_RANK=str(rank), WORLD_SIZE=str(tp))
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = make_tp_mesh(tp, device, backend)
        try:
            results.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))


def spawn_tp(fn: Callable, tp: int, device="cuda", *args, backend: Optional[str] = None,
             threads: int = 0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``tp`` new rank processes, rank r's mesh
    from ``make_tp_mesh(tp, device, backend)``, over a rendezvous on a free
    loopback port; returns each rank's result in rank order.  ``threads``
    > 0 sets each rank's intra-op threads.  If a rank fails, the others
    are stopped and its traceback raised."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, tp, port, device, backend, threads, fn, args, results))
             for r in range(tp)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * tp
    done, deadline = 0, time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while done < tp:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and out[r] is None]
                if dead and results.empty():
                    raise RuntimeError(f"rank(s) {dead} of tp={tp} died without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"tp={tp} ranks gave no result in {SPAWN_TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of tp={tp} failed:\n{value}")
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
