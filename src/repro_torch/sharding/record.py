"""Counting a rank's collectives, and a mesh that only counts them: the
counterpart of ``repro/core/hlo.py:collective_stats``, which reads the
collectives of the reference's compiled per-device program.

``CollectiveLog`` holds ``(axis, kind, bytes)`` for each collective a
rank issues, by the reference's convention: the bytes of the *result*
(an all-reduce: the tensor; an all-gather: the gathered whole; a
reduce-scatter: the rank's part), kinds named as the HLO ops are
(``all-reduce``, ``all-gather``, ``reduce-scatter``).  The real meshes
(``launch.mesh.TPMesh``) append to one when a caller sets it
(``Mesh.count``); counting is host-side bookkeeping only, off by default.
Host broadcasts, barriers, ``Mesh.any`` and a checkpoint's gather to
rank 0 are not collectives of a step and are not counted: the reference's
HLO has none.

``RecordingMesh((dp, tp), pods=)`` stands in for one rank (rank 0) of a
``("data", "model")`` mesh on the ``meta`` device: its axes have
``TPMesh``'s interface, and each call returns a meta tensor of the shape
the real call returns, allocated as the NCCL path allocates it, and logs
the call.  So the port's own code (``sharding/fsdp.py``,
``sharding/collectives.py``, the model's tensor-parallel call sites, the
train step) runs the rank's program on meta as it runs on the ranks, and
the dry-run counts what a real mesh would count.  ``pods`` > 1 splits the
data axis into ``pods`` pods (the reference's ``("pod", "data")``): the
axis ``pod`` is the one a leaf that the whole data axis does not divide
falls back to (``rules.data_split``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CollectiveLog:
    """``(axis, kind, bytes)`` of each collective, in issue order."""

    def __init__(self):
        self.entries: List[Tuple[str, str, int]] = []

    def add(self, axis: str, kind: str, nbytes: int) -> None:
        self.entries.append((axis, kind, int(nbytes)))

    def mark(self) -> int:
        """A position to summarize from (``summary(since=)``)."""
        return len(self.entries)

    def summary(self, since: int = 0) -> Dict:
        """Counts and bytes by kind (and bytes by axis) of the entries from
        ``since`` on, with the reference's keys: ``counts``,
        ``bytes_by_kind``, ``bytes``, and ``bytes_by_axis``; and
        ``by_axis_kind``: "<axis> <kind>" -> [count, bytes]."""
        counts: Dict[str, int] = {}
        by_kind: Dict[str, int] = {}
        by_axis: Dict[str, int] = {}
        both: Dict[str, List[int]] = {}
        for axis, kind, n in self.entries[since:]:
            counts[kind] = counts.get(kind, 0) + 1
            by_kind[kind] = by_kind.get(kind, 0) + n
            by_axis[axis] = by_axis.get(axis, 0) + n
            cell = both.setdefault(f"{axis} {kind}", [0, 0])
            cell[0] += 1
            cell[1] += n
        return {"counts": counts, "bytes_by_kind": by_kind, "bytes": sum(by_kind.values()),
                "bytes_by_axis": by_axis, "by_axis_kind": both}


@dataclasses.dataclass
class RecordingAxis:
    """One axis of a ``RecordingMesh``: ``launch.mesh.TPMesh``'s interface
    on meta tensors, each collective logged and answered with a meta
    tensor of the real result's shape."""
    name: str
    size: int
    log: CollectiveLog
    rank: int = 0
    device: torch.device = torch.device("meta")
    staged: bool = False

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """In place, as NCCL's: the same tensor."""
        self.log.add(self.name, "all-reduce", tensor_bytes(t))
        return t

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        dim = dim % t.dim()
        out = t.new_empty((self.size,) + tuple(t.shape))
        shape = list(t.shape)
        shape[dim] *= self.size
        out = out.movedim(0, dim).reshape(shape)
        self.log.add(self.name, "all-gather", tensor_bytes(out))
        return out

    def gather_last(self, t: torch.Tensor) -> torch.Tensor:
        return self.gather(t, -1)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        dim = dim % t.dim()
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // self.size,) + tuple(src.shape[1:])).movedim(0, dim)
        self.log.add(self.name, "reduce-scatter", tensor_bytes(out))
        return out


class RecordingMesh:
    """Rank 0 of a ``("data", "model")`` mesh of ``shape`` = (dp, tp) on the
    ``meta`` device, ``launch.mesh.Mesh``'s interface; every axis logs into
    one ``log``.  With ``pods`` > 1 the data axis is ``pods`` pods of dp /
    pods ranks, and ``pod`` the axis across them."""

    def __init__(self, shape, pods: int = 1):
        dp, tp = (int(n) for n in shape)
        if pods < 1 or dp % pods:
            raise ValueError(f"{pods} pods do not split a data axis of {dp}")
        self.shape = (dp, tp)
        self.rank, self.device, self.shared = 0, torch.device("meta"), False
        self.log = CollectiveLog()
        self.data = RecordingAxis("data", dp, self.log)
        self.model = RecordingAxis("model", tp, self.log)
        self.pod = RecordingAxis("pod", pods, self.log) if pods > 1 else None

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def pods(self) -> int:
        return self.pod.size if self.pod is not None else 1
