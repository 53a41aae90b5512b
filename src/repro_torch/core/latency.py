"""Measured-mode latency profiling: TTFT / TPOT / TTLT (paper §2.3), the
counterpart of ``repro/core/latency.py``.

Semantics follow the paper:

* **TTFT** — latency of the prefill forward pass on a fresh random prompt,
  run eagerly: the paper does not CUDA-graph-cache prefill.
* **TPOT** — inter-token interval of autoregressive decode against a
  prefilled cache.  On the card the decode step is captured once per
  (batch, max_len) as a CUDA graph and each step is one replay: the paper's
  CUDA-graph-cached generation, as the reference replays its AOT-compiled
  step.
* **TTLT** — end-to-end prefill + generation for a batch of requests, the
  generation replayed from the same graph.

Each sample is host ``perf_counter`` time around work that ends in
``torch.cuda.synchronize()``; the device is also synchronized before the
clock starts, so queued set-up work is not counted.  The first calls of
each measurement are warm-up and are reported as ``compile_s``: on the
card they include the CUDA kernels' first launches, cuBLAS's first calls
and the capture of the decode graph.  ``LatencyStats.window`` is the host
clock's span of the timed samples, which the energy windows integrate.
``time_callable`` times any callable the same way, waiting for its
results' CUDA devices after each call.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.cache import reset_cache
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


@dataclasses.dataclass
class LatencyStats:
    name: str
    samples_s: List[float]
    compile_s: float = 0.0
    # perf_counter span of the timed samples, warm-up excluded
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def mean_s(self) -> float:
        return statistics.fmean(self.samples_s)

    @property
    def std_s(self) -> float:
        return statistics.pstdev(self.samples_s) if len(self.samples_s) > 1 else 0.0

    @property
    def p50_s(self) -> float:
        return statistics.median(self.samples_s)

    @property
    def p95_s(self) -> float:
        xs = sorted(self.samples_s)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1e3

    def summary(self) -> Dict[str, float]:
        return {
            "name": self.name, "mean_ms": self.mean_ms,
            "std_ms": self.std_s * 1e3, "p50_ms": self.p50_s * 1e3,
            "p95_ms": self.p95_s * 1e3, "n": len(self.samples_s),
            "compile_ms": self.compile_s * 1e3,
        }


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in ``out`` (a tensor, or lists,
    tuples and dicts of them, at any depth)."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_cuda_devices(o) for o in out))
    return set()


def _wait(out) -> None:
    """``torch.cuda.synchronize`` each CUDA device ``out`` lives on: the
    counterpart of ``jax.block_until_ready``."""
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def time_callable(fn: Callable[[], object], iters: int = 10, warmup: int = 2,
                  name: str = "fn") -> LatencyStats:
    """Host time of ``fn()`` over ``iters`` calls after ``warmup`` ones
    (at least one, reported as ``compile_s``), each call waited for
    through its results' devices, as the reference's ``time_callable``."""
    t0 = time.perf_counter()
    for _ in range(max(warmup, 1)):
        _wait(fn())
    compile_s = time.perf_counter() - t0
    samples, t_first = [], 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn())
        t1 = time.perf_counter()
        t_first = t_first or t0
        samples.append(t1 - t0)
    return LatencyStats(name=name, samples_s=samples, compile_s=compile_s,
                        window=(t_first, t1) if samples else (0.0, 0.0))


def prompt_positions(batch: Dict[str, torch.Tensor]) -> int:
    """The positions a prompt ``batch`` fills: its tokens, after its patch
    embeddings in a vision model."""
    n = batch["tokens"].shape[1]
    return n + (batch["vision_embeds"].shape[1] if "vision_embeds" in batch else 0)


class DecodeRunner:
    """``model.decode_step`` over one cache of (batch, max_len), with the
    token and position kept on the device.

    With ``cuda_graph`` the step is captured once, as ``ServingEngine``
    captures its step (``dispatch.capture_graph``), and each ``step`` is one
    replay, credited to each kernel's ``launches`` count.  A capture that
    fails raises.  The graph reads the tensors it captured, so the cache is
    reset in place between prompts, never replaced."""

    def __init__(self, model: Model, batch: int, max_len: int, cuda_graph: bool):
        dev = model.device
        self.model = model
        self.cache = model.init_cache(batch, max_len)
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.logits: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Dict[str, int] = {}
        self.replays = 0
        if cuda_graph:
            self.graph, self.logits, self.launches = dispatch.capture_graph(
                lambda: model.decode_step(self.tok, self.pos, self.cache)[0], dev)

    def prefill(self, batch: Dict[str, torch.Tensor]) -> None:
        """Prefill ``batch`` into the reset cache; the greedy pick becomes
        the first decode step's token, at the position after the prompt's
        last (its patch embeddings counted, in a vision model)."""
        logits, _ = self.model.prefill(batch, self.cache)
        self.tok.copy_(logits.argmax(-1, keepdim=True))
        self.pos.fill_(prompt_positions(batch))

    def step(self) -> torch.Tensor:
        """One decode step at ``pos``; returns its fp32 logits (B, vocab)."""
        if self.graph is None:
            self.logits, _ = self.model.decode_step(self.tok, self.pos, self.cache)
        else:
            self.graph.replay()
            self.replays += 1
            dispatch.credit(self.launches)
        return self.logits

    def advance(self) -> None:
        """The greedy pick of the last step and the next position, on the
        device."""
        self.tok.copy_(self.logits.argmax(-1, keepdim=True))
        self.pos.add_(1)


def random_batch(cfg: ModelConfig, batch: int, prompt_len: int,
                 gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A random prompt of ``prompt_len`` positions drawn from ``gen`` on its
    device, as the reference's: in a vision model ``num_vision_tokens``
    patch embeddings and the rest tokens; in an encoder-decoder model also
    ``prompt_len // 2`` frame embeddings; embeddings 0.1 N(0, 1).  A
    vision prompt no longer than its patches raises: the reference keeps
    one token then and overruns the cache."""
    nv = cfg.num_vision_tokens
    if nv and prompt_len <= nv:
        raise ValueError(f"{cfg.name}: a prompt of {prompt_len} positions leaves no token "
                         f"after its {nv} patch embeddings; measure at more than {nv}")
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len - nv),
                                   generator=gen, device=gen.device)}

    def embeds(n):
        x = torch.randn((batch, n, cfg.d_model), generator=gen, device=gen.device)
        return (0.1 * x).to(getattr(torch, cfg.dtype))

    if nv:
        out["vision_embeds"] = embeds(nv)
    if cfg.is_encdec:
        out["enc_embeds"] = embeds(max(prompt_len // 2, 1))
    return out


class LatencyProfiler:
    """TTFT / TPOT / TTLT measurement for one model + workload.
    ``cuda_graph=False`` runs the decode step eagerly, to compare with the
    replayed one; on a CPU device there is no graph."""

    def __init__(self, cfg: ModelConfig, model: Model, *, seed: int = 0,
                 device="cuda", cuda_graph: bool = True):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, profiler on {self.device}")
        self.cfg = cfg
        self.model = model
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.runners: Dict[Tuple[int, int], DecodeRunner] = {}

    # -- helpers -------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _random_batch(self, batch: int, prompt_len: int) -> Dict[str, torch.Tensor]:
        return random_batch(self.cfg, batch, prompt_len, self.gen)

    def runner(self, batch: int, max_len: int) -> DecodeRunner:
        """The decode runner of (batch, max_len), made (and captured) on
        first use."""
        key = (batch, max_len)
        if key not in self.runners:
            self.runners[key] = DecodeRunner(self.model, batch, max_len, self.cuda_graph)
        return self.runners[key]

    # -- metrics ---------------------------------------------------------------
    def ttft(self, batch: int, prompt_len: int, iters: int = 10,
             warmup: int = 2) -> LatencyStats:
        """Prefill latency; fresh random prompt each run (paper §2.3)."""
        cache = self.model.init_cache(batch, prompt_len + 1)
        samples, t_compile, t_first = [], 0.0, 0.0
        for i in range(warmup + iters):
            b = self._random_batch(batch, prompt_len)
            self._sync()
            t0 = time.perf_counter()
            self.model.prefill(b, cache)
            self._sync()
            t1 = time.perf_counter()
            if i < warmup:
                t_compile += t1 - t0
            else:
                t_first = t_first or t0
                samples.append(t1 - t0)
        return LatencyStats(name="ttft", samples_s=samples, compile_s=t_compile,
                            window=(t_first, t1))

    def tpot(self, batch: int, prompt_len: int, gen_len: int = 32,
             warmup: int = 2) -> LatencyStats:
        """Per-token decode latency after prefilling a random prompt.  The
        capture (on first use of this shape) and ``warmup`` steps run
        before the prefill, since a step writes the cache in place."""
        self._sync()
        t0 = time.perf_counter()
        run = self.runner(batch, prompt_len + gen_len + 1)
        for _ in range(warmup):
            run.step()
            self._sync()
        compile_s = time.perf_counter() - t0
        reset_cache(run.cache)
        run.prefill(self._random_batch(batch, prompt_len))
        self._sync()
        samples, t_first = [], 0.0
        for _ in range(gen_len):
            t0 = time.perf_counter()
            run.step()
            self._sync()
            t1 = time.perf_counter()
            t_first = t_first or t0
            samples.append(t1 - t0)
            run.advance()
        return LatencyStats(name="tpot", samples_s=samples, compile_s=compile_s,
                            window=(t_first, t1))

    def ttlt(self, batch: int, prompt_len: int, gen_len: int,
             iters: int = 3) -> LatencyStats:
        """End-to-end request latency: prefill + gen_len decode steps."""
        self.ttft(batch, prompt_len, iters=1, warmup=1)
        self._sync()
        t0 = time.perf_counter()
        run = self.runner(batch, prompt_len + gen_len + 1)
        run.step()
        self._sync()
        compile_s = time.perf_counter() - t0
        samples, t_first = [], 0.0
        for _ in range(iters):
            reset_cache(run.cache)
            b = self._random_batch(batch, prompt_len)
            self._sync()
            t0 = time.perf_counter()
            run.prefill(b)
            for _ in range(gen_len):
                run.step()
                run.advance()
            self._sync()
            t1 = time.perf_counter()
            t_first = t_first or t0
            samples.append(t1 - t0)
        return LatencyStats(name="ttlt", samples_s=samples, compile_s=compile_s,
                            window=(t_first, t1))

    def greedy(self, tokens: torch.Tensor, gen_len: int,
               **embeds: torch.Tensor) -> torch.Tensor:
        """The greedy continuation of ``tokens`` (B, S) through TTLT's loop:
        (B, gen_len + 1) tokens, the prefill's pick and then each decode
        step's.  ``embeds``: the prompt's ``vision_embeds`` or
        ``enc_embeds``, as the model takes them."""
        batch = {"tokens": tokens, **embeds}
        run = self.runner(tokens.shape[0], prompt_positions(batch) + gen_len + 1)
        reset_cache(run.cache)
        run.prefill(batch)
        out = [run.tok.clone()]
        for _ in range(gen_len):
            run.step()
            run.advance()
            out.append(run.tok.clone())
        return torch.cat(out, dim=1)
