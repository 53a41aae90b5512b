#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

run from the root of a checkout; it puts ``src`` on the path itself and
builds the CUDA kernels on first use.  It imports nothing of JAX
or of the ``repro`` package.  Phases:

1. Device: name, count, ``nvidia-smi`` name and power limit, the board's
   idle power from NVML before any model is drawn, build time.
2. Each kernel against its plain PyTorch version at the main path's shapes
   (bf16, plus fp32 and edge cases), with kernel, plain, library and bound
   times; K1 plain and with the residual add fused, at the decode and
   prefill shapes, also with its host time per eager call; one K3 call and
   one K4 call captured in CUDA graphs and replayed as q_pos crosses their
   chunk boundaries; K4 and K5 also timed at other chunk plans; one
   ``{"kernels": [...]}`` line.
3. The measured path at full width: ``Elana("llama3.1-8b").measure``
   (TTFT eager; TPOT and TTLT from the decode step replayed from a CUDA
   graph), then the same with NVML energy; size and cache reports; launch
   counts of every kernel checked against the forward passes run, replays
   credited.  Then the replayed loop against the eager one on the same
   prompt (identical greedy tokens), TPOT both ways with the device time
   per replay and the busy share, one replay traced with
   ``capture_torch_trace``, and the ``h100`` estimate beside the
   measurement.
4. Device time by kernel, the number of device kernels and the device's
   busy share (torch.profiler) of an eager prefill and eager decode steps.
5. The serving path at full width: ``ServingEngine`` with a paged KV
   cache and its decode step replayed from a CUDA graph serves 24
   requests with NVML energy attribution; finishes, block accounting,
   launch counts and one dispatch per step checked.  Then the same
   greedy trace with and without the graph: identical streams.
6. Full-width parity: prefill + 4 greedy decode steps through the kernels
   and through the plain versions, both held against an fp32 copy of the
   same weights, over a contiguous cache (B=1) and a paged one (B=4,
   shuffled block tables).
7. Phases 3-6 again for the RG-LRU hybrid recurrentgemma-2b (26 layers:
   18 RG-LRU, 8 local attention over a 2048-token ring), once llama3.1-8b
   is freed: measure with exact launch counts (K5 18 per forward pass),
   graph against eager, the profile, 16 requests served (paged, CUDA-graph
   step) and 8 greedy ones with and without the graph, and the parity over
   a 2304-token prompt, past the window, so the ring wraps.
8. The last line: ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line is printed; so does a
machine without a CUDA device.
"""

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ARCH = "llama3.1-8b"
HYBRID = "recurrentgemma-2b"
SIZE_GB = {ARCH: "16.06", HYBRID: "5.36"}   # the reference's size reports
BATCH, PROMPT, GEN, ITERS = 1, 512, 32, 3
HYBRID_PARITY_PROMPT = 2304  # past the 2048-token window: the ring wraps
# the serving path: paged pool of 8 * 64 + 1 blocks of 16 tokens
SERVE = dict(cache_layout="paged", kv_block_size=16, max_batch=8, max_len=1024,
             prompt_bucket=64, seed=0)
SERVE_REQUESTS = {ARCH: 24, HYBRID: 16}
GRAPH_REQUESTS = {ARCH: 24, HYBRID: 8}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
BF16_FLOPS = 989e12             # dense tensor-core bf16, published
FP32_FLOPS = 67e12              # fp32 outside the tensor cores, published
L2_BYTES = 50 * 2**20


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, n_inputs, iters=60, warmup=6):
    """Mean device time per call with CUDA events; ``fn(i)`` runs on input
    set ``i % n_inputs``, which rotate through more than the L2 cache so
    each call finds its inputs cold, as on the main path.  The device first
    spins for ~0.1 s while the host enqueues every launch, so the events
    time the device's work and not the host's launch rate."""
    import torch

    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls=200, rounds=5):
    """Host time per eager call (µs): the median over ``rounds`` of
    ``calls`` calls enqueued behind a device spin, so the device never
    holds the host back."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(rounds):
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def copies(nbytes):
    """Input sets to rotate through so that they exceed the L2 cache."""
    return max(2, math.ceil(2 * L2_BYTES / max(nbytes, 1)))


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def close(a, b, tol):
    import torch

    try:
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    except AssertionError as e:
        raise CheckFailed(str(e)) from None


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
    from repro_torch.kernels.linear_recurrence import ops as lr_ops, ref as lr_ref
    from repro_torch.kernels.rmsnorm import ops as rn_ops, ref as rn_ref

    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    tol = {bf16: 2e-2, torch.float32: 2e-5}   # as the reference's kernel tests
    entries = []

    def log_time(name, shape, fn, case):
        """Device time of ``fn`` at a second shape of the path, inputs
        rotated past the L2 cache as for the table's shape."""
        *tensors, kw = case
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        n = copies(nbytes)
        sets = [[t.clone() for t in tensors] + [kw] for _ in range(n)]
        log(f"time {name} {shape}: kernel_ms={cuda_ms(lambda i: fn(sets[i]), n):.4f}")

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    def arange_pos(B, n, offset=0):
        return (torch.arange(n, dtype=torch.int32, device=dev) + offset).expand(B, n).contiguous()

    # -- K2 flash attention ---------------------------------------------------
    def fa_case(name, B, S, T, Hq, Hkv, D, dtype, window=0, softcap=0.0, k_offset=0,
                q_offset=0):
        q, k, v = randn(B, S, Hq, D, dtype=dtype), randn(B, T, Hkv, D, dtype=dtype), \
            randn(B, T, Hkv, D, dtype=dtype)
        qp, kp = arange_pos(B, S, q_offset), arange_pos(B, T, k_offset)
        kw = dict(q_positions=qp, k_positions=kp, causal=True, window=window, softcap=softcap)
        out = fa_ops.flash_attention(q, k, v, **kw)
        ref = fa_ref.attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check(out.shape == q.shape and torch.isfinite(out).all().item(), f"{name}: bad output")
        err = max_err(out, ref)
        close(out, ref, tol[dtype])
        log(f"check flash_attention {name}: max_abs_err={err:.3e} tol={tol[dtype]}")
        return (q, k, v, kw), err

    (q, k, v, kw), err = fa_case("main B=1 S=512 Hq=32 Hkv=8 D=128 causal",
                                 BATCH, PROMPT, PROMPT, 32, 8, 128, bf16)
    errs = [err]
    errs.append(fa_case("window=32 softcap=30 ragged S=96 D=80", 2, 96, 96, 4, 2, 80, bf16,
                        window=32, softcap=30.0)[1])
    (q2, k2, v2, kw2), e2 = fa_case("row with no valid key", 1, 64, 64, 4, 2, 64, bf16,
                                    k_offset=10)
    out2 = fa_ops.flash_attention(q2, k2, v2, **kw2)
    check(out2[:, :10].abs().max().item() == 0.0, "no-valid-key rows must be 0")
    errs.append(e2)
    fa_case("fp32 window=24 S=100 D=64", 2, 100, 100, 8, 2, 64, torch.float32, window=24)
    # recurrentgemma-2b's local attention: MQA G=10, D=256, window 2048, softcap 30
    hybrid_fa, e_h = fa_case(f"recurrentgemma B=1 S={PROMPT} Hq=10 Hkv=1 D=256 window=2048 "
                             f"softcap=30", 1, PROMPT, PROMPT, 10, 1, 256, bf16, window=2048,
                             softcap=30.0)
    errs.append(e_h)
    hybrid_long, e_l = fa_case(f"recurrentgemma past the window S={HYBRID_PARITY_PROMPT}", 1,
                               HYBRID_PARITY_PROMPT, HYBRID_PARITY_PROMPT, 10, 1, 256, bf16,
                               window=2048, softcap=30.0)
    errs.append(e_l)
    # the tensor-core kernel's edges: D = 8 padded to the mma depth, D = 256
    # with a ragged query tile, and a chunk of 96 queries over a cache
    errs.append(fa_case("D=8 padded S=100", 2, 100, 100, 8, 2, 8, bf16)[1])
    errs.append(fa_case("D=256 ragged S=70 softcap=30", 1, 70, 70, 10, 1, 256, bf16,
                        softcap=30.0)[1])
    errs.append(fa_case("chunk S=96 at 320.. over T=400 keys at 16..", 2, 96, 400, 32, 8, 128,
                        bf16, q_offset=320, k_offset=16)[1])
    fa_call = lambda args: fa_ops.flash_attention(*args[:3], **args[3])  # noqa: E731
    log_time("flash_attention", f"q (1,{PROMPT},10,256) window=2048 softcap=30", fa_call,
             hybrid_fa)
    log_time("flash_attention", f"q (1,{HYBRID_PARITY_PROMPT},10,256) window=2048 softcap=30",
             fa_call, hybrid_long)

    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    n = copies(4 * q.numel() * 2)
    sets = [(q.clone(), k.clone(), v.clone()) for _ in range(n)]
    qp, kp = kw["q_positions"], kw["k_positions"]
    pairs = ((kp[:, None, :] >= 0) & (qp[:, :, None] >= kp[:, None, :])).sum().item()
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * (qp.numel() + kp.numel())
    flops = 4 * D * pairs * Hq
    tq = [(a.transpose(1, 2).contiguous(), b.transpose(1, 2).contiguous(),
           c.transpose(1, 2).contiguous()) for a, b, c in sets]
    entries.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:100",
        shape=f"q ({B},{S},{Hq},{D}) k/v ({B},{S},{Hkv},{D}) bf16 causal",
        max_abs_err=max(errs),
        ms=cuda_ms(lambda i: fa_ops.flash_attention(*sets[i], **kw), n),
        plain_ms=cuda_ms(lambda i: fa_ref.attention(*sets[i], **kw), n, iters=20),
        library_ms=cuda_ms(lambda i: F.scaled_dot_product_attention(
            *tq[i], is_causal=True, enable_gqa=True), n),
        **bound(nbytes, flops, BF16_FLOPS)))

    # -- K3 decode attention --------------------------------------------------
    L = PROMPT + GEN + 1
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def da_case(name, B, L, Hq, Hkv, D, dtype, q_at, filled, window=0, ring_at=None,
                softcap=0.0):
        q = randn(B, 1, Hq, D, dtype=dtype)
        kc, vc = randn(B, L, Hkv, D, dtype=dtype), randn(B, L, Hkv, D, dtype=dtype)
        if ring_at is None:
            kp = arange_pos(B, L)
            kp = torch.where(kp < filled, kp, -1).to(torch.int32).contiguous()
        else:  # ring: slot j holds the latest position = j (mod L)
            slots = torch.arange(L, device=dev)
            kp = (ring_at - (ring_at - slots) % L).to(torch.int32).expand(B, L).contiguous()
        qp = torch.full((B, 1), q_at, dtype=torch.int32, device=dev)
        kw = dict(q_positions=qp, k_positions=kp, window=window, softcap=softcap)
        out = da_ops.decode_attention(q, kc, vc, **kw)
        ref = da_ref.decode_attention(q, kc, vc, **kw)
        # the merge algebra at the chunks the kernel itself splits into
        chunk = da_ops.split_plan(B, Hkv, L, sms)[1]
        split = da_ref.decode_attention_split(q, kc, vc, chunk=chunk, **kw)
        torch.cuda.synchronize()
        check(out.shape == q.shape and torch.isfinite(out).all().item(), f"{name}: bad output")
        err = max_err(out, ref)
        close(out, ref, tol[dtype])
        close(out, split, tol[dtype])
        log(f"check decode_attention {name}: max_abs_err={err:.3e} tol={tol[dtype]}; "
            f"against the split merge at chunk {chunk}: {max_err(out, split):.3e}")
        return (q, kc, vc, kw), err

    fill = PROMPT + 8  # slots beyond the decoded tokens are still -1
    (q, kc, vc, kw), err = da_case(f"main B=1 L={L} Hq=32 Hkv=8 D=128", 1, L, 32, 8, 128,
                                   bf16, q_at=fill - 1, filled=fill)
    errs = [err]
    errs.append(da_case(f"B=8 L={L}", 8, L, 32, 8, 128, bf16, q_at=fill - 1, filled=fill)[1])
    errs.append(da_case("ring L=64 window=64 at 150", 2, 64, 8, 2, 128, bf16, q_at=150,
                        filled=0, window=64, ring_at=150)[1])
    errs.append(da_case("no valid key", 1, 64, 4, 2, 64, bf16, q_at=5, filled=0)[1])
    da_case("fp32 MHA G=1 D=64", 3, 96, 4, 4, 64, torch.float32, q_at=50, filled=51)
    da_case("fp32 G=16 D=80", 2, 130, 16, 1, 80, torch.float32, q_at=129, filled=130)
    # recurrentgemma-2b: G=10, D=256 over its 2048-token ring, wrapped; B=8
    # over the serving engine's 1024-token ring
    hybrid_da, e_h = da_case("recurrentgemma ring L=2048 window=2048 softcap=30 at 2304", 1,
                             2048, 10, 1, 256, bf16, q_at=2304, filled=0, window=2048,
                             ring_at=2304, softcap=30.0)
    errs.append(e_h)
    errs.append(da_case("recurrentgemma B=8 L=1024 softcap=30", 8, 1024, 10, 1, 256, bf16,
                        q_at=700, filled=701, window=2048, softcap=30.0)[1])
    # split-KV edges: a wrapped ring whose window of 300 leaves every chunk
    # between slots 100 and 1849 invisible; L = 1000 in 4 chunks of 256
    # (the last ragged); one row empty over 32 chunks; the serving ring
    ring_at = 2 * 2048 + 100
    errs.append(da_case(f"ring L=2048 window=300 at {ring_at}: middle chunks empty", 1, 2048,
                        10, 1, 256, bf16, q_at=ring_at, filled=0, window=300,
                        ring_at=ring_at)[1])
    errs.append(da_case("B=8 L=1000 Hq=32 Hkv=8", 8, 1000, 32, 8, 128, bf16, q_at=999,
                        filled=1000)[1])
    (q0, kc0, vc0, kw0), e0 = da_case("no valid key over L=2048", 1, 2048, 10, 1, 256, bf16,
                                      q_at=5, filled=0)
    check(da_ops.decode_attention(q0, kc0, vc0, **kw0).abs().max().item() == 0.0,
          "a row with no valid key in any chunk must be 0")
    errs.append(e0)
    serving_da, e_s = da_case("recurrentgemma serving B=8 ring L=1024 at 1500", 8, 1024, 10, 1,
                              256, bf16, q_at=1500, filled=0, window=2048, ring_at=1500,
                              softcap=30.0)
    errs.append(e_s)
    da_call = lambda args: da_ops.decode_attention(*args[:3], **args[3])  # noqa: E731
    log_time("decode_attention", "q (1,1,10,256) ring (1,2048,1,256) softcap=30", da_call,
             hybrid_da)
    log_time("decode_attention", "q (8,1,10,256) ring (8,1024,1,256) softcap=30", da_call,
             serving_da)
    decode_graph_check(dev, randn)

    B, _, Hq, D = q.shape
    Hkv = kc.shape[2]
    qp, kp = kw["q_positions"], kw["k_positions"]
    valid = ((kp >= 0) & (kp <= qp)).sum().item()
    nbytes = 2 * (2 * valid * Hkv * D + 2 * q.numel()) + 4 * (qp.numel() + kp.numel())
    flops = 4 * D * valid * Hq
    n = copies(2 * 2 * kc.numel())
    sets = [(q.clone(), kc.clone(), vc.clone()) for _ in range(n)]
    tq = [(a.transpose(1, 2).contiguous(), b.transpose(1, 2).contiguous(),
           c.transpose(1, 2).contiguous()) for a, b, c in sets]
    mask = ((kp >= 0) & (kp <= qp))[:, None, None, :]
    entries.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:93",
        shape=f"q ({B},1,{Hq},{D}) cache ({B},{L},{Hkv},{D}) bf16",
        max_abs_err=max(errs),
        ms=cuda_ms(lambda i: da_ops.decode_attention(*sets[i], **kw), n),
        plain_ms=cuda_ms(lambda i: da_ref.decode_attention(*sets[i], **kw), n),
        library_ms=cuda_ms(lambda i: F.scaled_dot_product_attention(
            *tq[i], attn_mask=mask, enable_gqa=True), n),
        **bound(nbytes, flops, BF16_FLOPS)))

    # -- K4 paged decode attention ---------------------------------------------
    def pda_case(name, B, Hq, Hkv, D, dtype, q_pos, bs=16, nb=64, N=513, window=0,
                 softcap=0.0, garbage_rows=()):
        """Rows at ragged ``q_pos`` over a shuffled pool of N blocks; each
        row's table names the blocks its keys need, unused entries (and
        every entry of a garbage row, or of a row at -1 with no valid key)
        point at block 0.  Also held to the split merge algebra at the
        chunk the kernel splits the positions into."""
        q = randn(B, 1, Hq, D, dtype=dtype)
        kp, vp = randn(N, bs, Hkv, D, dtype=dtype), randn(N, bs, Hkv, D, dtype=dtype)
        perm = (torch.randperm(N - 1, generator=g, device=dev) + 1).tolist()
        tables = torch.zeros(B, nb, dtype=torch.int32)
        for b, p in enumerate(q_pos):
            need = 0 if b in garbage_rows else max(p, -1) // bs + 1
            tables[b, :need] = torch.tensor([perm.pop() for _ in range(need)])
        tables = tables.to(dev)
        qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)[:, None]
        kw = dict(block_tables=tables, q_positions=qp, window=window, softcap=softcap)
        out = da_ops.paged_decode_attention(q, kp, vp, **kw)
        ref = da_ref.paged_decode_attention(q, kp, vp, **kw)
        chunk = da_ops.split_plan(B, Hkv, nb * bs, sms)[1]
        split = da_ref.paged_decode_attention_split(q, kp, vp, chunk=chunk, **kw)
        torch.cuda.synchronize()
        check(out.shape == q.shape and torch.isfinite(out).all().item(), f"{name}: bad output")
        err = max_err(out, ref)
        close(out, ref, tol[dtype])
        close(out, split, tol[dtype])
        log(f"check paged_decode_attention {name}: max_abs_err={err:.3e} tol={tol[dtype]}; "
            f"against the split merge at chunk {chunk}: {max_err(out, split):.3e}")
        return (q, kp, vp, kw), err

    # fixed row lengths (5266 valid keys), so K4's time compares from run to run
    q_pos = [447, 768, 758, 604, 388, 823, 517, 953]
    (q, kp, vp, kw), err = pda_case(f"main B=8 Hq=32 Hkv=8 D=128 bs=16 q_pos={q_pos}",
                                    8, 32, 8, 128, bf16, q_pos)
    errs = [err]
    errs.append(pda_case("window=100 softcap=30", 4, 32, 8, 128, bf16, [0, 99, 500, 1000],
                         window=100, softcap=30.0)[1])
    errs.append(pda_case("G=1 D=64 garbage rows q_pos 0", 4, 8, 8, 64, bf16, [0, 300, 0, 31],
                         garbage_rows=(0, 2))[1])
    errs.append(pda_case("G=12 (command-r-plus) bs=32", 3, 96, 8, 128, bf16, [700, 63, 2],
                         bs=32, nb=32, N=97)[1])
    pda_case("fp32 window=64 G=4", 3, 16, 4, 128, torch.float32, [10, 640, 1000], window=64)
    # split-KV edges at the serving shape's 4 chunks of 256: rows on either
    # side of each boundary, the last position, a row with no valid key; a
    # window of 300 that empties the first three chunks of a long row; 48
    # positions a pool block (not a divisor of the 64-key tile)
    edges = [255, 256, 257, 511, 512, 767, 1023, -1]
    (q0, kp0, vp0, kw0), e0 = pda_case(f"split edges q_pos={edges}", 8, 32, 8, 128, bf16,
                                       edges)
    check(da_ops.paged_decode_attention(q0, kp0, vp0, **kw0)[-1].abs().max().item() == 0.0,
          "a row with no valid key must be 0")
    errs.append(e0)
    errs.append(pda_case("window=300 empties leading chunks", 4, 32, 8, 128, bf16,
                         [1000, 900, 300, 40], window=300)[1])
    errs.append(pda_case("bs=48 G=10 D=256 softcap=30", 4, 20, 2, 256, bf16,
                         [1000, 47, 48, 600], bs=48, nb=22, N=89, softcap=30.0)[1])
    paged_graph_check(dev, randn)

    B, _, Hq, D = q.shape
    N, bs, Hkv = kp.shape[:3]
    tables, qp = kw["block_tables"], kw["q_positions"]
    valid = int(sum(p + 1 for p in q_pos))  # keys the rows attend to
    nbytes = (2 * (2 * valid * Hkv * D + 2 * q.numel())
              + 4 * (sum(p // bs + 1 for p in q_pos) + qp.numel()))
    n = copies(2 * 2 * valid * Hkv * D)
    sets = [(q.clone(), kp.clone(), vp.clone()) for _ in range(n)]
    pda_call = lambda i: da_ops.paged_decode_attention(*sets[i], **kw)  # noqa: E731
    for per_sm in (1, 2, 4, 8):  # the chunk plan's aim, beside the one it takes
        with patched(da_ops, "BLOCKS_PER_SM", per_sm):
            plan = da_ops.split_plan(B, Hkv, tables.shape[1] * bs, sms)
            log(f"time paged_decode_attention at {per_sm} blocks per SM, (n_split, chunk) = "
                f"{plan}: kernel_ms={cuda_ms(pda_call, n):.4f}")
    entries.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:202",
        shape=f"q ({B},1,{Hq},{D}) pool ({N},{bs},{Hkv},{D}) bf16, {valid} valid keys",
        max_abs_err=max(errs),
        ms=cuda_ms(pda_call, n),
        plain_ms=cuda_ms(lambda i: da_ref.paged_decode_attention(*sets[i], **kw), n,
                         iters=20),
        library_ms=None,  # no one PyTorch call gathers through a block table and attends
        **bound(nbytes, 4 * D * valid * Hq, BF16_FLOPS)))

    # -- K1 rmsnorm, plain and with the residual add fused in front ------------
    def rn_case(rows, d, dtype, fused):
        """Held to the plain version; the fused sum bit for bit ``x + r``."""
        x, s = randn(rows, d, dtype=dtype), (randn(d) * 0.1).to(dtype)
        r = randn(rows, d, dtype=dtype) * 3.0 if fused else None
        if fused:
            (got_s, out), ref = rn_ops.add_rmsnorm(x, r, s, 1e-6), \
                rn_ref.add_rmsnorm(x, r, s, 1e-6)[1]
        else:
            out, ref = rn_ops.rmsnorm(x, s, 1e-6), rn_ref.rmsnorm(x, s, 1e-6)
        torch.cuda.synchronize()
        if fused:
            check(torch.equal(got_s, x + r), f"add_rmsnorm {rows}x{d}: sum differs from x + r")
        err = max_err(out, ref)
        close(out, ref, tol[dtype])
        log(f"check {'add_rmsnorm' if fused else 'rmsnorm'} {rows}x{d} {dtype}: "
            f"max_abs_err={err:.3e} tol={tol[dtype]}" + ("; sum == x + r" if fused else ""))
        return (x, r, s), err

    errs = [rn_case(rows, d, dtype, fused)[1] for fused in (False, True)
            for rows, d, dtype in ((7, 12288, torch.float32), (5, 100, bf16),
                                   (5, 100, torch.float32))]
    # the floor of a launch in this timing: a kernel that does nothing
    empty_ms = cuda_ms(lambda i: torch.cuda._sleep(1), 1)
    log(f"time empty kernel (torch.cuda._sleep(1)): kernel_ms={empty_ms:.4f}")
    modes = []
    for rows in (1, 8, PROMPT):
        for fused in (False, True):
            (x, r, s), err = rn_case(rows, 4096, bf16, fused)
            errs.append(err)
            d, numel = 4096, rows * 4096
            # decode rows arrive hot from the kernel that wrote them; prompt
            # rows are rotated past the L2 cache, as for the other kernels
            n = copies(2 * 2 * numel) if rows == PROMPT else 1
            sets = [(x.clone(), None if r is None else r.clone()) for _ in range(n)]
            w = (1.0 + s.float()).to(bf16)
            if fused:
                kern = lambda i: rn_ops.add_rmsnorm(*sets[i], s, 1e-6)  # noqa: E731
                plain = lambda i: rn_ref.add_rmsnorm(*sets[i], s, 1e-6)  # noqa: E731
                lib = lambda i: F.rms_norm(sets[i][0] + sets[i][1], (d,), weight=w,  # noqa: E731
                                           eps=1e-6)
                sep = lambda i: rn_ops.rmsnorm(sets[i][0] + sets[i][1], s, 1e-6)  # noqa: E731
                nbytes, flops = 2 * (4 * numel + d), 5 * numel
            else:
                kern = lambda i: rn_ops.rmsnorm(sets[i][0], s, 1e-6)  # noqa: E731
                plain = lambda i: rn_ref.rmsnorm(sets[i][0], s, 1e-6)  # noqa: E731
                lib = lambda i: F.rms_norm(sets[i][0], (d,), weight=w, eps=1e-6)  # noqa: E731
                sep = None
                nbytes, flops = 2 * (2 * numel + d), 4 * numel
            mode = dict(mode="add_rmsnorm" if fused else "rmsnorm", shape=f"({rows},{d}) bf16",
                        max_abs_err=err, ms=cuda_ms(kern, n), plain_ms=cuda_ms(plain, n),
                        library_ms=cuda_ms(lib, n),
                        separate_add_then_kernel_ms=None if sep is None else cuda_ms(sep, n),
                        host_us=host_us(lambda: kern(0)),
                        **bound(nbytes, flops, FP32_FLOPS))
            log("time " + json.dumps(mode))
            modes.append(mode)
    table = next(m for m in modes
                 if m["mode"] == "rmsnorm" and m["shape"].startswith(f"({PROMPT},"))
    entries.append(dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/rmsnorm.py:26",
        shape=f"x {table['shape']}, plain mode (every mode and shape under 'modes')",
        max_abs_err=max(errs),
        **{k: table[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        empty_kernel_ms=empty_ms, modes=modes))

    # -- K5 linear recurrence -----------------------------------------------------
    def lr_case(name, Bn, S, W, pad=False, a_max=None):
        """a in (0.8, 1), b ~ 0.1 N, nonzero h0 (the reference's sweep);
        ``pad`` makes the last third of every row identity steps (a=1,
        b=0), as padded positions arrive; ``a_max`` draws a from (0,
        a_max) instead, where chunk products underflow.  rtol 1e-4 / atol
        1e-5, as the reference holds Pallas to its ref; also held to the
        split algebra at the chunk the kernel splits S into."""
        f32 = torch.float32
        a = torch.sigmoid(randn(Bn, S, W, dtype=f32)) * 0.2 + 0.8
        if a_max is not None:
            a = torch.rand(Bn, S, W, generator=g, device=dev) * a_max
        b, h0 = randn(Bn, S, W, dtype=f32) * 0.1, randn(Bn, W, dtype=f32)
        if pad:
            a[:, S - S // 3:] = 1.0
            b[:, S - S // 3:] = 0.0
        out, ref = lr_ops.linear_recurrence(a, b, h0), lr_ref.linear_recurrence(a, b, h0)
        chunk = lr_ops.scan_plan(Bn, S, W, sms)[1]
        split = lr_ref.linear_recurrence_chunked(a, b, h0, chunk)
        torch.cuda.synchronize()
        check(out.shape == a.shape and torch.isfinite(out).all().item(), f"{name}: bad output")
        err = max_err(out, ref)
        try:
            torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(out, split, rtol=1e-4, atol=1e-5)
        except AssertionError as exc:
            raise CheckFailed(f"linear_recurrence {name}: {exc}") from None
        log(f"check linear_recurrence {name}: max_abs_err={err:.3e} rtol=1e-4 atol=1e-5; "
            f"against the split algebra at chunk {chunk}: {max_err(out, split):.3e}")
        return (a, b, h0), err

    W = 2560  # recurrentgemma's lru_width
    (a, b, h0), err = lr_case(f"main B=1 S={PROMPT} W={W}", 1, PROMPT, W)
    errs = [err]
    long_lr, e_l = lr_case(f"prompt past the window B=1 S={HYBRID_PARITY_PROMPT} W={W}", 1,
                           HYBRID_PARITY_PROMPT, W)
    errs.append(e_l)
    (a1, b1, h01), e1 = lr_case(f"serving decode B=8 S=1 W={W}", 8, 1, W)
    errs.append(e1)
    errs.append(lr_case("ragged B=2 S=37 W=100", 2, 37, 100)[1])
    errs.append(lr_case("identity pad steps B=2 S=37 W=100", 2, 37, 100, pad=True)[1])
    errs.append(lr_case(f"identity pad steps B=4 S=300 W={W}", 4, 300, W, pad=True)[1])
    errs.append(lr_case(f"admission B=8 S={PROMPT} W={W}", 8, PROMPT, W)[1])
    errs.append(lr_case(f"a in (0, 1e-3), decay products underflow B=1 S={PROMPT} W={W}", 1,
                        PROMPT, W, a_max=1e-3)[1])
    errs.append(lr_case("ragged split B=3 S=300 W=129", 3, 300, 129)[1])
    t1 = cuda_ms(lambda i: lr_ops.linear_recurrence(a1, b1, h01), 1)
    log(f"time linear_recurrence 8x1x{W}: kernel_ms={t1:.4f} (the serving decode shape)")
    lr_call = lambda args: lr_ops.linear_recurrence(*args[:3])  # noqa: E731
    Bn, S, W = a.shape
    for case, shape in (((a, b, h0, {}), (Bn, S, W)), (long_lr + ({},), long_lr[0].shape)):
        log_time("linear_recurrence", f"{tuple(shape)} in {lr_ops.scan_plan(*shape, sms)} "
                 f"(n_chunks, chunk)", lr_call, case)
        with patched(lr_ops, "MIN_CHUNK", 1 << 30):  # one chunk: the single pass
            log_time("linear_recurrence", f"{tuple(shape)} in one chunk", lr_call, case)
    n = copies(3 * 4 * a.numel())
    sets = [(a.clone(), b.clone(), h0.clone()) for _ in range(n)]
    entries.append(dict(
        name="linear_recurrence", route="cuda",
        source="src/repro_torch/kernels/csrc/linear_recurrence.cu",
        replaces="src/repro/kernels/linear_recurrence/linear_recurrence.py:55",
        shape=f"a/b ({Bn},{S},{W}) h0 ({Bn},{W}) fp32",
        max_abs_err=max(errs),
        ms=cuda_ms(lambda i: lr_ops.linear_recurrence(*sets[i]), n),
        plain_ms=cuda_ms(lambda i: lr_ref.linear_recurrence(*sets[i]), n),
        # no one PyTorch call computes a first-order linear recurrence (the
        # cumprod/cumsum closed form divides by the decay product, which
        # underflows)
        library_ms=None,
        # one pass's bytes (a, b read once, h written once), though the
        # split kernel reads a and b twice
        **bound(4 * (3 * a.numel() + h0.numel()), 2 * a.numel(), FP32_FLOPS)))
    for e in entries:
        e["kernel_ms"] = e["ms"]
    return entries


def decode_graph_check(dev, randn):
    """One K3 call captured in a CUDA graph at recurrentgemma's ring shape,
    replayed as q_pos advances across chunk boundaries (slots filled up to
    it): bit-identical to the eager call, and within bf16 tolerance of the
    plain version, at every position."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref

    B, L = 1, 2048
    q = randn(B, 1, 10, 256)
    kc, vc = randn(B, L, 1, 256), randn(B, L, 1, 256)
    qp = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    kp = torch.full((B, L), -1, dtype=torch.int32, device=dev)
    slots = torch.arange(L, dtype=torch.int32, device=dev)[None]
    kw = dict(q_positions=qp, k_positions=kp, window=2048, softcap=30.0)
    da_ops.decode_attention(q, kc, vc, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da_ops.decode_attention(q, kc, vc, **kw)
    positions = (62, 63, 64, 65, 127, 128, 1000, 2047)
    for pos in positions:
        qp.fill_(pos)
        kp.copy_(torch.where(slots <= pos, slots, -1))
        graph.replay()
        eager = da_ops.decode_attention(q, kc, vc, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, eager), f"graph replay at q_pos {pos} differs from eager")
        close(out, da_ref.decode_attention(q, kc, vc, **kw), 2e-2)
    log(f"check decode_attention in a CUDA graph: {len(positions)} replays at q_pos "
        f"{positions} equal eager")


def paged_graph_check(dev, randn):
    """One K4 call at llama3.1-8b's serving shape (8 rows of 64 blocks of
    16 positions, G = 4, D = 128) captured in a CUDA graph, replayed as the
    rows' q_pos advance across the chunk boundaries of its plan: identical
    to the eager call, and within bf16 tolerance of the plain version, at
    every position."""
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops, ref as da_ref

    B, nb, bs, Hkv = 8, 64, 16, 8
    q = randn(B, 1, 32, 128)
    kp, vp = randn(B * nb + 1, bs, Hkv, 128), randn(B * nb + 1, bs, Hkv, 128)
    tables = (torch.randperm(B * nb, device=dev) + 1).to(torch.int32).reshape(B, nb)
    qp = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    kw = dict(block_tables=tables, q_positions=qp)
    da_ops.paged_decode_attention(q, kp, vp, **kw)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da_ops.paged_decode_attention(q, kp, vp, **kw)
    rows = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
    positions = (0, 62, 63, 250, 255, 256, 505, 760, 1015)
    for pos in positions:
        qp.copy_(pos + rows)  # rows one position apart, straddling the boundaries
        graph.replay()
        eager = da_ops.paged_decode_attention(q, kp, vp, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, eager), f"paged graph replay at q_pos {pos}.. differs from eager")
        close(out, da_ref.paged_decode_attention(q, kp, vp, **kw), 2e-2)
    log(f"check paged_decode_attention in a CUDA graph: {len(positions)} replays at rows "
        f"from q_pos {positions} equal eager")


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` inside the block (to time a kernel at
    another plan than the one its wrapper picks)."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def bound(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def reset_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    return {name: fn.launches for name, fn in counters.items()}


def per_forward(cfg):
    """Layers of one forward pass by the kernel they launch: attention
    layers (K2 in a prefill; in a decode step K3, or K4 for full-context
    layers over a paged pool), full-context ones among them, RG-LRU layers
    (K5), and RMSNorm launches (K1: two per block, one per ``ffn`` or
    parallel attention block, one final)."""
    kinds = cfg.blocks()
    attn = ("attn", "local_attn")
    norms = sum(1 if (k == "ffn" or (k in attn and cfg.parallel_block)) else 2
                for k in kinds) + 1
    return dict(attn=sum(k in attn for k in kinds), full=sum(k == "attn" for k in kinds),
                rec=sum(k == "rglru" for k in kinds), norms=norms)


def expected_launches(cfg, prefills, decodes, paged=False):
    """Launches of each kernel over ``prefills`` prefills and ``decodes``
    decode steps."""
    n = per_forward(cfg)
    full_paged = n["full"] if paged else 0
    return {"flash_attention": n["attn"] * prefills,
            "decode_attention": (n["attn"] - full_paged) * decodes,
            "paged_decode_attention": full_paged * decodes,
            "rmsnorm": n["norms"] * (prefills + decodes),
            "linear_recurrence": n["rec"] * (prefills + decodes)}


class Calls:
    """Counts the model's forward passes, to hold the launch counts to."""

    def __init__(self, model):
        self.prefill = self.decode = 0
        prefill, decode = model.prefill, model.decode_step

        def counted_prefill(*a, **kw):
            self.prefill += 1
            return prefill(*a, **kw)

        def counted_decode(*a, **kw):
            self.decode += 1
            return decode(*a, **kw)

        model.prefill, model.decode_step = counted_prefill, counted_decode

    def forwards(self, lp):
        """(prefills, decode steps) the kernels ran so far: Python calls of
        ``decode_step``, less the one per capture (whose launches the
        capture takes back), plus the graph replays, which make no call."""
        runs = lp.runners.values()
        return self.prefill, (self.decode - sum(r.graph is not None for r in runs)
                              + sum(r.replays for r in runs))


def measured_launches(e, counters, calls, **measure_kw):
    """``e.measure(**measure_kw)`` with every count from 0; the launches
    checked against the forward passes it ran.  Returns (metrics,
    launches)."""
    lp = e._latency_profiler()
    (p0, d0), r0 = calls.forwards(lp), sum(r.replays for r in lp.runners.values())
    reset_counts(counters)
    m = e.measure(batch=BATCH, prompt_len=PROMPT, gen_len=GEN, iters=ITERS, **measure_kw)
    launches = read_counts(counters)
    (p1, d1), r1 = calls.forwards(lp), sum(r.replays for r in lp.runners.values())
    want = expected_launches(e.cfg, p1 - p0, d1 - d0)
    log(f"{e.cfg.name} forward passes: {p1 - p0} prefill, {d1 - d0} decode ({r1 - r0} of "
        f"them graph replays); per forward {per_forward(e.cfg)}; launches {launches}, "
        f"expected {want}")
    check(launches == want, f"launch counts {launches} != {want}")
    check(r1 - r0 > 0, "no decode step was replayed from the graph")
    return m, launches


def main_path_phase(arch, counters):
    import torch

    from repro_torch.core.energy import NvmlReader, PowerReader
    from repro_torch.core.profiler import Elana

    e = Elana(arch, device="cuda", seed=0)
    size = e.size_report()
    log(size.fmt())
    check(f"{size.param_bytes / 1e9:.2f}" == SIZE_GB[arch],
          f"{arch} must read {SIZE_GB[arch]} GB")
    log(e.cache_report(BATCH, PROMPT + GEN + 1).fmt())
    # bounds: the weights' matrix products over the prompt at the bf16 peak
    # (embedding tables only gathered, or used at one position), and one
    # read of every weight per decode step
    itemsize = getattr(torch, e.cfg.param_dtype).itemsize
    tables = sum(size.by_component.get(k, 0) for k in ("embed", "lm_head")) // itemsize
    bounds = {"ttft_bound_ms": 2 * (size.param_count - tables) * BATCH * PROMPT
              / BF16_FLOPS * 1e3,
              "tpot_bound_ms": size.param_bytes / HBM_BYTES_PER_S * 1e3}
    t0 = time.perf_counter()
    model = e.model
    torch.cuda.synchronize()
    log(f"weights drawn on the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    calls = Calls(model)

    m, launches = measured_launches(e, counters, calls)
    path = {"flash_attention", "decode_attention", "rmsnorm"}
    if per_forward(e.cfg)["rec"]:
        path.add("linear_recurrence")
    check(all(launches[k] > 0 for k in path), "a kernel of the path never launched")
    check(all(math.isfinite(v) and v > 0 for v in m.values()), f"bad metrics {m}")
    log("measure: " + json.dumps({"arch": arch, "batch": BATCH, "prompt_len": PROMPT,
                                  "gen_len": GEN, "iters": ITERS, **m, **bounds}))

    class CountingReader(PowerReader):
        def __init__(self, inner):
            self.inner, self.reads = inner, 0

        def read_watts(self):
            self.reads += 1
            return self.inner.read_watts()

    nvml = NvmlReader([0])
    reader = CountingReader(nvml)
    t0 = time.perf_counter()
    try:
        me, _ = measured_launches(e, counters, calls, power_reader=reader)
    finally:
        nvml.close()
    hz = reader.reads / (time.perf_counter() - t0)
    check(all(math.isfinite(v) and v > 0 for v in me.values()), f"bad energy metrics {me}")
    log("energy: " + json.dumps({"arch": arch, **me, "sampler_hz": hz}))
    return e, launches, {**me, **m, **bounds}


def kernel_family(name):
    """A traced kernel's family: the port's own kernels by name, cuBLAS's
    matrix products, and PyTorch's other kernels (elementwise, copies,
    gathers, reductions)."""
    import re

    own = re.search(r"repro_torch::(?:\(anonymous namespace\)::)?(\w+)", name)
    if own:
        return own.group(1)
    if any(k in name for k in ("nvjet", "gemm", "gemv", "cutlass", "cublas")):
        return "cublas matmul"
    return "torch other"


def measure_graph_phase(e, dev, measured):
    """The measured decode step replayed from its CUDA graph against the
    same step run eagerly, on one prompt: identical greedy tokens for GEN
    steps; TPOT both ways, the device time of each replay (CUDA events)
    and the busy share; one replay traced with ``capture_torch_trace``
    (its JSON parsed, its kernel events counted); and the ``h100``
    estimate beside the measured TTFT/TPOT/TTLT and joules."""
    import statistics

    import torch

    from repro_torch.core.latency import LatencyProfiler
    from repro_torch.core.trace import capture_torch_trace

    lp = e._latency_profiler()
    eager = LatencyProfiler(e.cfg, e.model, seed=0, device=dev, cuda_graph=False)
    g = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, e.cfg.vocab_size, (BATCH, PROMPT), generator=g, device=dev)
    toks = {graph: p.greedy(tokens, GEN).cpu() for graph, p in ((True, lp), (False, eager))}
    same = int((toks[True] == toks[False]).all(dim=0).sum())
    check(torch.equal(toks[True], toks[False]),
          f"graph and eager greedy tokens differ: {toks[True].tolist()} {toks[False].tolist()}")

    run = lp.runner(BATCH, PROMPT + GEN + 1)
    check(run.graph is not None, "the measured decode step was not captured")
    timed = TimedGraph(run.graph)
    run.graph = timed
    try:
        graph_st = lp.tpot(BATCH, PROMPT, gen_len=GEN)
    finally:
        run.graph = timed.graph
    eager_st = eager.tpot(BATCH, PROMPT, gen_len=GEN)
    replay_ms = statistics.median(timed.device_ms()[-GEN:])
    out = {"arch": e.cfg.name, "identical_tokens": f"{same}/{GEN + 1}",
           "distinct_tokens": len(set(toks[True][0].tolist())),
           "tpot_graph_ms": graph_st.mean_ms, "tpot_graph_p50_ms": graph_st.p50_s * 1e3,
           "tpot_eager_ms": eager_st.mean_ms, "tpot_eager_p50_ms": eager_st.p50_s * 1e3,
           "replay_device_ms_p50": replay_ms,
           "replay_busy_share": replay_ms / (graph_st.p50_s * 1e3),
           "capture_and_warmup_ms": graph_st.compile_s * 1e3,
           "tpot_bound_ms": measured["tpot_bound_ms"]}
    log("measure graph vs eager: " + json.dumps(out))
    del eager
    torch.cuda.empty_cache()

    path = ROOT / "build" / f"trace_{e.cfg.name}_decode_replay.json"
    path.parent.mkdir(exist_ok=True)
    capture_torch_trace(str(path), run.step)
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    check(kernels, f"the trace of a replay holds no kernel event ({len(events)} events)")
    by_name, by_family = {}, {}
    for ev in kernels:
        name, us = ev["name"], ev.get("dur", 0.0)
        by_name[name[:70]] = by_name.get(name[:70], 0.0) + us
        fam = kernel_family(name)
        n, t = by_family.get(fam, (0, 0.0))
        by_family[fam] = (n + 1, t + us)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log("trace of one replay: " + json.dumps({
        "path": str(path.relative_to(ROOT)), "events": len(events),
        "kernel_events": len(kernels), "kernel_us": sum(by_name.values()),
        "span_us": (max(ev["ts"] + ev.get("dur", 0.0) for ev in kernels)
                    - min(ev["ts"] for ev in kernels)),
        "graph_launches": sum("GraphLaunch" in ev.get("name", "") for ev in events),
        "by_family_count_us": dict(sorted(by_family.items(), key=lambda kv: -kv[1][1])),
        "top_us": {k: v for k, v in top}}))

    est = e.estimate(hardware="h100", batch=BATCH, prompt_len=PROMPT, gen_len=GEN)
    row = {}
    for key, est_v in (("ttft_ms", est.ttft.latency_s * 1e3),
                       ("tpot_ms", est.tpot.latency_s * 1e3),
                       ("ttlt_ms", est.ttlt.latency_s * 1e3),
                       ("j_per_prompt", est.ttft.joules), ("j_per_token", est.tpot.joules),
                       ("j_per_request", est.ttlt.joules)):
        row[key] = {"measured": measured[key], "estimated": est_v,
                    "measured_over_estimated": measured[key] / est_v}
    log("estimate h100 vs measured: " + json.dumps({"arch": e.cfg.name, "batch": BATCH,
                                                   "prompt_len": PROMPT, "gen_len": GEN,
                                                   **row}))


def profile_phase(e, dev, decode_steps=8):
    """Where the time goes: device time by kernel, the number of device
    kernels (memory copies and sets aside) and the device's busy share of
    the wall clock, for one prefill and for ``decode_steps`` decode steps,
    each with its greedy pick (torch.profiler over the CUDA activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = e.model
    g = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(0, e.cfg.vocab_size, (BATCH, PROMPT), generator=g, device=dev)
    cache = model.init_cache(BATCH, PROMPT + decode_steps + 1)
    pos = torch.full((BATCH,), PROMPT, dtype=torch.int32, device=dev)
    out = {}

    def prefill():
        return model.prefill({"tokens": tokens}, cache)[0]

    def decode():
        tok = logits.argmax(-1, keepdim=True)
        for _ in range(decode_steps):
            tok = model.decode_step(tok, pos, cache)[0].argmax(-1, keepdim=True)
            pos.add_(1)

    for name, fn in (("prefill", prefill), ("decode", decode)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if name == "prefill":
            logits = res
        by_kernel, kernels = {}, 0
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue  # host ops: their kernels are listed on their own
            us = evt.device_time_total
            by_kernel[evt.key[:70]] = by_kernel.get(evt.key[:70], 0.0) + us
            if not evt.key.startswith(("Memcpy", "Memset")):
                kernels += evt.count
        busy = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        steps = decode_steps if name == "decode" else 1
        out[name] = {"wall_ms": wall_us / 1e3, "device_ms": busy / 1e3,
                     "busy_share": busy / wall_us, "device_kernels": kernels,
                     "device_kernels_per_step": kernels / steps,
                     "top_ms": {k: v / 1e3 for k, v in top}}
        log(f"profile {name}: " + json.dumps(out[name]))
    return out


# ---------------------------------------------------------------------------
# phase 5: the serving path at full width
# ---------------------------------------------------------------------------

class TimedGraph:
    """Stands in for the engine's CUDA graph: records device time around
    each replay (CUDA events) and the host clock at each call."""

    def __init__(self, graph):
        import torch

        self.graph, self.events, self.calls = graph, [], []
        self._event = lambda: torch.cuda.Event(enable_timing=True)

    def replay(self):
        start, end = self._event(), self._event()
        self.calls.append(time.perf_counter())
        start.record()
        self.graph.replay()
        end.record()
        self.events.append((start, end))

    def device_ms(self):
        return [s.elapsed_time(e) for s, e in self.events]


def serve_arrivals(cfg, n_requests, greedy_only=False):
    """``n_requests``, all at t = 0: lognormal prompts (mean 256, 32..768),
    16..63 new tokens; even uids greedy, odd ones at temperature 0.7,
    top-k 50 (or every one greedy)."""
    import dataclasses

    from repro_torch.serving.workload import LengthDist, WorkloadSpec, poisson_trace

    spec = WorkloadSpec(arrival_rate=0.0, num_requests=n_requests,
                        prompt_len=LengthDist(kind="lognormal", mean=256.0, low=32, high=768),
                        output_len=LengthDist(kind="uniform", low=16, high=64),
                        temperature=0.7, top_k=50, seed=0)
    arrivals = poisson_trace(spec, cfg.vocab_size)
    for i, a in enumerate(arrivals):
        if greedy_only or i % 2 == 0:
            a.params = dataclasses.replace(a.params, temperature=0.0)
    return arrivals


def serve(e, arrivals, **kw):
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(e.model, **SERVE, device="cuda", **kw)
    for a in arrivals:
        eng.submit(a.prompt, a.params)
    return eng


def serve_phase(e, counters):
    """The engine at full width with NVML energy; returns the launches."""
    import torch

    from repro_torch.core.energy import NvmlReader, PowerMonitor

    n_requests = SERVE_REQUESTS[e.cfg.name]
    arrivals = serve_arrivals(e.cfg, n_requests)
    monitor = PowerMonitor(NvmlReader([0]))
    eng = serve(e, arrivals, monitor=monitor)
    check(eng._graph is not None, "the decode step was not captured")
    eng._graph = timed = TimedGraph(eng._graph)
    reset_counts(counters)
    try:
        with monitor:
            finished = eng.run()
    finally:
        monitor.reader.close()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    summary = eng.latency_summary()

    # replays are credited per replay as the engine's capture counted them
    want = expected_launches(e.cfg, eng.prefills, eng.decode_forwards, paged=True)
    log(f"serve {e.cfg.name}: {eng.prefills} admission prefills, {eng.decode_forwards} "
        f"graph replays; launches {launches}, expected {want}")
    check(launches == want, f"serve launch counts {launches} != {want}")
    check(len(finished) == n_requests, f"{len(finished)} of {n_requests} finished")
    budgets = {i: a.params.max_new_tokens for i, a in enumerate(arrivals)}
    check(all(len(r.output_tokens) == budgets[r.uid] for r in finished),
          "a request did not emit its budget of tokens")
    check(eng.blocks_in_use == 0, f"{eng.blocks_in_use} blocks still in use at drain")
    check(not eng._state["block_tables"].any().item(), "a table row not back at block 0")
    check(summary["dispatches_per_step_p50"] == 1, f"dispatches/step {summary}")
    check(all(math.isfinite(v) for v in summary.values()), f"bad summary {summary}")
    check(summary["joules_per_token"] > 0, "no energy attributed")

    device = timed.device_ms()
    gaps = [b - a for a, b in zip(timed.calls, timed.calls[1:])]
    step_ms = 1e3 * sorted(gaps)[len(gaps) // 2]
    replay_ms = sorted(device)[len(device) // 2]
    keys = ("requests", "output_tokens", "tokens_per_sec", "ttft_ms", "ttft_p50_ms",
            "ttft_p95_ms", "ttft_p99_ms", "tpot_ms", "tpot_p50_ms", "tpot_p95_ms",
            "tpot_p99_ms", "ttlt_ms", "ttlt_p50_ms", "ttlt_p95_ms", "ttlt_p99_ms",
            "kv_bytes_peak", "kv_bytes_worst_case", "steps_per_sec",
            "dispatches_per_step_p50", "dispatches_per_step_p95", "pool_occupancy_p95",
            "joules_total", "joules_per_request", "joules_per_token",
            "power_samples_per_sec")
    log("serve: " + json.dumps({"arch": e.cfg.name, "requests_submitted": n_requests,
                                **SERVE, **{k: summary[k] for k in keys},
                                "decode_replay_device_ms_p50": replay_ms,
                                "decode_step_wall_ms_p50": step_ms,
                                "decode_busy_share": replay_ms / step_ms}))
    del eng
    torch.cuda.empty_cache()
    return launches


def graph_phase(e):
    """The same trace, every request greedy, with the decode step replayed
    from its CUDA graph and run eagerly: the streams must be identical
    (the same kernels at the same shapes)."""
    import torch

    arrivals = serve_arrivals(e.cfg, GRAPH_REQUESTS[e.cfg.name], greedy_only=True)
    streams, tpot = {}, {}
    for graph in (True, False):
        eng = serve(e, arrivals, cuda_graph=graph)
        streams[graph] = {r.uid: r.output_tokens for r in eng.run()}
        summary = eng.latency_summary()
        tpot[graph] = {k: summary[k] for k in ("tpot_ms", "tpot_p50_ms", "tpot_p95_ms",
                                                "ttft_ms", "steps_per_sec")}
        del eng
        torch.cuda.empty_cache()
    same = sum(streams[True][u] == streams[False][u] for u in streams[True])
    log("graph vs eager: " + json.dumps({"arch": e.cfg.name, "graph": tpot[True],
                                         "eager": tpot[False],
                                         "identical_streams": f"{same}/{len(streams[True])}"}))
    check(streams[True] == streams[False], "graph and eager streams differ")


# ---------------------------------------------------------------------------
# phase 6: kernels against plain versions on the full-width model
# ---------------------------------------------------------------------------

def parity_phase(e, dev, prompt=PROMPT, paged=True):
    """Prefill + 4 greedy decode steps through the kernels and through the
    plain versions, both in bf16, each held against the plain versions run
    on an fp32 copy of the same weights; over a contiguous cache (B=1) and,
    with ``paged``, over a paged one (B=4, each row's blocks shuffled
    through the pool).
    The kernels pass if they add no more error than bf16 itself: the plain
    bf16 path's distance from fp32 is the floor (it rounds probabilities
    and activations to bf16, and 32 random layers amplify such
    differences), and the kernel path may be at most twice as far.  Top-1
    must match fp32 wherever fp32's top-2 margin exceeds that floor."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.models.cache import blocks_per_slot
    from repro_torch.models.model import Model

    model = e.model
    g = torch.Generator(device=dev).manual_seed(1)
    steps, bs, paged_batch = 4, 16, 4
    max_len = prompt + steps + 1
    nb = blocks_per_slot(max_len, bs)
    pool = paged_batch * nb + 9  # unnamed spare blocks besides the garbage block
    tables = (torch.randperm(pool - 1, generator=g, device=dev)[:paged_batch * nb] + 1)
    tables = tables.reshape(paged_batch, nb).to(torch.int32)
    layouts = {"contiguous": (BATCH, {})}
    if paged:
        layouts["paged"] = (paged_batch, dict(layout="paged", block_size=bs, num_blocks=pool))
    tokens = {name: torch.randint(0, e.cfg.vocab_size, (b, prompt), generator=g, device=dev)
              for name, (b, _) in layouts.items()}

    def run(m, name, dtype=None, forced=None):
        b, kw = layouts[name]
        bt = tables if kw else None
        cache = m.init_cache(b, max_len, dtype, **kw)
        logits, cache = m.prefill({"tokens": tokens[name]}, cache, block_tables=bt)
        out, toks = [logits], []
        for i in range(steps):
            tok = logits.argmax(-1, keepdim=True) if forced is None else forced[i]
            toks.append(tok)
            logits, cache = m.decode_step(tok, prompt + i, cache, block_tables=bt)
            out.append(logits)
        return torch.stack(out), toks

    results = {name: run(model, name) for name in layouts}
    with dispatch.use_backend("torch"):  # same inputs at every step
        plain = {name: run(model, name, forced=results[name][1])[0] for name in layouts}
        ref32 = Model(e.cfg.replace(dtype="float32", param_dtype="float32"), device=dev)
        with torch.no_grad():
            for p32, p in zip(ref32.parameters(), model.parameters()):
                p32.copy_(p)
        ref = {name: run(ref32, name, torch.float32, forced=results[name][1])[0]
               for name in layouts}
        del ref32
    torch.cuda.synchronize()
    for name, (b, _) in layouts.items():
        kern = results[name][0]
        check(kern.shape == (steps + 1, b, e.cfg.vocab_size), f"{name}: shape {kern.shape}")
        check(all(torch.isfinite(t).all().item() for t in (kern, plain[name], ref[name])),
              f"{name}: non-finite logits")
        err_kern = (kern - ref[name]).abs().max().item()
        err_plain = (plain[name] - ref[name]).abs().max().item()
        top2 = ref[name].topk(2, dim=-1).values
        decided = (top2[..., 0] - top2[..., 1]) > err_plain
        agree = kern.argmax(-1) == ref[name].argmax(-1)
        log(f"parity {e.cfg.name} {name} B={b} prompt={prompt}: " + json.dumps({
            "max_abs_logit_fp32": ref[name].abs().max().item(), "kernels_vs_fp32": err_kern,
            "plain_bf16_vs_fp32": err_plain,
            "kernels_vs_plain": (kern - plain[name]).abs().max().item(),
            "top1_agree": f"{int(agree.sum())}/{agree.numel()}",
            "decided_rows": int(decided.sum())}))
        check(err_kern <= 2 * err_plain,
              f"{name}: kernels {err_kern} from fp32, plain bf16 {err_plain}")
        check(bool(agree[decided].all()),
              f"{name}: top-1 differs from fp32 on a row with a clear margin")


def idle_power(samples=20, interval_s=0.1):
    """The board's power from NVML before any model is drawn (the ``h100``
    spec's ``idle_watts``)."""
    import statistics

    from repro_torch.core.energy import NvmlReader

    nvml = NvmlReader([0])
    try:
        watts = []
        for _ in range(samples):
            watts.append(nvml.read_watts()[0])
            time.sleep(interval_s)
    finally:
        nvml.close()
    log("idle power: " + json.dumps({"watts_median": statistics.median(watts),
                                     "watts_min": min(watts), "watts_max": max(watts),
                                     "samples": samples, "interval_s": interval_s}))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, dispatch

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions stay fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log(f"device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    idle_power()
    t0 = time.perf_counter()
    _build.load()
    log(f"built the CUDA kernels in {time.perf_counter() - t0:.1f} s")

    counters = dispatch.KERNELS
    entries = kernel_phase(dev)
    paths = {}  # each path's counts, read right after that path ran
    e, paths[f"{ARCH} measure"], measured = main_path_phase(ARCH, counters)
    measure_graph_phase(e, dev, measured)
    profile_phase(e, dev)
    paths[f"{ARCH} serve"] = serve_phase(e, counters)
    graph_phase(e)
    parity_phase(e, dev)
    del e  # free llama3.1-8b before the second model
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    h, paths[f"{HYBRID} measure"], measured = main_path_phase(HYBRID, counters)
    measure_graph_phase(h, dev, measured)
    profile_phase(h, dev)
    paths[f"{HYBRID} serve"] = serve_phase(h, counters)
    graph_phase(h)
    parity_phase(h, dev, prompt=HYBRID_PARITY_PROMPT, paged=False)
    log(f"{HYBRID} phases took {time.perf_counter() - t0:.1f} s")
    for entry in entries:
        k = entry["name"]
        entry["launches_by_path"] = {path: counts[k] for path, counts in paths.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        check(entry["launches"] > 0, f"{k} never launched on its path")

    log(json.dumps({"kernels": entries}))
    log(smi[0] if smi else "nvidia-smi: no output")
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
